"""LED lighting controllers.

Rebuilds rust/heimdall-lighting's controller layer (lib.rs:46-235,
controllers/*.rs): the LightingController interface (initialize / turn_on
/ turn_off / set_intensity / strobe / trigger_all), LightingType and sync
modes, per-channel state tracking (activation count + cumulative on-time),
and serial / ethernet / simulator backends (hardware ones are protocol
framers over pluggable transports; everything ships simulated, as in the
reference).

A copy of heimdall_tpu/lighting/controller.py: the port imports nothing of the JAX
package.
"""

import enum
import logging
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

logger = logging.getLogger("heimdall.lighting")


class LightingType(enum.Enum):
    """Reference lib.rs:46-65."""
    DIFFUSE = "diffuse"
    BACKLIGHT = "backlight"
    DIRECTIONAL = "directional"
    COAXIAL = "coaxial"
    STRUCTURED = "structured"
    STROBE = "strobe"


class LightingSyncMode(enum.Enum):
    """Reference lib.rs:68-81."""
    CONTINUOUS = "continuous"
    CAMERA_TRIGGER = "camera_trigger"
    EXTERNAL_TRIGGER = "external_trigger"
    SOFTWARE = "software"


@dataclass
class ChannelState:
    """Reference lib.rs:149-169."""
    channel: int
    is_on: bool = False
    intensity: float = 0.0           # 0..1
    activation_count: int = 0
    cumulative_on_time_s: float = 0.0
    _last_on: Optional[float] = None

    def turn_on(self) -> None:
        if not self.is_on:
            self.is_on = True
            self.activation_count += 1
            self._last_on = time.time()

    def turn_off(self) -> None:
        if self.is_on:
            self.is_on = False
            if self._last_on is not None:
                self.cumulative_on_time_s += time.time() - self._last_on
                self._last_on = None

    @property
    def usage_hours(self) -> float:
        extra = (time.time() - self._last_on) if self.is_on and \
            self._last_on else 0.0
        return (self.cumulative_on_time_s + extra) / 3600.0


class LightingController(ABC):
    """Controller interface (reference lib.rs:172-203)."""

    def __init__(self, controller_id: str, n_channels: int = 4,
                 config: Dict[str, Any] = None):
        self.controller_id = controller_id
        self.config = config or {}
        self.channels: Dict[int, ChannelState] = {
            i: ChannelState(i) for i in range(n_channels)}
        self.is_initialized = False
        self.logger = logging.getLogger(
            f"heimdall.lighting.{controller_id}")

    @abstractmethod
    def _send(self, command: str, channel: int, value: float = 0.0) -> None:
        """Transport-specific command write."""

    def initialize(self) -> None:
        self.is_initialized = True
        self.logger.info("Lighting controller %s initialized",
                         self.controller_id)

    def turn_on(self, channel: int) -> None:
        self._send("on", channel)
        self.channels[channel].turn_on()

    def turn_off(self, channel: int) -> None:
        self._send("off", channel)
        self.channels[channel].turn_off()

    def set_intensity(self, channel: int, intensity: float) -> None:
        intensity = min(max(intensity, 0.0), 1.0)
        self._send("intensity", channel, intensity)
        self.channels[channel].intensity = intensity

    def strobe(self, channel: int, duration_us: float) -> None:
        self._send("strobe", channel, duration_us)
        state = self.channels[channel]
        state.activation_count += 1
        state.cumulative_on_time_s += duration_us / 1e6

    def trigger_all(self, duration_us: float = 100.0) -> None:
        for channel in self.channels:
            self.strobe(channel, duration_us)

    def get_channel_state(self, channel: int) -> ChannelState:
        return self.channels[channel]

    def health(self) -> Dict[str, Any]:
        """Usage-hours / intensity health checks (reference lib.rs:503-670)."""
        max_hours = self.config.get("led_rated_hours", 20000.0)
        worst = max((c.usage_hours for c in self.channels.values()),
                    default=0.0)
        return {
            "controller_id": self.controller_id,
            "channels": len(self.channels),
            "worst_usage_hours": worst,
            "remaining_life_fraction": max(0.0, 1.0 - worst / max_hours),
            "ok": worst < max_hours,
        }


class SimulatedLightingController(LightingController):
    """In-memory controller (reference controllers/simulator.rs:14-223)."""

    def __init__(self, controller_id: str = "sim", n_channels: int = 4,
                 config: Dict[str, Any] = None):
        super().__init__(controller_id, n_channels, config)
        self.command_log: List[tuple] = []

    def _send(self, command: str, channel: int, value: float = 0.0) -> None:
        self.command_log.append((time.time(), command, channel, value))


class SerialLightingController(LightingController):
    """Serial protocol framer (reference controllers/serial.rs:16-551).

    Frames commands as ``@<channel><op><value>\\r\\n``; the transport is a
    pluggable writer so tests inject a loopback and hardware uses a real
    serial port object (pyserial-compatible ``write``).
    """

    def __init__(self, controller_id: str = "serial", n_channels: int = 4,
                 config: Dict[str, Any] = None, transport=None):
        super().__init__(controller_id, n_channels, config)
        self.port = (config or {}).get("port", "/dev/ttyUSB0")
        self.baudrate = (config or {}).get("baudrate", 115200)
        self.transport = transport  # object with .write(bytes)
        self.sent: List[bytes] = []

    _OPS = {"on": "N", "off": "F", "intensity": "I", "strobe": "S"}

    def _frame(self, command: str, channel: int, value: float) -> bytes:
        op = self._OPS[command]
        if command == "intensity":
            payload = f"{int(value * 255):03d}"
        elif command == "strobe":
            payload = f"{int(value):06d}"
        else:
            payload = ""
        return f"@{channel}{op}{payload}\r\n".encode()

    def _send(self, command: str, channel: int, value: float = 0.0) -> None:
        frame = self._frame(command, channel, value)
        self.sent.append(frame)
        if self.transport is not None:
            self.transport.write(frame)


class EthernetLightingController(LightingController):
    """UDP/TCP line protocol (reference controllers/ethernet.rs:18-529);
    the socket is injected (tests use a recorder)."""

    def __init__(self, controller_id: str = "ethernet", n_channels: int = 4,
                 config: Dict[str, Any] = None, socket_=None):
        super().__init__(controller_id, n_channels, config)
        self.host = (config or {}).get("host", "192.168.1.50")
        self.port = (config or {}).get("port", 5000)
        self.socket = socket_
        self.sent: List[bytes] = []

    def _send(self, command: str, channel: int, value: float = 0.0) -> None:
        msg = f"LIGHT {command.upper()} CH{channel} {value:.4f}\n".encode()
        self.sent.append(msg)
        if self.socket is not None:
            self.socket.sendto(msg, (self.host, self.port))


class LightingControllerFactory:
    """serial/ethernet/simulator/gpio factory (reference lib.rs:206-235)."""

    _TYPES = {
        "simulator": SimulatedLightingController,
        "serial": SerialLightingController,
        "ethernet": EthernetLightingController,
    }

    @classmethod
    def create(cls, kind: str, controller_id: str = None,
               n_channels: int = 4,
               config: Dict[str, Any] = None) -> LightingController:
        if kind == "gpio":
            # GPIO backend is a feature-gated extra in the reference
            # (lib.rs:224-228); simulate unless a real GPIO lib registers.
            kind = "simulator"
        ctrl_cls = cls._TYPES.get(kind)
        if ctrl_cls is None:
            raise ValueError(f"unknown lighting controller type: {kind}")
        return ctrl_cls(controller_id or kind, n_channels, config)

    @classmethod
    def register(cls, name: str, ctrl_cls) -> None:
        cls._TYPES[name] = ctrl_cls
