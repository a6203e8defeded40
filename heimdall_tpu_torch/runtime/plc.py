"""PLC communication and bottle rejection control.

The reference configures PLC comms (modbus @ 192.168.1.100:502) and
rejection pulse timing (delay 100 ms / pulse 50 ms) but implements only a
log stub (heimdall/core/config.py:50-61, core/system.py:152-160).  This
module completes the surface: a transport-agnostic PLC client protocol
(simulated by default; a modbus transport slots in via ``transport``), and
a RejectionController that schedules delayed reject pulses — the delay is
the conveyor travel time from camera to rejector, so timing correctness is
what makes a reject hit the right bottle.

A copy of heimdall_tpu/runtime/plc.py: the port imports
nothing of the JAX package.
"""

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

logger = logging.getLogger("heimdall.plc")


class PLCClient:
    """Register-level PLC client; transport does the wire protocol."""

    def __init__(self, ip: str = "192.168.1.100", port: int = 502,
                 protocol: str = "modbus", transport=None):
        self.ip = ip
        self.port = port
        self.protocol = protocol
        self.transport = transport       # object with read/write_register
        self._sim_registers: Dict[int, int] = {}
        self.connected = False

    def connect(self) -> bool:
        if self.transport is not None:
            self.connected = bool(self.transport.connect(self.ip, self.port))
        else:
            self.connected = True        # simulated
        logger.info("PLC %s:%d connected=%s (%s)", self.ip, self.port,
                    self.connected, self.protocol)
        return self.connected

    def disconnect(self) -> None:
        if self.transport is not None:
            self.transport.disconnect()
        self.connected = False

    def write_register(self, address: int, value: int) -> None:
        if not self.connected:
            raise ConnectionError("PLC not connected")
        if self.transport is not None:
            self.transport.write_register(address, value)
        else:
            self._sim_registers[address] = value

    def read_register(self, address: int) -> int:
        if not self.connected:
            raise ConnectionError("PLC not connected")
        if self.transport is not None:
            return self.transport.read_register(address)
        return self._sim_registers.get(address, 0)


# register map (simulated line controller)
REG_REJECT_PULSE = 100
REG_LINE_SPEED = 101
REG_HEARTBEAT = 102


@dataclass
class RejectEvent:
    station_id: str
    scheduled_at: float
    fired_at: Optional[float] = None
    confidence: float = 0.0


class RejectionController:
    """Schedules reject pulses with the configured conveyor delay.

    reject() arms a timer for delay_ms; when it fires, the controller
    pulses the PLC reject register for pulse_duration_ms.  Events are
    recorded for audit (the traceability surface the reference's
    ResultRepository design sketches, architecture_design.md:387-407).
    """

    def __init__(self, plc: Optional[PLCClient] = None,
                 delay_ms: float = 100.0, pulse_duration_ms: float = 50.0,
                 history_limit: int = 1000):
        self.plc = plc or PLCClient()
        if not self.plc.connected:
            self.plc.connect()
        self.delay_ms = delay_ms
        self.pulse_duration_ms = pulse_duration_ms
        self.history: List[RejectEvent] = []
        self.history_limit = history_limit
        self.rejects_fired = 0
        self._lock = threading.Lock()

    def reject(self, station_id: str, confidence: float = 1.0) -> RejectEvent:
        event = RejectEvent(station_id=station_id,
                            scheduled_at=time.time(),
                            confidence=confidence)
        timer = threading.Timer(self.delay_ms / 1000.0, self._fire, [event])
        timer.daemon = True
        timer.start()
        with self._lock:
            self.history.append(event)
            if len(self.history) > self.history_limit:
                self.history.pop(0)
        return event

    def _fire(self, event: RejectEvent) -> None:
        try:
            self.plc.write_register(REG_REJECT_PULSE, 1)
            time.sleep(self.pulse_duration_ms / 1000.0)
            self.plc.write_register(REG_REJECT_PULSE, 0)
            event.fired_at = time.time()
            with self._lock:
                self.rejects_fired += 1
            logger.info("Reject pulse fired for %s (conf %.2f)",
                        event.station_id, event.confidence)
        except Exception as exc:  # noqa: BLE001
            logger.error("Reject pulse failed: %s", exc)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"scheduled": len(self.history),
                    "fired": self.rejects_fired,
                    "delay_ms": self.delay_ms,
                    "pulse_duration_ms": self.pulse_duration_ms}
