"""External trigger synchronization sources with debouncing.

Rebuilds rust/heimdall-lighting's external-sync layer
(synchronization/external_sync.rs:14-374): an ExternalSynchronizer fed by
pluggable trigger sources — GPIO line, trigger input, quadrature encoder,
proximity sensor, external clock — each debounced, each driving the
LightingSynchronizer/SyncManager event path.  Hardware sources are
simulated (as in the reference); real ones implement ``poll()``.

A copy of heimdall_tpu/lighting/external_sync.py: the port imports nothing of the JAX
package.
"""

import enum
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("heimdall.lighting.external_sync")


class TriggerSource(enum.Enum):
    """Reference external_sync.rs trigger sources."""
    GPIO = "gpio"
    TRIGGER_INPUT = "trigger_input"
    ENCODER = "encoder"
    PROXIMITY_SENSOR = "proximity_sensor"
    EXTERNAL_CLOCK = "external_clock"


class SignalSource:
    """A pollable digital signal (override ``poll`` for real hardware)."""

    def poll(self) -> bool:
        raise NotImplementedError


class SimulatedPulseSource(SignalSource):
    """Emits True once per period (bottle-on-conveyor simulation)."""

    def __init__(self, period_s: float = 0.04, duty: float = 0.2):
        self.period_s = period_s
        self.duty = duty
        self._t0 = time.perf_counter()

    def poll(self) -> bool:
        phase = ((time.perf_counter() - self._t0) % self.period_s) \
            / self.period_s
        return phase < self.duty


class SimulatedEncoderSource(SignalSource):
    """Quadrature-encoder tick counter: triggers every ``ticks_per_bottle``
    ticks (conveyor-position triggering, reference external_sync.rs
    encoder monitor)."""

    def __init__(self, ticks_per_second: float = 2000.0,
                 ticks_per_bottle: int = 80):
        self.ticks_per_second = ticks_per_second
        self.ticks_per_bottle = ticks_per_bottle
        self._t0 = time.perf_counter()
        self._last_bottle = 0

    @property
    def position(self) -> int:
        return int((time.perf_counter() - self._t0) * self.ticks_per_second)

    def poll(self) -> bool:
        bottle = self.position // self.ticks_per_bottle
        if bottle > self._last_bottle:
            self._last_bottle = bottle
            return True
        return False


@dataclass
class DebouncedTrigger:
    """Edge detection + debounce window (reference debounce logic)."""
    source: SignalSource
    debounce_s: float = 0.002
    _last_level: bool = False
    _last_fire: float = 0.0
    fires: int = 0

    def check(self) -> bool:
        level = self.source.poll()
        now = time.perf_counter()
        fired = False
        if level and not self._last_level and \
                now - self._last_fire >= self.debounce_s:
            self._last_fire = now
            self.fires += 1
            fired = True
        self._last_level = level
        return fired


class ExternalSynchronizer:
    """Monitors trigger sources in a background thread and invokes the
    registered callbacks per trigger (camera trigger + strobe fan-out)."""

    def __init__(self, poll_interval_s: float = 0.0005):
        self.poll_interval_s = poll_interval_s
        self.triggers: Dict[TriggerSource, DebouncedTrigger] = {}
        self._callbacks: List[Callable[[TriggerSource], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.total_triggers = 0

    def add_source(self, kind: TriggerSource, source: SignalSource,
                   debounce_s: float = 0.002) -> None:
        self.triggers[kind] = DebouncedTrigger(source, debounce_s)

    def register_callback(self,
                          fn: Callable[[TriggerSource], None]) -> None:
        self._callbacks.append(fn)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            for kind, trig in self.triggers.items():
                if trig.check():
                    self.total_triggers += 1
                    for fn in self._callbacks:
                        try:
                            fn(kind)
                        except Exception:  # noqa: BLE001
                            logger.exception("trigger callback failed")
            time.sleep(self.poll_interval_s)

    def stats(self) -> Dict[str, int]:
        return {"total": self.total_triggers,
                **{k.value: t.fires for k, t in self.triggers.items()}}
