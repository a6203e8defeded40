"""Lighting/camera synchronization: strobe-per-trigger with delay stats.

Rebuilds the reference's LightingSynchronizer (lib.rs:238-416): an event
channel driving trigger_all per SyncEvent with success/fail counters and
average/max trigger delay, plus the strobe-timing calculator
(synchronization/camera_sync.rs:15-180), high-precision timing helpers and
jitter measurement (synchronization/timing.rs:5-286).

A copy of heimdall_tpu/lighting/sync.py: the port imports nothing of the JAX
package.
"""

import enum
import logging
import queue
import statistics
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from heimdall_tpu_torch.lighting.controller import LightingController

logger = logging.getLogger("heimdall.lighting.sync")


class SyncEvent(enum.Enum):
    """Reference lib.rs:253-262."""
    CAMERA_TRIGGER = "camera_trigger"
    EXTERNAL_TRIGGER = "external_trigger"
    SOFTWARE_TRIGGER = "software_trigger"
    STOP = "stop"


class LightingSynchronizer:
    """Background event loop firing strobes on trigger events."""

    def __init__(self, controller: LightingController,
                 strobe_duration_us: float = 100.0, queue_size: int = 100):
        self.controller = controller
        self.strobe_duration_us = strobe_duration_us
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._thread: Optional[threading.Thread] = None
        self.success_count = 0
        self.failure_count = 0
        self._delays_us: List[float] = []

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._queue.put((SyncEvent.STOP, time.time()))
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def send_event(self, event: SyncEvent) -> None:
        self._queue.put((event, time.time()))

    def _loop(self) -> None:
        while True:
            event, t_enqueued = self._queue.get()
            if event == SyncEvent.STOP:
                return
            try:
                self.controller.trigger_all(self.strobe_duration_us)
                delay = (time.time() - t_enqueued) * 1e6
                self._delays_us.append(delay)
                if len(self._delays_us) > 1000:
                    self._delays_us.pop(0)
                self.success_count += 1
            except Exception as exc:  # noqa: BLE001
                logger.warning("strobe failed: %s", exc)
                self.failure_count += 1

    def stats(self) -> Dict[str, float]:
        return {
            "success": float(self.success_count),
            "failure": float(self.failure_count),
            "avg_delay_us": statistics.mean(self._delays_us)
            if self._delays_us else 0.0,
            "max_delay_us": max(self._delays_us, default=0.0),
        }


@dataclass
class StrobeTiming:
    delay_us: float
    duration_us: float


def compute_strobe_timing(exposure_us: float,
                          strobe_fraction: float = 0.8,
                          transport_delay_us: float = 5.0) -> StrobeTiming:
    """Optimal strobe delay/duration vs camera exposure
    (reference synchronization/camera_sync.rs:15-180): centre the strobe
    inside the exposure window, compensating for the trigger transport
    delay."""
    duration = exposure_us * strobe_fraction
    delay = max((exposure_us - duration) / 2.0 - transport_delay_us, 0.0)
    return StrobeTiming(delay_us=delay, duration_us=duration)


class HighPrecisionTimer:
    """Calibrated spin-wait timer (reference synchronization/timing.rs)."""

    def __init__(self, spin_threshold_us: float = 200.0):
        self.spin_threshold_us = spin_threshold_us

    def wait_us(self, duration_us: float) -> float:
        start = time.perf_counter()
        target = start + duration_us / 1e6
        sleep_budget = duration_us - self.spin_threshold_us
        if sleep_budget > 0:
            time.sleep(sleep_budget / 1e6)
        while time.perf_counter() < target:
            pass
        return (time.perf_counter() - start) * 1e6


class JitterMeasurement:
    """Interval jitter accumulator (reference timing.rs JitterMeasurement)."""

    def __init__(self, expected_period_us: float, window: int = 1000):
        self.expected_period_us = expected_period_us
        self.window = window
        self._last: Optional[float] = None
        self._jitters: List[float] = []

    def record_event(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            interval_us = (now - self._last) * 1e6
            self._jitters.append(abs(interval_us - self.expected_period_us))
            if len(self._jitters) > self.window:
                self._jitters.pop(0)
        self._last = now

    def stats(self) -> Dict[str, float]:
        if not self._jitters:
            return {"mean_us": 0.0, "max_us": 0.0, "stddev_us": 0.0}
        return {
            "mean_us": statistics.mean(self._jitters),
            "max_us": max(self._jitters),
            "stddev_us": statistics.stdev(self._jitters)
            if len(self._jitters) > 1 else 0.0,
        }
