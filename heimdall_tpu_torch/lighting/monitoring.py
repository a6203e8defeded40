"""Lighting health monitoring, trend analysis, and alerting.

Rebuilds the reference's diagnostics layer (rust/heimdall-lighting/src/
diagnostics/monitoring.rs:17-415 and alerts.rs:13-313): periodic
measurements with linear-fit trend analysis, LED remaining-life
prediction, anomaly detection, and an AlertManager with levels,
acknowledgement, history and callbacks.

A copy of heimdall_tpu/lighting/monitoring.py: the port imports nothing of the JAX
package.
"""

import enum
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from heimdall_tpu_torch.lighting.controller import LightingController

logger = logging.getLogger("heimdall.lighting.monitoring")


class AlertLevel(enum.Enum):
    INFO = "info"
    WARNING = "warning"
    ERROR = "error"
    CRITICAL = "critical"


@dataclass
class Alert:
    level: AlertLevel
    source: str
    message: str
    timestamp: float = field(default_factory=time.time)
    acknowledged: bool = False


class AlertManager:
    """Alert levels, ack, history, callbacks (reference alerts.rs:53-313)."""

    def __init__(self, history_limit: int = 1000):
        self.history: List[Alert] = []
        self.history_limit = history_limit
        self._callbacks: List[Callable[[Alert], None]] = []

    def register_callback(self, fn: Callable[[Alert], None]) -> None:
        self._callbacks.append(fn)

    def raise_alert(self, level: AlertLevel, source: str,
                    message: str) -> Alert:
        alert = Alert(level=level, source=source, message=message)
        self.history.append(alert)
        if len(self.history) > self.history_limit:
            self.history.pop(0)
        logger.log({AlertLevel.INFO: logging.INFO,
                    AlertLevel.WARNING: logging.WARNING,
                    AlertLevel.ERROR: logging.ERROR,
                    AlertLevel.CRITICAL: logging.CRITICAL}[level],
                   "[%s] %s", source, message)
        for fn in self._callbacks:
            try:
                fn(alert)
            except Exception:  # noqa: BLE001 - callbacks must not break us
                logger.exception("alert callback failed")
        return alert

    def active(self) -> List[Alert]:
        return [a for a in self.history if not a.acknowledged]

    def acknowledge(self, alert: Alert) -> None:
        alert.acknowledged = True

    def acknowledge_all(self) -> None:
        for a in self.history:
            a.acknowledged = True


@dataclass
class Measurement:
    timestamp: float
    brightness: float
    intensity: float
    uniformity: float


class LightingMonitor:
    """Periodic measurements + trend analysis + remaining-life prediction
    (reference monitoring.rs:17-415)."""

    def __init__(self, controller: LightingController,
                 alert_manager: Optional[AlertManager] = None,
                 window: int = 500,
                 brightness_drop_warning: float = 0.15,
                 anomaly_sigma: float = 4.0,
                 led_rated_hours: float = 20000.0):
        self.controller = controller
        self.alerts = alert_manager or AlertManager()
        self.window = window
        self.brightness_drop_warning = brightness_drop_warning
        self.anomaly_sigma = anomaly_sigma
        self.led_rated_hours = led_rated_hours
        self.measurements: List[Measurement] = []

    def record(self, brightness: float, uniformity: float = 1.0,
               channel: int = 0) -> None:
        state = self.controller.get_channel_state(channel)
        m = Measurement(time.time(), brightness, state.intensity, uniformity)
        self.measurements.append(m)
        if len(self.measurements) > self.window:
            self.measurements.pop(0)
        self._check_anomaly(m)

    # -- analysis ----------------------------------------------------------
    def trend(self) -> Dict[str, float]:
        """Linear fit of brightness vs time (reference monitoring.rs
        trend analysis)."""
        if len(self.measurements) < 3:
            return {"slope_per_hour": 0.0, "r2": 0.0}
        t = np.asarray([m.timestamp for m in self.measurements])
        b = np.asarray([m.brightness for m in self.measurements])
        t = (t - t[0]) / 3600.0
        if t[-1] <= 0:
            return {"slope_per_hour": 0.0, "r2": 0.0}
        coeffs = np.polyfit(t, b, 1)
        pred = np.polyval(coeffs, t)
        ss_res = float(((b - pred) ** 2).sum())
        ss_tot = float(((b - b.mean()) ** 2).sum())
        r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
        return {"slope_per_hour": float(coeffs[0]), "r2": r2}

    def predict_remaining_life_hours(self, channel: int = 0) -> float:
        """LED remaining life: rated hours minus usage, shortened when the
        brightness trend is declining (reference monitoring.rs:245-344)."""
        state = self.controller.get_channel_state(channel)
        base_remaining = max(self.led_rated_hours - state.usage_hours, 0.0)
        tr = self.trend()
        slope = tr["slope_per_hour"]
        if slope < -1e-6 and self.measurements:
            current = self.measurements[-1].brightness
            floor = current * (1.0 - self.brightness_drop_warning)
            hours_to_floor = (floor - current) / slope
            return float(min(base_remaining, max(hours_to_floor, 0.0)))
        return float(base_remaining)

    def _check_anomaly(self, m: Measurement) -> None:
        if len(self.measurements) < 20:
            return
        b = np.asarray([x.brightness for x in self.measurements[:-1]])
        mean, std = float(b.mean()), float(b.std())
        if std > 1e-9 and abs(m.brightness - mean) > self.anomaly_sigma * std:
            self.alerts.raise_alert(
                AlertLevel.WARNING, self.controller.controller_id,
                f"brightness anomaly: {m.brightness:.1f} vs "
                f"mean {mean:.1f} (sigma {std:.2f})")

    def health_report(self) -> Dict[str, Any]:
        report = {
            "controller": self.controller.health(),
            "trend": self.trend(),
            "remaining_life_hours": self.predict_remaining_life_hours(),
            "active_alerts": len(self.alerts.active()),
            "measurements": len(self.measurements),
        }
        drop = report["trend"]["slope_per_hour"]
        if drop < -5.0:
            self.alerts.raise_alert(
                AlertLevel.WARNING, self.controller.controller_id,
                f"brightness declining {drop:.1f}/hour")
        return report
