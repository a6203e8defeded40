"""Windowed metrics primitives + a Prometheus-able registry (copy of
heimdall_tpu/perf/metrics.py).

Rebuilds rust/heimdall-perf's metrics layer (metrics.rs:8-383): a
SlidingWindow with min/max/avg, MetricCounter, Timer and ThroughputMeter —
plus a MetricsRegistry giving the counter!/gauge!/histogram! facade the
reference sprinkles through acquisition (gige/lib.rs:168-170,454,644-645)
with a Prometheus text exposition for the dashboard/server.
"""

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class SlidingWindow:
    """Fixed-capacity window with min/max/avg (reference metrics.rs:8-120)."""

    def __init__(self, capacity: int = 100):
        self.capacity = capacity
        self._values: deque = deque(maxlen=capacity)

    def push(self, value: float) -> None:
        self._values.append(float(value))

    def __len__(self) -> int:
        return len(self._values)

    @property
    def values(self) -> List[float]:
        return list(self._values)

    def min(self) -> float:
        return min(self._values) if self._values else 0.0

    def max(self) -> float:
        return max(self._values) if self._values else 0.0

    def avg(self) -> float:
        return sum(self._values) / len(self._values) if self._values else 0.0

    def percentile(self, p: float) -> float:
        if not self._values:
            return 0.0
        vals = sorted(self._values)
        idx = min(int(len(vals) * p / 100.0), len(vals) - 1)
        return vals[idx]


class MetricCounter:
    """Monotonic counter with windowed rate (reference metrics.rs:123-207)."""

    def __init__(self, name: str, window: int = 100):
        self.name = name
        self.count = 0
        self._stamps = SlidingWindow(window)
        self._lock = threading.Lock()

    def increment(self, by: int = 1) -> None:
        with self._lock:
            self.count += by
            self._stamps.push(time.time())

    def rate_per_second(self) -> float:
        vals = self._stamps.values
        if len(vals) < 2:
            return 0.0
        span = vals[-1] - vals[0]
        return (len(vals) - 1) / span if span > 0 else 0.0


class Timer:
    """Start/stop timer feeding a window (reference metrics.rs:210-295)."""

    def __init__(self, name: str, window: int = 100):
        self.name = name
        self.window = SlidingWindow(window)
        self._start: Optional[float] = None

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._start is None:
            return 0.0
        elapsed = time.perf_counter() - self._start
        self.window.push(elapsed)
        self._start = None
        return elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def stats(self) -> Dict[str, float]:
        return {"min_s": self.window.min(), "max_s": self.window.max(),
                "avg_s": self.window.avg(), "count": float(len(self.window))}


class ThroughputMeter:
    """Items/second over a window (reference metrics.rs:298-383)."""

    def __init__(self, name: str, window: int = 100):
        self.name = name
        self._events = SlidingWindow(window)    # (timestamp) pairs
        self._counts = SlidingWindow(window)
        self.total = 0

    def record(self, items: int = 1) -> None:
        self._events.push(time.time())
        self._counts.push(items)
        self.total += items

    def throughput(self) -> float:
        stamps = self._events.values
        if len(stamps) < 2:
            return 0.0
        span = stamps[-1] - stamps[0]
        items = sum(self._counts.values[1:])
        return items / span if span > 0 else 0.0


class MetricsRegistry:
    """counter/gauge/histogram facade + Prometheus text exposition."""

    def __init__(self):
        self._counters: Dict[str, MetricCounter] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, SlidingWindow] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> MetricCounter:
        with self._lock:
            return self._counters.setdefault(name, MetricCounter(name))

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def histogram(self, name: str, value: float, window: int = 1000) -> None:
        with self._lock:
            self._histograms.setdefault(name, SlidingWindow(window)) \
                .push(value)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": {n: c.count for n, c in self._counters.items()},
                "gauges": dict(self._gauges),
                "histograms": {
                    n: {"avg": w.avg(), "min": w.min(), "max": w.max(),
                        "p99": w.percentile(99)}
                    for n, w in self._histograms.items()},
            }

    def prometheus_text(self) -> str:
        """Prometheus exposition format (the reference declared a
        prometheus exporter on :9090 — gige/Cargo.toml:36-37)."""
        lines = []
        snap = self.snapshot()
        for name, value in snap["counters"].items():
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {value}")
        for name, value in snap["gauges"].items():
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {value}")
        for name, stats in snap["histograms"].items():
            lines.append(f"# TYPE {name} summary")
            for key, v in stats.items():
                lines.append(f'{name}{{stat="{key}"}} {v}')
        return "\n".join(lines) + "\n"


# global default registry (the reference's global metrics facade)
registry = MetricsRegistry()
