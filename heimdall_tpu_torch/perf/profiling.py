"""Profiling sessions: named timings, counters, system metrics, reports
(port of heimdall_tpu/perf/profiling.py).

Rebuilds rust/heimdall-perf's session layer (lib.rs:37-348, system.rs:
6-151, profiler.rs:10-148): MetricType/Measurement records,
ProfilingSession with start/stop named timings + counters + process
CPU/RSS sampling (procfs), ProfilingManager with session history and
auto-saved JSON reports, and measure_time/measure_throughput helpers.
The reference's pprof sampling profiler maps to ``torch.profiler`` traces
(``ProfilingSession.trace`` context): a Chrome trace (chrome://tracing or
Perfetto) instead of SVG export, with the card's kernels when the session's
device is CUDA, and the per-operator ``key_averages`` table kept on the
session.
"""

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("heimdall.perf")


class MetricType:
    """Reference lib.rs:37-62."""
    EXECUTION_TIME = "execution_time"
    CPU_USAGE = "cpu_usage"
    MEMORY_USAGE = "memory_usage"
    THROUGHPUT = "throughput"
    LATENCY = "latency"
    JITTER = "jitter"
    DEADLINE_MISSES = "deadline_misses"
    CUSTOM = "custom"


@dataclass
class Measurement:
    """Reference lib.rs:64-104."""
    metric_type: str
    name: str
    value: float
    unit: str
    timestamp: float = field(default_factory=time.time)
    metadata: Dict[str, Any] = field(default_factory=dict)


def _read_proc_self() -> Dict[str, float]:
    """Process CPU jiffies + RSS + thread count via procfs
    (reference system.rs:6-151; Linux-only, zeros elsewhere)."""
    out = {"utime": 0.0, "stime": 0.0, "rss_bytes": 0.0, "threads": 0.0}
    try:
        with open("/proc/self/stat") as f:
            parts = f.read().split()
        out["utime"] = float(parts[13])
        out["stime"] = float(parts[14])
        out["threads"] = float(parts[19])
        out["rss_bytes"] = float(parts[23]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # pragma: no cover - non-Linux
        pass
    return out


class ProfilingSession:
    """Named timings + counters + system metrics (reference lib.rs:107-263)."""

    def __init__(self, name: str, device="cuda"):
        self.name = name
        self.device = device
        self.trace_path: Optional[str] = None
        self.trace_table: Optional[str] = None
        self.started_at = time.time()
        self.measurements: List[Measurement] = []
        self._open_timings: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        self._cpu0 = _read_proc_self()
        self._wall0 = time.time()

    # -- timings -----------------------------------------------------------
    def start_timing(self, name: str) -> None:
        self._open_timings[name] = time.perf_counter()

    def stop_timing(self, name: str) -> float:
        start = self._open_timings.pop(name, None)
        if start is None:
            return 0.0
        elapsed = time.perf_counter() - start
        self.measurements.append(Measurement(
            MetricType.EXECUTION_TIME, name, elapsed * 1000.0, "ms"))
        return elapsed

    @contextlib.contextmanager
    def timing(self, name: str):
        self.start_timing(name)
        try:
            yield
        finally:
            self.stop_timing(name)

    @contextlib.contextmanager
    def trace(self, log_dir: str):
        """torch.profiler trace of the block (the pprof/flamegraph
        equivalent): host operators, and the card's kernels when the
        session's device is CUDA (raises when no card is present).  On
        exit the Chrome trace is written to ``log_dir/<name>_trace.json``
        (``trace_path``) and the key_averages table, sorted by device time
        on the card, is kept as ``trace_table``."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.device(self.device).type == "cuda"
        if cuda and not torch.cuda.is_available():
            raise RuntimeError("ProfilingSession.trace on device "
                               f"{self.device!r}: no CUDA device")
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield log_dir
            if cuda:
                torch.cuda.synchronize(self.device)
        self.trace_path = os.path.join(log_dir, f"{self.name}_trace.json")
        prof.export_chrome_trace(self.trace_path)
        self.trace_table = prof.key_averages().table(
            sort_by="cuda_time_total" if cuda else "cpu_time_total",
            row_limit=40)

    # -- counters / custom metrics ----------------------------------------
    def increment(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    def record(self, metric_type: str, name: str, value: float,
               unit: str = "", **metadata) -> None:
        self.measurements.append(Measurement(metric_type, name, value, unit,
                                             metadata=metadata))

    def sample_system(self) -> None:
        now = _read_proc_self()
        wall = time.time() - self._wall0
        hz = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
        if wall > 0:
            cpu_pct = ((now["utime"] + now["stime"]
                        - self._cpu0["utime"] - self._cpu0["stime"])
                       / hz) / wall * 100.0
            self.record(MetricType.CPU_USAGE, "process_cpu", cpu_pct, "%")
        self.record(MetricType.MEMORY_USAGE, "rss", now["rss_bytes"],
                    "bytes")
        self.record(MetricType.CUSTOM, "threads", now["threads"], "")

    # -- report ------------------------------------------------------------
    def report(self) -> "Report":
        from heimdall_tpu_torch.perf.reports import Report
        return Report.from_session(self)


class ProfilingManager:
    """Session lifecycle + history + auto-saved reports
    (reference lib.rs:265-348)."""

    def __init__(self, output_dir: str = "./reports"):
        self.output_dir = output_dir
        self.active: Dict[str, ProfilingSession] = {}
        self.history: List[str] = []

    def start_session(self, name: str, device="cuda") -> ProfilingSession:
        session = ProfilingSession(name, device)
        self.active[name] = session
        return session

    def end_session(self, name: str, save: bool = True) -> Optional[str]:
        session = self.active.pop(name, None)
        if session is None:
            return None
        self.history.append(name)
        if save:
            os.makedirs(self.output_dir, exist_ok=True)
            path = os.path.join(self.output_dir,
                                f"{name}_{int(time.time())}.json")
            with open(path, "w") as f:
                json.dump(session.report().to_dict(), f, indent=2)
            return path
        return None


def measure_time(fn: Callable, *args, **kwargs):
    """(result, elapsed_s) helper (reference profiler.rs measure_time)."""
    start = time.perf_counter()
    result = fn(*args, **kwargs)
    return result, time.perf_counter() - start


def measure_throughput(fn: Callable, items: int, *args, **kwargs):
    """(result, items_per_second) helper."""
    result, elapsed = measure_time(fn, *args, **kwargs)
    return result, (items / elapsed if elapsed > 0 else 0.0)
