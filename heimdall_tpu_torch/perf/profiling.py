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


# The kernel of torch.cuda._sleep, which brackets a traced block on the
# card, and its length in clock cycles (about 0.5 us at 1980 MHz).
SPIN_KERNEL = "spin_kernel"
SPIN_CYCLES = 1000
# Kernels a CUDA trace opens with before its opening spin, each behind a
# sync (a fill of one float: FillFunctor's kernel).  Once another process
# has used the card, or this one has trained on it, the profiler drops the
# first kernel records of every trace, a few after a child process and
# more after training (scripts/check_trace.py, chip_smoke.py's phase 4h);
# these are the ones it drops.
LEAD_KERNELS = 256
LEAD_KERNEL = "FillFunctor"


def lead(device):
    """LEAD_KERNELS fill kernels on the device, each behind a sync."""
    import torch
    marker = torch.zeros(1, device=device)
    for _ in range(LEAD_KERNELS):
        marker.fill_(0)
        torch.cuda.synchronize(device)


def _spin(device):
    """A spin kernel on the device, behind a sync and followed by one."""
    import torch
    torch.cuda.synchronize(device)
    with torch.cuda.device(device):
        torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize(device)


def _trace_kernels(path) -> List[str]:
    """The names of the card's kernels in a Chrome trace, in the order they
    ran."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return [e["name"] for e in sorted(kernels, key=lambda e: e["ts"])]


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
        self.trace_kernels: Optional[int] = None
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
        on the card, is kept as ``trace_table``.

        On the card the trace opens with LEAD_KERNELS fill kernels, which
        the profiler may drop (it drops a trace's first kernel records once
        another process has used the card or this one has trained on it;
        scripts/check_trace.py), and the block runs between two spin
        kernels (torch.cuda._sleep, each behind a sync), which the trace
        lists too; ``trace_kernels`` counts the card's kernels in it.  A
        trace whose first kernel after the lead is not the opening spin, or
        whose last kernel is not the closing spin, has lost the block's
        kernels: the files are still written, and then a RuntimeError names
        the loss (the profiler can still lose a whole trace, rarely:
        ROADMAP.md, section C)."""
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
            if cuda:
                lead(self.device)
                _spin(self.device)
            yield log_dir
            if cuda:
                _spin(self.device)
        self.trace_path = os.path.join(log_dir, f"{self.name}_trace.json")
        prof.export_chrome_trace(self.trace_path)
        self.trace_table = prof.key_averages().table(
            sort_by="cuda_time_total" if cuda else "cpu_time_total",
            row_limit=40)
        if cuda:
            names = _trace_kernels(self.trace_path)
            self.trace_kernels = len(names)
            body = names[next((i for i, n in enumerate(names)
                               if LEAD_KERNEL not in n), len(names)):]
            missing = [end for end, i in (("opening", 0), ("closing", -1))
                       if not body or SPIN_KERNEL not in body[i]]
            if missing:
                raise RuntimeError(
                    f"ProfilingSession.trace {self.name!r}: the trace lost "
                    f"the card's kernels: no {' and no '.join(missing)} spin "
                    f"kernel ({len(names)} CUDA kernels listed; "
                    f"{self.trace_path})")

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
