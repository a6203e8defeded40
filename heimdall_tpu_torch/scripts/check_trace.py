"""Whether torch.profiler traces record the card's kernels, in the
conditions where the port's traces have lost them: the first trace of a
process, right after another process that used the card (plain CUDA work,
and a 1-rank NCCL world) has exited, and after train steps in this
process.  Prints one JSON line per condition and mode:

* "clock": the card's %globaltimer (read by a kernel of its own, k_stamp)
  less the host's wall clock around idle gaps, the wall clock less the
  monotonic one, and traces of k_stamp kernels: each one's timer from the
  trace's opening, and the start the trace kept for it less its timer
  (None where the trace dropped it);
* "session": TRACES ProfilingSession.traces of a few PyTorch kernels: the
  card's kernels each listed and the clock skew, or the error it raised;
* "plain", "margin" (50 ms of host time after the trace opens and before it
  closes), "wake1ms" / "wake10ms" (a spin kernel that keeps the card busy
  before the opening spin), "margin500ms", "lead" (ProfilingSession.
  trace's lead of fill kernels before the opening spin, and how many of
  them the trace dropped): raw torch.profiler traces of the same kernels
  between two spin kernels: the CUDA kernels recorded, the spins among
  them, the clock skew (the least time from a kernel's launch, its
  runtime call on the host's clock, to its start on the card's, in us)
  and the kernels' names.

Modes named as arguments run alone, for instance

    python -m heimdall_tpu_torch.scripts.check_trace session plain lead

To see kineto's own counts of what it dropped (its "Record counts:
Out-of-range" line after each trace), and the runs with CUPTI torn down
after every trace and kept up between traces:

    KINETO_LOG_LEVEL=0 TEARDOWN_CUPTI=1 python -m heimdall_tpu_torch.scripts.check_trace
    KINETO_LOG_LEVEL=0 TEARDOWN_CUPTI=0 python -m heimdall_tpu_torch.scripts.check_trace

Prints the card (nvidia-smi's name and power limit) first.  Needs a card.
"""

import ctypes
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from heimdall_tpu_torch.ops import _cuda
from heimdall_tpu_torch.scripts.timing import card, require_card

TRACES = 4
# Host seconds a "margin" trace waits after it opens and before it closes.
MARGIN_S = 0.05
MODES = ("plain", "margin", "wake1ms", "wake10ms", "margin500ms", "lead")
# Cycles of a spin kernel that keeps the card busy before the opening spin
# (about 1 and 10 ms at 1980 MHz).
WAKE_CYCLES = {"wake1ms": 2_000_000, "wake10ms": 20_000_000}

# A process that uses the card and exits: plain CUDA work, or a 1-rank NCCL
# world (init, an all-reduce, destroy).
CUDA_CHILD = ("import torch; x = torch.randn(1024, 1024, device='cuda'); "
              "print(float((x @ x).sum()))")
NCCL_CHILD = (
    "import sys, torch, torch.distributed as dist; "
    "dist.init_process_group('nccl', init_method=sys.argv[1], "
    "world_size=1, rank=0); t = torch.ones(4, device='cuda'); "
    "dist.all_reduce(t); torch.cuda.synchronize(); print(float(t.sum())); "
    "dist.destroy_process_group()")


# A one-thread kernel that writes the card's %globaltimer (ns) where it
# starts: the clock the card stamps kernels with, read by the kernel itself.
STAMP_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void k_stamp(unsigned long long* out, int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  out[i] = t;
}
extern "C" int stamp(unsigned long long* out, int i, void* stream) {
  k_stamp<<<1, 1, 0, (cudaStream_t)stream>>>(out, i);
  return (int)cudaGetLastError();
}
"""
STAMPS = 6                  # k_stamp kernels in a traced run
GAPS_S = (0.0, 0.001, 0.01, 0.05, 0.2)


def stamp_library() -> ctypes.CDLL:
    """k_stamp built with the port's nvcc flags into its build directory."""
    _cuda.BUILD_DIR.mkdir(exist_ok=True)
    key = hashlib.sha256((STAMP_SOURCE + " ".join(_cuda.NVCC_FLAGS)).encode())
    out = _cuda.BUILD_DIR / f"check_trace-{key.hexdigest()[:16]}.so"
    if not out.exists():
        src = out.with_suffix(".cu")
        src.write_text(STAMP_SOURCE)
        subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.stamp.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def clock_gaps(lib):
    """The card's %globaltimer against the host's clock (time.time_ns)
    around idle gaps: for each gap, the timer of the first kernel after it
    less the host's time at its launch, of a second kernel right behind it
    less the same, and of a third after a 1 ms spin kernel less the host's
    time after that; in us."""
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    rows = []
    for gap in GAPS_S:
        torch.cuda.synchronize()
        time.sleep(gap)
        h0 = time.time_ns()
        lib.stamp(out.data_ptr(), 0, st)
        lib.stamp(out.data_ptr(), 1, st)
        torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize()
        h1 = time.time_ns()
        lib.stamp(out.data_ptr(), 2, st)
        torch.cuda.synchronize()
        g = out.tolist()
        rows.append([gap, round((g[0] - h0) / 1e3, 3),
                     round((g[1] - h0) / 1e3, 3),
                     round((g[2] - h1) / 1e3, 3), wall_less_monotonic_us()])
    return rows


def wall_less_monotonic_us() -> float:
    """The host's wall clock (CLOCK_REALTIME, which the profiler's window
    opens and closes on) less its monotonic clock, in us: it moves where
    the wall clock is stepped or slewed."""
    return round((time.time_ns() - time.monotonic_ns()) / 1e3, 3)


def traced_stamps(lib, tmp, margin):
    """STAMPS k_stamp kernels in one trace, after ``margin`` s of host time:
    each kernel's %globaltimer less the host's time as the trace opened
    (us), and the start the trace kept for it, less its timer (us), or
    None where the trace dropped it."""
    from torch.profiler import ProfilerActivity, profile
    out = torch.zeros(STAMPS, dtype=torch.int64, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.time_ns()
        time.sleep(margin)
        for i in range(STAMPS):
            lib.stamp(out.data_ptr(), i, st)
            torch.cuda.synchronize()
        time.sleep(margin)
    path = os.path.join(tmp, "stamps.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    base = int(trace.get("baseTimeNanoseconds", 0))
    kept = sorted(base + e["ts"] * 1e3 for e in trace.get("traceEvents", [])
                  if e.get("cat") == "kernel" and "k_stamp" in e["name"])
    g = out.tolist()
    # the kept starts are the last len(kept) kernels' (the trace drops the
    # first ones)
    starts = [None] * (STAMPS - len(kept)) + kept
    return {"margin_s": margin,
            "timer_from_open_us": [round((t - h0) / 1e3, 3) for t in g],
            "kept_start_from_timer_us": [
                None if k is None else round((k - t) / 1e3, 3)
                for k, t in zip(starts, g)]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def body():
    """A few small kernels of PyTorch's own, as a traced block."""
    x = torch.ones(1 << 16, device="cuda")
    for _ in range(3):
        x.add_(1)
    torch.cuda.synchronize()


def skew_us(path):
    """The least launch-to-start time of the kernels in a Chrome trace, in
    us (None without kernels)."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    skews = [e["ts"] - launch[e["args"]["correlation"]] for e in events
             if e.get("cat") == "kernel"
             and e.get("args", {}).get("correlation") in launch]
    return round(min(skews), 3) if skews else None


def raw_trace(mode, tmp):
    """One torch.profiler trace of body() between two spin kernels: (CUDA
    kernels recorded, spins among them, skew in us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from heimdall_tpu_torch.perf import profiling
    margin = {"margin": MARGIN_S, "margin500ms": 0.5}.get(mode, 0.0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        torch.cuda.synchronize()
        if mode in WAKE_CYCLES:
            torch.cuda._sleep(WAKE_CYCLES[mode])
        if mode == "lead":
            profiling.lead("cuda")
        torch.cuda._sleep(1000)
        body()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(margin)
    path = os.path.join(tmp, "raw_trace.json")
    prof.export_chrome_trace(path)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    spins = sum("spin" in n for n in names) - (mode in WAKE_CYCLES)
    if mode == "lead":      # the lead's kernels the trace dropped
        kept = sum(profiling.LEAD_KERNEL in n for n in names)
        names = [f"lead dropped {profiling.LEAD_KERNELS - kept}"] + [
            n for n in names if profiling.LEAD_KERNEL not in n]
    return len(names), spins, skew_us(path), [n[:24] for n in names]


def session_trace(tmp):
    """ProfilingSession.trace of body(): (its CUDA kernels, skew in us), or
    its error."""
    from heimdall_tpu_torch.perf.profiling import ProfilingSession
    session = ProfilingSession("check_trace", device="cuda")
    try:
        with session.trace(tmp):
            body()
    except RuntimeError as e:
        return f"raised: {e}"
    return session.trace_kernels, skew_us(session.trace_path)


def condition(name, mode, tmp, before=None, lib=None):
    """TRACES traces back to back after before(): raw ones in ``mode``,
    ProfilingSession.trace's (mode "session"), or (mode "clock") the
    card's timer around idle gaps and in traces of k_stamp kernels."""
    if before is not None:
        before()
    if mode == "clock":
        out = {"condition": name, "mode": mode,
               "wall_less_monotonic_us": wall_less_monotonic_us(),
               "gaps": clock_gaps(lib),
               "traced": [traced_stamps(lib, tmp, m)
                          for m in (0.0, MARGIN_S)]}
        print(json.dumps(out), flush=True)
        return out
    out = {"condition": name, "mode": mode,
           "traces": [session_trace(tmp) if mode == "session"
                      else raw_trace(mode, tmp) for _ in range(TRACES)]}
    print(json.dumps(out), flush=True)
    return out


def child(code, *args):
    def run():
        r = subprocess.run([sys.executable, "-c", code, *args],
                           capture_output=True, text=True, timeout=300)
        if r.returncode:
            raise SystemExit(f"child failed: {r.stderr[-2000:]}")
    return run


def train():
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.models.segmentation import DefectSegmenter
    frames = scene.ring_frames(2, 96, 128, seed=4)
    seg = DefectSegmenter(base=16, device="cuda")
    for _ in range(2):
        seg.train_step(frames, frames[..., 1] < 60)
    torch.cuda.synchronize()


def main(argv=None) -> int:
    require_card()
    print(card(), flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "kineto_log_level": os.environ.get("KINETO_LOG_LEVEL"),
                      "teardown_cupti": os.environ.get("TEARDOWN_CUPTI")}),
          flush=True)
    befores = {
        "first_in_process": None,
        "after_cuda_child": child(CUDA_CHILD),
        "after_nccl_child": lambda: child(
            NCCL_CHILD, f"tcp://localhost:{_free_port()}")(),
        "after_train_steps": train,
    }
    results = []
    lib = stamp_library()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        for mode in argv or ("clock", "session") + MODES:
            for name, before in befores.items():
                if name != "first_in_process" or mode in ("clock", "lead",
                                                          MODES[0]):
                    results.append(condition(name, mode, tmp, before, lib))
    summary = {}
    for r in results:
        if r["mode"] == "clock":
            continue
        s = summary.setdefault(r["mode"], {"traces": 0, "lost": 0})
        s["traces"] += len(r["traces"])
        s["lost"] += sum(isinstance(t, str) or (len(t) == 4 and t[1] < 2)
                         for t in r["traces"])
    print(json.dumps({"summary": summary, "seconds": round(
        time.monotonic() - t0, 1),
        "wall_less_monotonic_us": wall_less_monotonic_us()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
