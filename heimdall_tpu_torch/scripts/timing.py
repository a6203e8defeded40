"""What the port's profilers share: the bench batch on the card, stage
timing with CUDA events (also queued behind a spin kernel, so that only
the card's time counts), and the card's name and power limit.  The
profilers measure the card only: without one they exit with an error."""

import subprocess

import numpy as np
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.perf.profiling import MetricType

# Clock cycles of the spin kernel that queued_ms queues its runs behind
# (about 10 ms at the H100's 1980 MHz).
QUEUE_SPIN_CYCLES = 20_000_000


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def require_card():
    """Exits with an error where there is no CUDA device."""
    if not torch.cuda.is_available():
        raise SystemExit("the profilers time the card: no CUDA device "
                         "(torch.cuda.is_available() is false)")


def batch_and_iters(argv, usage: str):
    """(batch, iters) from ``[batch] [iters]`` (defaults 256 and 10)."""
    if len(argv) > 2 or any(not a.isdigit() for a in argv):
        raise SystemExit(usage)
    batch = int(argv[0]) if argv else 256
    iters = int(argv[1]) if len(argv) > 1 else 10
    return batch, iters


def bench_on_card(batch: int) -> torch.Tensor:
    """``batch`` 640x480 bench frames (heimdall_tpu_torch/scene.py, seed 0)
    as BGR planes [batch, 3, 480, 640] uint8 on the card."""
    require_card()
    frames = scene.make_frames(batch)
    return torch.from_numpy(
        np.ascontiguousarray(frames.transpose(0, 3, 1, 2))).cuda()


def time_stage(session, name: str, fn, batch: int, iters: int) -> float:
    """Microseconds per frame of fn() (one call on a batch of ``batch``
    frames): one warm-up call, then ``iters`` calls between two CUDA
    events on the current stream.  Printed, and recorded in ``session``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    us = start.elapsed_time(end) / iters / batch * 1e3
    print(f"{name:28s} {us:9.3f} us/frame", flush=True)
    session.record(MetricType.EXECUTION_TIME, name, us, "us/frame",
                   batch=batch, iters=iters)
    return us


def queued_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() over ``iters`` runs, timed with CUDA events
    on the card alone: a spin kernel (torch.cuda._sleep, about 10 ms) holds
    the stream while the host queues the runs, so that a wrapper whose host
    work outlasts its kernel is not timed by its host work."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
