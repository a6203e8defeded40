"""Per-primitive cost on the card: the marginal microseconds of one step of
each primitive per frame (counterpart of scripts/microbench_vpu.py).

Protocol (the script's): each variant's kernel (ops/primitives.py) applies
its primitive N times to each of B planes with a data-dependent carry that
stays on chip; t(N) is the mean of REPS calls between two CUDA events after
one warm-up call, at N_LO and at N_HI, and the cost per step and frame is
(t(N_HI) - t(N_LO)) / (N_HI - N_LO) / B: loading the planes, storing row 0
and the launch cancel in the difference.  The planes are the script's
(RandomState(0), values in [0, 60)).

Prints the card's name and power limit, then one line per variant, on
stderr, and the JSON list [{"op", "dtype", "us_per_op"}] on stdout.  A
kernel that does not build or launch fails the run.

Usage: python -m heimdall_tpu_torch.scripts.microbench_vpu [quick] [only a,b]
"""

import json
import sys

import torch

from heimdall_tpu_torch.ops import primitives
from heimdall_tpu_torch.scripts import timing

H, W = primitives.H, primitives.W
B = primitives.B
N_LO, N_HI = 4, 36
REPS = 6            # timed calls per point


def time_call(x: torch.Tensor, name: str, iters: int) -> float:
    """Mean seconds of primitive_steps(x, name, iters) over REPS calls
    between two CUDA events, after one warm-up call."""
    primitives.primitive_steps(x, name, iters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        primitives.primitive_steps(x, name, iters)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS / 1e3


def us_per_op(t_lo: float, t_hi: float, batch: int) -> float:
    """Microseconds of one step per frame from the times (s) at N_LO and
    N_HI of a batch of ``batch`` frames."""
    return (t_hi - t_lo) / (N_HI - N_LO) / batch * 1e6


def parse(argv):
    """(quick, only) from ``[quick] [only a,b]``."""
    usage = __doc__.split("Usage: ")[1]
    only = None
    rest = list(argv)
    if "only" in rest:
        i = rest.index("only")
        if i + 1 >= len(rest):
            raise SystemExit(usage)
        only = set(rest[i + 1].split(","))
        del rest[i:i + 2]
    if any(a != "quick" for a in rest):
        raise SystemExit(usage)
    return "quick" in rest, only


def main(argv=None) -> list:
    """Runs the microbench; returns the results list."""
    quick, only = parse(sys.argv[1:] if argv is None else argv)
    timing.require_card()
    print(timing.card(), file=sys.stderr, flush=True)
    results = []
    for name, dtype, planes in primitives.inputs(quick, only, B):
        x = torch.from_numpy(planes).cuda()
        t_lo = time_call(x, name, N_LO)
        t_hi = time_call(x, name, N_HI)
        us = us_per_op(t_lo, t_hi, x.shape[0])
        print(f"{name:18s} {dtype:6s}  {us:8.3f} us/op/frame   "
              f"(lo {t_lo * 1e3:7.2f} ms, hi {t_hi * 1e3:7.2f} ms)",
              file=sys.stderr, flush=True)
        results.append(dict(op=name, dtype=dtype, us_per_op=us))
        del x
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
