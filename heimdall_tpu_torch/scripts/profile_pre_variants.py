"""The preprocess with one ingredient swapped, timed on the card
(counterpart of scripts/profile_pre_variants.py).

On the bench scene (channel-major BGR, contrast 15), with CUDA events after
a warm-up, the "pre" plane of each variant of ops/pre_variants.py: cur (the
exact preprocess), roll_conv (unchecked interior reads, exact border band),
pair_sym (paired Q8 taps), roll_pair (both) and mxu_conv (paired blur, the
f32 mean11 as banded tensor-core products).  Every variant but mxu_conv
must equal cur exactly (the run fails otherwise); mxu_conv rounds its mean
otherwise, and its threshold flips against cur are printed, not asserted.
Prints each time in us/frame and records each timing in a
ProfilingSession.

Usage: python -m heimdall_tpu_torch.scripts.profile_pre_variants [batch] [iters]
"""

import sys

import torch

from heimdall_tpu_torch.ops.pre_variants import VARIANTS, pre_variant
from heimdall_tpu_torch.perf.profiling import ProfilingSession
from heimdall_tpu_torch.perf.reports import ReportFormat
from heimdall_tpu_torch.scripts import timing

CONTRAST = 15


def main(argv=None):
    """Runs the profile; returns ({variant: us/frame}, mxu_conv's pixels
    that differ from cur)."""
    batch, iters = timing.batch_and_iters(
        sys.argv[1:] if argv is None else argv, __doc__.split("Usage: ")[1])
    x = timing.bench_on_card(batch)
    print(f"{timing.card()}  batch={batch} iters={iters}", flush=True)
    session = ProfilingSession("profile_pre_variants", device=x.device)
    ref = pre_variant(x, CONTRAST, "cur")        # the card's warm-up
    for _ in range(iters):
        pre_variant(x, CONTRAST, "cur")
    t, flips = {}, 0
    for name in VARIANTS:
        got = pre_variant(x, CONTRAST, name)
        if name == "mxu_conv":
            flips = int((got != ref).sum())
            print(f"mxu_conv binary flips vs cur: {flips} "
                  f"({flips / got.numel():.2e}/px over {batch} frames)",
                  flush=True)
            session.increment("mxu_conv_flips", flips)
        elif not torch.equal(got, ref):
            raise RuntimeError(f"{name}'s pre plane differs from cur's")
        t[name] = timing.time_stage(
            session, name, lambda name=name: pre_variant(x, CONTRAST, name),
            batch, iters)
    print(session.report().render(ReportFormat.TEXT), flush=True)
    return t, flips


if __name__ == "__main__":
    main()
