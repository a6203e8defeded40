"""The preprocess, the union-find fill and the labeling with one
ingredient swapped, timed on the card (counterpart of
scripts/profile_ccl_variants.py).

On the bench scene (channel-major BGR, contrast 15), with CUDA events after
a warm-up, ops/ccl_sweeps.py's ccl_variant for each of its fifteen variants
(the label kernel's "fill" stage, then the sweep CCL with one knob swapped,
or the run tables at R runs per row), and beside them the label kernel's
union-find "ccl" stage, the same function.  Every variant but fixed2 must
equal the union-find labels exactly (the run fails otherwise); fixed2 is a
timing probe, and the number of frames it leaves short of their labels is
printed.  Prints each time in us/frame and the frames that took the run
tables at each R, and records each timing in a ProfilingSession.

Usage: python -m heimdall_tpu_torch.scripts.profile_ccl_variants [batch] [iters]
"""

import sys

import torch

from heimdall_tpu_torch.ops.ccl_sweeps import (RUNTABLE_VARIANTS, VARIANTS,
                                               ccl_runtable, ccl_variant)
from heimdall_tpu_torch.ops.split_kernels import label_kernel
from heimdall_tpu_torch.perf.profiling import ProfilingSession
from heimdall_tpu_torch.perf.reports import ReportFormat
from heimdall_tpu_torch.scripts import timing

CONTRAST = 15


def main(argv=None):
    """Runs the profile; returns ({variant: us/frame, and the union-find
    "ccl" stage's as "union_find"}, the frames fixed2 leaves short, {R:
    frames on the run tables})."""
    batch, iters = timing.batch_and_iters(
        sys.argv[1:] if argv is None else argv, __doc__.split("Usage: ")[1])
    x = timing.bench_on_card(batch)
    print(f"{timing.card()}  batch={batch} iters={iters}", flush=True)
    session = ProfilingSession("profile_ccl_variants", device=x.device)
    ref = label_kernel(x, CONTRAST)
    t, short = {}, 0
    for name in VARIANTS:
        got = ccl_variant(x, CONTRAST, name)
        if name == "fixed2":
            short = int((got != ref).flatten(1).any(1).sum())
        elif not torch.equal(got, ref):
            raise RuntimeError(f"{name}'s labels differ from the union-find "
                               f"labels")
        t[name] = timing.time_stage(
            session, name, lambda name=name: ccl_variant(x, CONTRAST, name),
            batch, iters)
    t["union_find"] = timing.time_stage(
        session, "union-find ccl (label_kernel)",
        lambda: label_kernel(x, CONTRAST), batch, iters)
    filled = label_kernel(x, CONTRAST, "fill")
    fits = {r: int(ccl_runtable(filled, r)[1].sum())
            for r in sorted(set(RUNTABLE_VARIANTS.values()), reverse=True)}
    print(f"fixed2 leaves {short} of {batch} frames short of their labels; "
          f"frames on the run tables by R: {fits}", flush=True)
    print(session.report().render(ReportFormat.TEXT), flush=True)
    return t, short, fits


if __name__ == "__main__":
    main()
