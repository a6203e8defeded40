"""The preprocess and the sweep hole fill with one ingredient swapped,
timed on the card (counterpart of scripts/profile_fill_variants.py).

On the bench scene (channel-major BGR, contrast 15), with CUDA events after
a warm-up, ops/fill_sweeps.py's fill_sweeps for each of its nine variants
(pack, scan, grow, guard) and the fill alone (fill_mask on the label
kernel's "pre" plane), each with the (grow, guard) instance of
csrc/fill_sweeps.cu that it runs, and beside them the label kernel's
union-find "fill" stage, the same function.  Every variant must equal the
union-find fill exactly (the run fails otherwise).  Prints each time in
us/frame and records each timing in a ProfilingSession.

Usage: python -m heimdall_tpu_torch.scripts.profile_fill_variants [batch] [iters]
"""

import sys

import torch

from heimdall_tpu_torch.ops.fill_sweeps import (INSTANCES, VARIANTS,
                                                 fill_mask, fill_sweeps)
from heimdall_tpu_torch.ops.split_kernels import label_kernel
from heimdall_tpu_torch.perf.profiling import ProfilingSession
from heimdall_tpu_torch.perf.reports import ReportFormat
from heimdall_tpu_torch.scripts import timing

CONTRAST = 15


def main(argv=None):
    """Runs the profile; returns ({variant: us/frame of the probe, and the
    union-find fill stage's as "union_find"}, {variant: us/frame of the
    fill alone})."""
    batch, iters = timing.batch_and_iters(
        sys.argv[1:] if argv is None else argv, __doc__.split("Usage: ")[1])
    x = timing.bench_on_card(batch)
    print(f"{timing.card()}  batch={batch} iters={iters}", flush=True)
    session = ProfilingSession("profile_fill_variants", device=x.device)
    ref = label_kernel(x, CONTRAST, "fill")
    pre = label_kernel(x, CONTRAST, "pre")
    t, alone = {}, {}
    for name in VARIANTS:
        if not torch.equal(fill_sweeps(x, CONTRAST, name), ref):
            raise RuntimeError(f"{name}'s filled plane differs from the "
                               f"union-find fill's")
        print(f"{name}: instance {fill_mask.instance}", flush=True)
        t[name] = timing.time_stage(
            session, name, lambda name=name: fill_sweeps(x, CONTRAST, name),
            batch, iters)
        alone[name] = timing.time_stage(
            session, f"{name} alone ({INSTANCES[name]})",
            lambda name=name: fill_mask(pre, name), batch, iters)
    t["union_find"] = timing.time_stage(
        session, "union-find fill (label_kernel)",
        lambda: label_kernel(x, CONTRAST, "fill"), batch, iters)
    print(session.report().render(ReportFormat.TEXT), flush=True)
    return t, alone


if __name__ == "__main__":
    main()
