"""Timing of the preprocess stages on the card (counterpart of
scripts/profile_preprocess.py).

On the bench scene (channel-major BGR, contrast 15), with CUDA events after
a warm-up, the label kernel stopped after each exact stage: gray; + the Q8
blur5; + the f32 mean11 and INV threshold; + open and close (full, the
label kernel's "pre").  Prints each time and the increments in us/frame,
and records each timing in a ProfilingSession.  (The JAX profiler's
"_roll" variants, with deliberately wrong borders, are TPU timing probes
and are not ported.)

Usage: python -m heimdall_tpu_torch.scripts.profile_preprocess [batch] [iters]
"""

import sys

from heimdall_tpu_torch.ops.split_kernels import label_kernel
from heimdall_tpu_torch.perf.profiling import ProfilingSession
from heimdall_tpu_torch.perf.reports import ReportFormat
from heimdall_tpu_torch.scripts import timing

CONTRAST = 15


def main(argv=None) -> dict:
    """Runs the profile; returns {stage: us/frame} (gray, blur5, mean11,
    pre)."""
    batch, iters = timing.batch_and_iters(
        sys.argv[1:] if argv is None else argv, __doc__.split("Usage: ")[1])
    x = timing.bench_on_card(batch)
    print(f"{timing.card()}  batch={batch} iters={iters}", flush=True)
    session = ProfilingSession("profile_preprocess", device=x.device)
    t = {s: timing.time_stage(session, "full (pre)" if s == "pre" else s,
                              lambda s=s: label_kernel(x, CONTRAST, s),
                              batch, iters)
         for s in ("gray", "blur5", "mean11", "pre")}
    print(f"\nincrements (us/frame): gray={t['gray']:.3f}  "
          f"blur5={t['blur5'] - t['gray']:.3f}  "
          f"mean11={t['mean11'] - t['blur5']:.3f}  "
          f"morph={t['pre'] - t['mean11']:.3f}", flush=True)
    print(session.report().render(ReportFormat.TEXT), flush=True)
    return t


if __name__ == "__main__":
    main()
