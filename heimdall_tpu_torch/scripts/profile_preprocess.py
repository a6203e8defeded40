"""Timing of the preprocess stages on the card (counterpart of
scripts/profile_preprocess.py).

On the bench scene (channel-major BGR, contrast 15), with CUDA events after
a warm-up, the label kernel stopped after each exact stage: gray; + the Q8
blur5; + the f32 mean11 and INV threshold; + open and close (full, the
label kernel's "pre"); and the "_roll" stages between them (blur5_roll,
mean11_roll, full_roll: the same correlations with wrap-around borders,
wrong near the edge by design, through ops/pre_variants.py::roll_stage).
Prints each time and the increments in us/frame, and records each timing in
a ProfilingSession.

Usage: python -m heimdall_tpu_torch.scripts.profile_preprocess [batch] [iters]
"""

import sys

from heimdall_tpu_torch.ops.pre_variants import roll_stage
from heimdall_tpu_torch.ops.split_kernels import label_kernel
from heimdall_tpu_torch.perf.profiling import ProfilingSession
from heimdall_tpu_torch.perf.reports import ReportFormat
from heimdall_tpu_torch.scripts import timing

CONTRAST = 15


def main(argv=None) -> dict:
    """Runs the profile; returns {stage: us/frame} (gray, blur5,
    blur5_roll, mean11, mean11_roll, pre, full_roll)."""
    batch, iters = timing.batch_and_iters(
        sys.argv[1:] if argv is None else argv, __doc__.split("Usage: ")[1])
    x = timing.bench_on_card(batch)
    print(f"{timing.card()}  batch={batch} iters={iters}", flush=True)
    session = ProfilingSession("profile_preprocess", device=x.device)
    t = {}
    for s in ("gray", "blur5", "blur5_roll", "mean11", "mean11_roll", "pre",
              "full_roll"):
        if s.endswith("_roll"):
            fn = (lambda s=s: roll_stage(x, CONTRAST, s))
        else:
            fn = (lambda s=s: label_kernel(x, CONTRAST, s))
        t[s] = timing.time_stage(session, "full (pre)" if s == "pre" else s,
                                 fn, batch, iters)
    print(f"\nincrements (us/frame): gray={t['gray']:.3f}  "
          f"blur5={t['blur5'] - t['gray']:.3f} "
          f"(roll {t['blur5_roll'] - t['gray']:.3f})  "
          f"mean11={t['mean11'] - t['blur5']:.3f} "
          f"(roll {t['mean11_roll'] - t['blur5_roll']:.3f})  "
          f"morph={t['pre'] - t['mean11']:.3f} "
          f"(roll {t['full_roll'] - t['mean11_roll']:.3f})", flush=True)
    print(session.report().render(ReportFormat.TEXT), flush=True)
    return t


if __name__ == "__main__":
    main()
