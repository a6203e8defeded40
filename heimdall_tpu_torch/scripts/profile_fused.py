"""Stage-by-stage timing of the 640x480 detect on the card (counterpart of
scripts/profile_fused.py).

On the bench scene (channel-major BGR, contrast 15, K = 64), with CUDA
events after a warm-up: the label kernel stopped after the preprocess,
after the hole fill, and whole (pre, pre+fill, pre+fill+ccl = B6b); the
stats kernel (B6a) on B6b's labels; and the full fused detect (B1 + table +
gates).  Prints each time and the breakdown pre / fill / ccl / stats / glue
(glue = full - ccl - stats: what B1 and the table save or cost over the
split) in us/frame, and records each timing in a ProfilingSession.

Usage: python -m heimdall_tpu_torch.scripts.profile_fused [batch] [iters]
"""

import sys

from heimdall_tpu_torch.ops.fused_kernels import fused_detect
from heimdall_tpu_torch.ops.split_kernels import label_kernel, stats_kernel
from heimdall_tpu_torch.perf.profiling import ProfilingSession
from heimdall_tpu_torch.perf.reports import ReportFormat
from heimdall_tpu_torch.scripts import timing

CONTRAST = 15
K = 64


def main(argv=None) -> dict:
    """Runs the profile; returns {stage: us/frame} (pre, fill, ccl, stats,
    full)."""
    batch, iters = timing.batch_and_iters(
        sys.argv[1:] if argv is None else argv, __doc__.split("Usage: ")[1])
    x = timing.bench_on_card(batch)
    print(f"{timing.card()}  batch={batch} iters={iters}", flush=True)
    session = ProfilingSession("profile_fused", device=x.device)

    def stage(name, fn):
        return timing.time_stage(session, name, fn, batch, iters)

    t = {}
    for s, name in (("pre", "preprocess only"),
                    ("fill", "pre+fill"),
                    ("ccl", "pre+fill+ccl (=B6b)")):
        t[s] = stage(name, lambda s=s: label_kernel(x, CONTRAST, s))
    labels = label_kernel(x, CONTRAST)
    t["stats"] = stage("stats (B6a)", lambda: stats_kernel(x, labels, K))
    t["full"] = stage("full detect (B1+table+gates)",
                      lambda: fused_detect(x, CONTRAST, 10.0, 3000.0, 0.25,
                                           max_blobs=K, channel_major=True))
    print(f"\nbreakdown: pre={t['pre']:.3f}  fill={t['fill'] - t['pre']:.3f}  "
          f"ccl={t['ccl'] - t['fill']:.3f}  stats={t['stats']:.3f}  "
          f"glue={t['full'] - t['ccl'] - t['stats']:.3f}  (us/frame)",
          flush=True)
    print(session.report().render(ReportFormat.TEXT), flush=True)
    return t


if __name__ == "__main__":
    main()
