"""The classic labeling (sweep fill, then sweep CCL) against the joint
fixpoint with ladder variants, and the full detect with each, timed on the
card (counterpart of scripts/profile_joint_variants.py).

On the bench scene (channel-major BGR, contrast 15), with CUDA events after
a warm-up: ops/joint_label.py's classic_label (the label kernel's "pre"
stage, fill_sweeps "new", ccl_mask "cur"), joint_label for each of its four
variants, and beside them the label kernel's union-find fill and labels
("ccl" stage); then the full detect: fused_detect against joint_detect
(joint labels -> stats kernel -> table -> gates).  Every labeling must give
the union-find labels and filled mask, and the two detects equal accepted
gates (the run fails otherwise).  Prints each time in us/frame and records
each timing in a ProfilingSession.

Usage: python -m heimdall_tpu_torch.scripts.profile_joint_variants [batch] [iters]
"""

import sys

import torch

from heimdall_tpu_torch.ops.fused_kernels import fused_detect
from heimdall_tpu_torch.ops.joint_label import (VARIANTS, classic_label,
                                                joint_detect, joint_label)
from heimdall_tpu_torch.ops.split_kernels import label_kernel
from heimdall_tpu_torch.perf.profiling import ProfilingSession
from heimdall_tpu_torch.perf.reports import ReportFormat
from heimdall_tpu_torch.scripts import timing

CONTRAST = 15
GATES = (10.0, 3000.0, 0.25)     # min size, max size, min confidence
K = 64


def main(argv=None) -> dict:
    """Runs the profile; returns {labeling: us/frame} ("classic", each
    variant, "union_find"; "detect_classic" and "detect_joint")."""
    batch, iters = timing.batch_and_iters(
        sys.argv[1:] if argv is None else argv, __doc__.split("Usage: ")[1])
    x = timing.bench_on_card(batch)
    print(f"{timing.card()}  batch={batch} iters={iters}", flush=True)
    session = ProfilingSession("profile_joint_variants", device=x.device)
    ref = (label_kernel(x, CONTRAST), label_kernel(x, CONTRAST, "fill"))
    runs = {"classic": lambda: classic_label(x, CONTRAST)}
    for name in VARIANTS:
        runs[name] = lambda name=name: joint_label(x, CONTRAST, name)
    t = {}
    for name, fn in runs.items():
        if not all(torch.equal(a, b) for a, b in zip(fn(), ref)):
            raise RuntimeError(f"{name}'s labels or filled mask differ from "
                               f"the union-find ones")
        t[name] = timing.time_stage(session, name, fn, batch, iters)
        if name != "classic":
            print(f"    vs classic: {t[name] - t['classic']:+.3f} us/frame",
                  flush=True)
    t["union_find"] = timing.time_stage(
        session, "union-find fill + ccl (label_kernel)",
        lambda: label_kernel(x, CONTRAST), batch, iters)

    def classic():
        return fused_detect(x, CONTRAST, *GATES, K, channel_major=True)

    def joint():
        return joint_detect(x, CONTRAST, *GATES, K)

    if not torch.equal(classic()[2], joint()[2]):
        raise RuntimeError("the joint detect's accepted gates differ from "
                           "the fused detect's")
    t["detect_classic"] = timing.time_stage(session, "full detect classic",
                                            classic, batch, iters)
    t["detect_joint"] = timing.time_stage(
        session, "full detect joint [accepted==]", joint, batch, iters)
    print(f"full detect: classic {t['detect_classic']:.3f} vs joint "
          f"{t['detect_joint']:.3f} us/frame "
          f"({t['detect_joint'] - t['detect_classic']:+.3f})", flush=True)
    print(session.report().render(ReportFormat.TEXT), flush=True)
    return t


if __name__ == "__main__":
    main()
