"""Profiling-session demo: per-stage timings + system metrics + reports
(counterpart of examples/performance_analysis.py).

A ProfilingSession wraps a simulated 640x480 Mono8 camera and the port's
ContaminationDetector.detect_batch (batches of 8, host clock around each
call, which ends with the table's download) and produces the report in
TEXT and MARKDOWN, plus a JSON report saved by the ProfilingManager.  Runs
on the card unless ``--device cpu`` is given (the plain PyTorch path).

Usage: python -m heimdall_tpu_torch.examples.performance_analysis
           [--device cuda|cpu] [--batches N] [--output-dir DIR]
"""

import argparse

import numpy as np

from heimdall_tpu_torch.camera.hal import CameraFactory
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.perf.profiling import ProfilingManager
from heimdall_tpu_torch.perf.reports import ReportFormat

BATCH = 8


def main(argv=None):
    """Runs the demo; returns (report, path of the saved JSON report)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--output-dir", default="reports")
    args = ap.parse_args(argv)

    detector = ContaminationDetector(config={"include_contours": False,
                                             "use_color": False},
                                     device=args.device)
    manager = ProfilingManager(output_dir=args.output_dir)
    session = manager.start_session("performance_analysis",
                                    device=detector.device)

    camera = CameraFactory.create("simulator", "perf_cam",
                                  {"width": 640, "height": 480, "fps": 500})
    camera.initialize()
    camera.start_acquisition()

    # warm-up: the first call on the card builds the kernels
    with session.timing("warmup"):
        detector.detect_batch(np.zeros((BATCH, 480, 640), np.uint8))

    for _ in range(args.batches):
        with session.timing("acquire_batch"):
            frames = np.stack(
                [camera.acquire_frame().to_ndarray() for _ in range(BATCH)])
        with session.timing("detect_batch"):
            results = detector.detect_batch(frames)
        session.increment("frames", len(frames))
        session.increment("defects", sum(len(r) for r in results))
        session.sample_system()

    camera.stop_acquisition()

    report = session.report()
    print(report.render(ReportFormat.TEXT))
    print()
    print(report.render(ReportFormat.MARKDOWN))
    path = manager.end_session("performance_analysis")
    print(f"\nJSON report saved to {path}", flush=True)
    return report, path


if __name__ == "__main__":
    main()
