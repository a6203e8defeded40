#!/usr/bin/env python3
"""Real-time acquisition → card over the native ring buffer (port of
examples/realtime_processing.py).

A pinned native producer thread paces camera frames into the lock-free
ring; the consumer drains batches and runs the contamination detector on
the card (``--device cpu``: the plain path); latency and jitter
statistics print at the end.

Usage: python -m heimdall_tpu_torch.examples.realtime_processing
           [--device cuda|cpu] [--batches N]
"""

import argparse
import time

import numpy as np

from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.runtime.feeder import NativeCameraFeeder


def main(argv=None):
    """Runs the example; returns (frames processed, defects, ring stats)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    args = ap.parse_args(argv)

    feeder = NativeCameraFeeder(width=args.width, height=args.height,
                                fps=100, defect_probability=0.3,
                                capacity=64, cpu=1, rt_priority=10, seed=7)
    detector = ContaminationDetector(config={"include_contours": False,
                                             "use_color": False},
                                     device=args.device)
    batch_size = 8

    frames_done = 0
    with feeder:
        # warm up (the first call on the card builds the kernels) while
        # frames accumulate
        warm = np.zeros((batch_size, args.height, args.width), np.uint8)
        detector.detect_batch(warm)

        total_defects = 0
        t0 = time.time()
        for b in range(args.batches):
            batch = feeder.ring.pop_batch(batch_size, timeout_s=2.0)
            if len(batch) == 0:
                continue
            results = detector.detect_batch(batch)
            defects = sum(len(r) for r in results)
            total_defects += defects
            frames_done += len(batch)
            print(f"batch {b}: {len(batch)} frames, {defects} defects")
        elapsed = time.time() - t0

        stats = feeder.stats()
    print(f"\nprocessed {frames_done} frames in {elapsed:.2f}s")
    print(f"total defects: {total_defects}")
    print(f"ring stats: {stats}")
    return frames_done, total_defects, stats


if __name__ == "__main__":
    main()
