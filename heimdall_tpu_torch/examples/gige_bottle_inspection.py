#!/usr/bin/env python3
"""Multi-camera synchronized inspection line (port of
examples/gige_bottle_inspection.py).

Equivalent of rust/examples/gige_bottle_inspection.rs: discover simulated
GigE cameras, acquire synchronized FrameSets, run each set as one batch
through the contamination detector on the card (``--device cpu``: the
plain path), print per-set verdicts and diagnostics.

Usage: python -m heimdall_tpu_torch.examples.gige_bottle_inspection
           [--device cuda|cpu] [--triggers N]
"""

import argparse

from heimdall_tpu_torch.camera.gige import GigESystem, SyncMode
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)


def main(argv=None):
    """Runs the example; returns (per-trigger verdicts, diagnostics)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--triggers", type=int, default=5)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    args = ap.parse_args(argv)

    system = GigESystem(backend="simulator", sync_mode=SyncMode.SOFTWARE)
    for i in range(4):
        system.add_camera(f"cam_{i}", {"width": args.width,
                                       "height": args.height, "fps": 1000})
    system.configure()
    system.start()

    detector = ContaminationDetector(config={"include_contours": False,
                                             "use_color": False},
                                     device=args.device)
    all_verdicts = []
    try:
        for trigger in range(args.triggers):
            frameset = system.acquire_frames()
            batch = frameset.to_batch()             # [4, H, W]
            results = detector.detect_batch(batch)
            verdicts = ["REJECT" if d else "pass" for d in results]
            all_verdicts.append(verdicts)
            print(f"trigger {trigger}: frame_id={frameset.frame_id} "
                  f"verdicts={verdicts}")
    finally:
        system.stop()

    print("\ndiagnostics:")
    system.start()
    diag = system.diagnostics()
    for key, value in diag.items():
        print(f"  {key}: {value}")
    system.stop()
    return all_verdicts, diag


if __name__ == "__main__":
    main()
