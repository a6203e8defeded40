#!/usr/bin/env python3
"""End-to-end contamination demo: deterministic defects -> inspect -> save
(port of examples/test_contamination.py; the inspector runs on the card
unless ``--device cpu``).

Synthetic bottles with two deterministic dark-circle contaminations go
through the ContaminationInspector; the original, processed and
visualization images are written to results/ (or ``--output-dir``),
viewable with ``python -m heimdall_tpu_torch.serving.web_viewer``, and
summary stats are printed.

Usage: python -m heimdall_tpu_torch.examples.test_contamination
           [--device cpu] [--output-dir DIR]
"""

import argparse
import os

import numpy as np

from heimdall_tpu_torch.inspection.contamination_inspector import (
    ContaminationInspector)
from heimdall_tpu_torch.utils import draw


def add_artificial_contamination(image, seed):
    """Two dark circles at (w/4, h/2) and (3w/4, h/2), like the reference
    (test_contamination.py:36-51)."""
    rng = np.random.RandomState(seed)
    h, w = image.shape[:2]
    for x in (w // 4, 3 * w // 4):
        radius = rng.randint(15, 30)
        shade = int(rng.randint(0, 60))
        draw.filled_circle(image, (x, h // 2), radius,
                           (shade, shade, shade))
    return image


def make_bottle(width=640, height=480):
    img = np.full((height, width, 3), 220, np.uint8)
    cx, cy = width // 2, height // 2
    bw, bh = min(width, height) // 3, min(width, height) // 2
    draw.rect_outline(img, (cx - bw // 2, cy - bh // 2),
                      (cx + bw // 2, cy + bh // 2), (100, 100, 100), 2)
    draw.filled_circle(img, (cx, cy + bh // 2 - 20), bw // 2 - 5,
                       (80, 80, 80))
    return img


def save(path, image):
    try:
        import cv2
        cv2.imwrite(path, image)
    except ImportError:
        np.save(path + ".npy", image)
    return True


def main(argv=None):
    """Inspects 3 bottles; returns their InspectionResults."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain path")
    ap.add_argument("--output-dir", default="results")
    args = ap.parse_args(argv)
    out_dir = args.output_dir

    inspector = ContaminationInspector("demo", device=args.device)
    os.makedirs(out_dir, exist_ok=True)
    total_defects = 0
    results = []
    for i in range(1, 4):
        image = add_artificial_contamination(make_bottle(), seed=i)
        result = inspector.inspect(image)
        print(f"inspection {i}: success={result.success} "
              f"defects={result.defect_count} "
              f"time={result.processing_time*1000:.1f} ms")
        for d in result.defects:
            print(f"  {d}")
        total_defects += result.defect_count
        for kind in ("original", "processed", "visualization"):
            save(os.path.join(out_dir, f"{kind}_{i}.jpg"),
                 result.images[kind])
        results.append(result)
    print(f"\ntotal: {total_defects} defects in 3 inspections "
          f"(expected 2 per frame)")
    print(f"view results: python -m heimdall_tpu_torch.serving.web_viewer "
          f"-d {out_dir}")
    return results


if __name__ == "__main__":
    main()
