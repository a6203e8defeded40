#!/usr/bin/env python3
"""A/B benchmark harness: the card vs the native C++ scalar path vs
(optional) OpenCV (port of benchmark.py, the human-facing A/B tool).

The reference's arguments (-i/-t/-f, and -b for the batch) and its three
sections: contamination detection (single frame, and batched with the
frames already on the card, beside native_bridge.benchmark_processing and
OpenCV's own recipe), the preprocessing pipelines, and 4-camera
acquisition against its 5 ms gate.  The card's times end in
torch.cuda.synchronize() (a single-frame detect ends in its table's
download).  It prints no JSON metric line: no benchmark reads it.  The
harness measures the card only: without one it exits with an error.

Usage: python -m heimdall_tpu_torch.scripts.ab_benchmark [-i N]
           [-t detection|processing|acquisition|all] [-f IMAGE] [-b N]
"""

import argparse
import sys
import time

import numpy as np


def make_image(width=640, height=480, n_defects=2, seed=0):
    from heimdall_tpu_torch.utils import draw
    rng = np.random.RandomState(seed)
    img = np.full((height, width, 3), 220, np.uint8)
    draw.filled_circle(img, (width // 2, height // 2 + 100), 95,
                       (80, 80, 80))
    for _ in range(n_defects):
        x = rng.randint(width // 4, 3 * width // 4)
        y = rng.randint(height // 4, 3 * height // 4)
        r = rng.randint(5, 15)
        draw.filled_circle(img, (x, y), r, (30, 30, 30))
    return img


# The reference recipe in straight OpenCV (a copy of the oracle of the JAX
# package's detector parity test).
def cv2_oracle(image, min_size=10, max_size=3000, contrast=15,
               min_conf=0.25, use_color=True):
    """The reference algorithm, straight OpenCV (blob-level oracle)."""
    import cv2
    original = image
    gray = (cv2.cvtColor(image, cv2.COLOR_BGR2GRAY) if image.ndim == 3
            else image)
    blurred = cv2.GaussianBlur(gray, (5, 5), 0)
    binary = cv2.adaptiveThreshold(blurred, 255,
                                   cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                   cv2.THRESH_BINARY_INV, 11, contrast)
    kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (3, 3))
    binary = cv2.morphologyEx(binary, cv2.MORPH_OPEN, kernel)
    binary = cv2.morphologyEx(binary, cv2.MORPH_CLOSE, kernel)
    contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    out = []
    for contour in contours:
        area = cv2.contourArea(contour)
        if area < min_size or area > max_size:
            continue
        mask = np.zeros_like(gray)
        cv2.drawContours(mask, [contour], 0, 255, -1)
        x, y, w, h = cv2.boundingRect(contour)
        M = cv2.moments(contour)
        if M["m00"] <= 0:
            continue
        cx, cy = int(M["m10"] / M["m00"]), int(M["m01"] / M["m00"])
        roi = gray[y:y + h, x:x + w]
        roi_mask = mask[y:y + h, x:x + w]
        bg = np.mean(roi[roi_mask == 0]) if np.any(roi_mask == 0) else 127
        fg = np.mean(roi[roi_mask == 255]) if np.any(roi_mask == 255) else 127
        intensity_diff = abs(bg - fg)
        intensity_score = min(1.0, intensity_diff / 30.0)
        rect_area = w * h
        shape_score = 1.0 - (area / rect_area if rect_area > 0 else 0)
        color_score = 0.5
        if use_color and original.ndim == 3:
            diffs = []
            for ch in cv2.split(original[y:y + h, x:x + w]):
                fg_px, bg_px = ch[roi_mask == 255], ch[roi_mask == 0]
                cfg = np.mean(fg_px) if fg_px.size else 127
                cbg = np.mean(bg_px) if bg_px.size else 127
                diffs.append(abs(cfg - cbg))
            color_score = min(1.0, max(diffs) / 30.0)
        confidence = (0.5 * intensity_score + 0.2 * shape_score
                      + 0.3 * color_score)
        if confidence >= min_conf:
            out.append({"pos": (cx, cy), "area": area, "conf": confidence,
                        "bbox": (x, y, w, h)})
    return out


def benchmark_contamination_detection(iterations: int, image: np.ndarray,
                                      batch: int = 8) -> None:
    print("=== contamination detection ===")
    import torch

    from heimdall_tpu_torch import native_bridge
    from heimdall_tpu_torch.detectors.contamination_detector import (
        ContaminationDetector)

    det = ContaminationDetector(config={"include_contours": False},
                                device="cuda")
    det.detect(image)  # warm-up: the first call builds the kernels
    start = time.perf_counter()
    for _ in range(iterations):
        defects = det.detect(image)     # ends in its table's download
    gpu_single = (time.perf_counter() - start) / iterations
    print(f"GPU single-frame:  {gpu_single*1000:8.2f} ms/frame "
          f"({len(defects)} defects)")

    # sustained throughput: the batch already on the card, the calls
    # queued back to back and waited for once
    frames = torch.from_numpy(np.stack([image] * batch)).cuda()
    det.run_device(frames)
    torch.cuda.synchronize()
    iters_b = max(iterations, 8)
    start = time.perf_counter()
    for _ in range(iters_b):
        det.run_device(frames)
    torch.cuda.synchronize()
    gpu_batch = (time.perf_counter() - start) / iters_b / batch
    print(f"GPU batched (N={batch}, pipelined): "
          f"{gpu_batch*1000:8.2f} ms/frame")

    if native_bridge.is_available():
        out = native_bridge.benchmark_processing(image,
                                                 iterations=iterations,
                                                 device="cuda")
        native_ms = out.get("native_ms_per_frame")
        if native_ms:
            print(f"Native C++ scalar: {native_ms:8.2f} ms/frame")
            print(f"GPU-batched speedup vs native: "
                  f"{native_ms / (gpu_batch*1000):.1f}x")

    try:
        cv2_oracle(image)
    except ImportError:
        return
    start = time.perf_counter()
    for _ in range(iterations):
        cv2_oracle(image)
    cv_ms = (time.perf_counter() - start) / iterations * 1000
    print(f"OpenCV reference:  {cv_ms:8.2f} ms/frame")
    print(f"GPU-batched speedup vs OpenCV: {cv_ms/(gpu_batch*1000):.1f}x")


def benchmark_image_processing(iterations: int, image: np.ndarray) -> None:
    print("=== preprocessing pipelines ===")
    from heimdall_tpu_torch.core.pipeline import PipelineFactory
    for ptype in ("basic", "contamination"):
        pipe = PipelineFactory.create_pipeline("bench", ptype, device="cuda")
        pipe.process_batch(image[None])  # warm-up; ends in its download
        start = time.perf_counter()
        for _ in range(iterations):
            pipe.process_batch(image[None])
        ms = (time.perf_counter() - start) / iterations * 1000
        print(f"{ptype:>14s}: {ms:8.2f} ms/frame")


def benchmark_acquisition(iterations: int) -> None:
    """Per-SyncMode multi-camera acquisition timing (the reference's
    criterion scenarios, gige/benches/acquisition_bench.rs:11-88)."""
    print("=== acquisition (4 simulated cameras) ===")
    from heimdall_tpu_torch.camera.gige import GigESystem, SyncMode
    for mode in (SyncMode.SOFTWARE, SyncMode.HARDWARE, SyncMode.FREERUN):
        system = GigESystem(backend="simulator", sync_mode=mode)
        for i in range(4):
            system.add_camera(f"cam_{i}", {"width": 640, "height": 480,
                                           "fps": 10_000,
                                           "pattern": "bottle"})
        system.configure()
        system.start()
        system.acquire_frames(timeout_s=5.0)  # warm
        start = time.perf_counter()
        for _ in range(iterations):
            system.acquire_frames(timeout_s=5.0)
        ms = (time.perf_counter() - start) / iterations * 1000
        system.stop()
        print(f"{mode:>10s}: {ms:8.2f} ms/frameset "
              f"({'PASS' if ms <= 5.0 else 'over'} the 5 ms gate)")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Heimdall A/B benchmark on the card")
    parser.add_argument("-i", "--iterations", type=int, default=10)
    parser.add_argument("-t", "--test",
                        choices=["detection", "processing", "acquisition",
                                 "all"], default="all")
    parser.add_argument("-f", "--file", type=str,
                        help="benchmark this image instead of synthetic")
    parser.add_argument("-b", "--batch", type=int, default=8)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from heimdall_tpu_torch.scripts import timing
    timing.require_card()
    print(timing.card(), flush=True)

    if args.file:
        import cv2
        image = cv2.imread(args.file)
        if image is None:
            print(f"cannot read {args.file}", file=sys.stderr)
            return 1
    else:
        image = make_image()

    if args.test in ("detection", "all"):
        benchmark_contamination_detection(args.iterations, image,
                                          args.batch)
    if args.test in ("processing", "all"):
        benchmark_image_processing(args.iterations, image)
    if args.test in ("acquisition", "all"):
        benchmark_acquisition(args.iterations)
    return 0


if __name__ == "__main__":
    sys.exit(main())
