#!/usr/bin/env python3
"""Capture frames from a (simulated) camera and print frame stats (port of
examples/camera_capture.py; the camera HAL runs on the host, so no device
is involved).

Usage: python -m heimdall_tpu_torch.examples.camera_capture
"""

import time

from heimdall_tpu_torch.camera.hal import CameraFactory


def main(n: int = 30):
    """Acquires n frames (JAX's 30) and prints each one's stats and the
    rate; returns the frames' (frame_id, shape, mean, min, max)."""
    camera = CameraFactory.create("simulator", "demo_cam",
                                  {"width": 640, "height": 480, "fps": 60})
    camera.initialize()
    camera.start_acquisition()
    print(f"camera: {camera.info()}")

    stats = []
    start = time.time()
    for i in range(n):
        frame = camera.acquire_frame()
        img = frame.to_ndarray()
        print(f"frame {frame.frame_id}: shape={img.shape} "
              f"mean={img.mean():.1f} min={img.min()} max={img.max()}")
        stats.append((frame.frame_id, img.shape, float(img.mean()),
                      int(img.min()), int(img.max())))
    elapsed = time.time() - start
    camera.stop_acquisition()
    print(f"{n} frames in {elapsed:.2f}s = {n/elapsed:.1f} fps")
    return stats


if __name__ == "__main__":
    main()
