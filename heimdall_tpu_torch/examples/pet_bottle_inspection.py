#!/usr/bin/env python3
"""Full PET-bottle inspection cell: lighting + cameras + detection on the
card (port of examples/pet_bottle_inspection.py).

Equivalent of the reference's flagship lighting example
(rust/heimdall-lighting/examples/pet_bottle_inspection.rs:30-532): three
inspection points (preform / body / base) each with a lighting recipe,
auto-intensity calibration, synchronized strobe-per-trigger acquisition,
and a final health/diagnostics pass.  Detection runs on the card
(``--device cpu``: the plain path).

Usage: python -m heimdall_tpu_torch.examples.pet_bottle_inspection
           [--device cuda|cpu]
"""

import argparse

import numpy as np

from heimdall_tpu_torch.camera.hal import CameraFactory
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.lighting import (
    AdvancedAutoIntensityAdjuster, IntensityAlgorithm,
    LightingControllerFactory, LightingSynchronizer, SyncEvent)
from heimdall_tpu_torch.lighting.monitoring import (AlertManager,
                                                    LightingMonitor)
from heimdall_tpu_torch.lighting.sync import compute_strobe_timing

POINTS = {
    "preform": {"lighting": "backlight", "exposure_us": 500,
                "target_brightness": 140},
    "body": {"lighting": "diffuse", "exposure_us": 2000,
             "target_brightness": 128},
    "base": {"lighting": "coaxial", "exposure_us": 1500,
             "target_brightness": 120},
}


def main(argv=None):
    """Runs the cell; returns {point: (calibrated intensity, defects)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    args = ap.parse_args(argv)

    detector = ContaminationDetector(config={"include_contours": False,
                                             "use_color": False},
                                     device=args.device)
    alerts = AlertManager()
    alerts.register_callback(
        lambda a: print(f"  [ALERT {a.level.value}] {a.message}"))

    summary = {}
    for name, recipe in POINTS.items():
        print(f"\n=== inspection point: {name} ({recipe['lighting']}) ===")
        ctrl = LightingControllerFactory.create("simulator", f"light_{name}")
        ctrl.initialize()
        ctrl.set_intensity(0, 0.5)

        # strobe timing vs exposure
        timing = compute_strobe_timing(recipe["exposure_us"])
        print(f"strobe: delay={timing.delay_us:.0f}us "
              f"duration={timing.duration_us:.0f}us")

        # auto-intensity calibration against a simulated plant
        adjuster = AdvancedAutoIntensityAdjuster(
            ctrl, 0, target_brightness=recipe["target_brightness"],
            algorithm=IntensityAlgorithm.PID)
        final = adjuster.calibrate(
            lambda: 255 * ctrl.get_channel_state(0).intensity, max_iters=60)
        print(f"calibrated intensity: {final:.3f}")

        # synchronized acquisition + detection
        camera = CameraFactory.create("simulator", f"cam_{name}",
                                      {"width": args.width,
                                       "height": args.height, "fps": 1000})
        camera.initialize()
        camera.start_acquisition()
        sync = LightingSynchronizer(ctrl,
                                    strobe_duration_us=timing.duration_us)
        sync.start()
        monitor = LightingMonitor(ctrl, alert_manager=alerts)
        frames = []
        for _ in range(5):
            sync.send_event(SyncEvent.CAMERA_TRIGGER)
            frame = camera.acquire_frame().to_ndarray()
            frames.append(frame)
            monitor.record(frame.mean())
        sync.stop()
        camera.stop_acquisition()

        results = detector.detect_batch(np.stack(frames))
        defects = sum(len(r) for r in results)
        summary[name] = (final, defects)
        print(f"inspected {len(frames)} frames: {defects} defects")
        print(f"sync stats: {sync.stats()}")
        print(f"health: {monitor.health_report()['controller']}")
    return summary


if __name__ == "__main__":
    main()
