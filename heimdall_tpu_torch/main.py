#!/usr/bin/env python3
"""Heimdall command-line entry point on PyTorch/CUDA (port of
heimdall_tpu/main.py).

API-compatible with the reference CLI (heimdall/main.py:14-164):
-c/--config, -d/--debug, -s/--simulation; simulation mode loads the
package's 2-camera / 2-station config (the same cam_1/cam_2 + base/
sidewall layout, ``config/simulation.yaml``).  --duration N runs for N
seconds; --diagnose runs the diagnostics and exits; --device picks the
device (CUDA unless "cpu" is named); --dashboard also serves the live
dashboard (serving/dashboard.py, port 59858) with its inspection loop on
the same device, and shuts it down with the system.

    python -m heimdall_tpu_torch.main -s --duration 10 [--dashboard]
"""

import argparse
import logging
import os
import sys
import time

from heimdall_tpu_torch.core.system import System


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Heimdall - Industrial Vision System (PyTorch/CUDA)")
    parser.add_argument("-c", "--config", type=str,
                        help="Path to configuration file")
    parser.add_argument("-d", "--debug", action="store_true",
                        help="Enable debug logging")
    parser.add_argument("-s", "--simulation", action="store_true",
                        help="Run in simulation mode")
    parser.add_argument("--dashboard", action="store_true",
                        help="Also serve the live dashboard")
    parser.add_argument("--diagnose", action="store_true",
                        help="Run diagnostics and exit")
    parser.add_argument("--duration", type=float, default=0,
                        help="Run for N seconds then exit (0 = forever)")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on (default cuda; cpu runs the "
                             "plain PyTorch versions)")
    return parser.parse_args(argv)


def create_simulation_config(config_path: str) -> None:
    """Default 2-camera / 2-station sim config (reference main.py:76-123)."""
    import yaml
    config = {
        "system": {"name": "Heimdall TPU Simulation", "version": "0.1.0",
                   "log_level": "INFO"},
        "cameras": {
            "cam_1": {"type": "simulation", "width": 640, "height": 480,
                      "pattern": "bottle", "inject_defects": True,
                      "defect_probability": 0.3},
            "cam_2": {"type": "simulation", "width": 640, "height": 480,
                      "pattern": "bottle", "inject_defects": True,
                      "defect_probability": 0.2},
        },
        "stations": {
            "base_inspection": {"camera_id": "cam_1",
                                "pipeline_type": "bottle_base",
                                "rate_limit_ms": 100},
            "sidewall_inspection": {"camera_id": "cam_2",
                                    "pipeline_type": "basic",
                                    "rate_limit_ms": 100},
        },
    }
    os.makedirs(os.path.dirname(config_path), exist_ok=True)
    with open(config_path, "w") as f:
        yaml.dump(config, f, default_flow_style=False)


def configure_simulation_system(system: System) -> None:
    """In-memory simulation setup (reference main.py:125-161)."""
    system.config.add_camera("cam_1", {
        "type": "simulation", "width": 640, "height": 480,
        "pattern": "bottle", "inject_defects": True,
        "defect_probability": 0.3})
    system.config.add_camera("cam_2", {
        "type": "simulation", "width": 640, "height": 480,
        "pattern": "bottle", "inject_defects": True,
        "defect_probability": 0.2})
    system.add_station("base_inspection", {
        "camera_id": "cam_1", "pipeline_type": "bottle_base",
        "rate_limit_ms": 100})
    system.add_station("sidewall_inspection", {
        "camera_id": "cam_2", "pipeline_type": "basic",
        "rate_limit_ms": 100})


def main(argv=None, status=None):
    """Run the CLI; returns the exit code.  A dict passed as ``status``
    receives the system's get_status() at shutdown (and, with --dashboard,
    the dashboard's stats under "dashboard")."""
    args = parse_args(argv)
    log_level = logging.DEBUG if args.debug else logging.INFO
    logging.basicConfig(
        level=log_level,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    logger = logging.getLogger("heimdall.main")
    logger.info("Starting Heimdall")

    if args.diagnose:
        from heimdall_tpu_torch.runtime.diagnostics import run_diagnostics
        report = run_diagnostics(device=args.device)
        print(report.summary())
        return 0 if report.passed else 1

    config_path = args.config
    if not config_path and args.simulation:
        config_path = os.path.join(os.path.dirname(__file__), "config",
                                   "simulation.yaml")
        if not os.path.exists(config_path):
            create_simulation_config(config_path)

    system = System(config_path, device=args.device)
    if args.simulation and not system.stations:
        logger.info("Configuring simulation mode")
        configure_simulation_system(system)

    dashboard = None
    if args.dashboard:
        from heimdall_tpu_torch.serving.dashboard import DashboardServer
        dashboard = DashboardServer(device=args.device)
        dashboard.start_background()
        dashboard.state.start()
        logger.info("Dashboard on port %d", dashboard.port)

    try:
        system.start()
        logger.info("System running. Press Ctrl+C to stop.")
        deadline = time.time() + args.duration if args.duration else None
        while deadline is None or time.time() < deadline:
            time.sleep(min(1.0, max(deadline - time.time(), 0.0))
                       if deadline is not None else 1.0)
    except KeyboardInterrupt:
        logger.info("Interrupted by user")
    finally:
        system.stop()
        final = system.get_status()
        if dashboard is not None:
            dashboard.shutdown()
            final["dashboard"] = dashboard.state.snapshot_stats()
        if status is not None:
            status.update(final)
        for sid, st in final["stations"].items():
            logger.info("Station %s: %d frames, %d defects, %.2f ms/frame",
                        sid, st["frames_processed"], st["defects_detected"],
                        st["avg_processing_time"] * 1e3)
        logger.info("Heimdall stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
