"""System orchestrator: stations driving batched device steps (port of
heimdall_tpu/core/system.py).

API-compatible with the reference (heimdall/core/system.py:14-302):
InspectionStation (start/stop/get_status, rejection hook, EMA timing
stats), System (configure_from_file, add/remove_station, start/stop,
get_status).

The reference ran one thread per station, each executing the full OpenCV
pipeline per frame on the CPU (system.py:106-150).  Here a station's
thread assembles frame *batches* from its image source and submits them to
its pipeline or inspector on the system's device, so every station's
compute lands on the same card.  Rate limiting, stats EMA (0.9/0.1 —
system.py:130-134) and the rejection hook behave as in the reference, but
per batch.  The system, and so each station, runs on CUDA unless it is
given ``device="cpu"``; it raises where there is no card.
"""

import logging
import threading
import time
from typing import Any, Dict, Optional

from heimdall_tpu_torch.core.acquisition import ImageSourceFactory
from heimdall_tpu_torch.core.config import Config
from heimdall_tpu_torch.core.pipeline import PipelineFactory
from heimdall_tpu_torch.detectors.contamination_detector import (
    resolve_device)

logger = logging.getLogger("heimdall.system")


class InspectionStation:
    """A camera + pipeline pair driven as batched device steps."""

    def __init__(self, station_id: str, config: Dict[str, Any],
                 system_config: Config, device=None):
        self.station_id = station_id
        self.device = resolve_device(device)
        self.config = config
        self.system_config = system_config
        self.logger = logging.getLogger(f"heimdall.station.{station_id}")

        camera_id = config.get("camera_id")
        pipeline_type = config.get("pipeline_type", "basic")
        self.batch_size = config.get(
            "batch_size", system_config.get("tpu.batch_size", 8))

        self.camera_config = system_config.get_camera_config(camera_id)
        self.image_source = ImageSourceFactory.create_source(
            camera_id, self.camera_config)

        # Two station modes: "pipeline" (the reference's behavior —
        # system.py:37-41) runs a processing pipeline; "inspector" runs a
        # full Inspector (pipeline + detectors + verdicts) and drives the
        # PLC rejection hardware (the reference left _handle_rejection a
        # log stub — system.py:152-160).
        self.inspector = None
        self.rejector = None
        self.repository = None
        # optional live training-data capture (models/capture.py)
        self.capture = None
        capture_dir = config.get("capture_training_data")
        if capture_dir:
            from heimdall_tpu_torch.models.capture import TrainingDataCapture
            self.capture = TrainingDataCapture(
                capture_dir,
                sample_rate=config.get("capture_sample_rate", 0.05))
        inspector_type = config.get("inspector")
        if inspector_type:
            from heimdall_tpu_torch.inspection.contamination_inspector \
                import ContaminationInspector
            inspectors = {"contamination": ContaminationInspector}
            cls = inspectors.get(inspector_type)
            if cls is None:
                raise ValueError(f"unknown inspector: {inspector_type}")
            self.inspector = cls(f"{station_id}_inspector",
                                 config.get("inspector_config", {}),
                                 device=self.device)
            self.pipeline = self.inspector.pipeline
            if config.get("save_results", False) or \
                    config.get("save_images", False):
                from heimdall_tpu_torch.core.results import ResultRepository
                self.repository = ResultRepository(
                    system_config.get("paths.results", "./results"),
                    save_images=config.get("save_images", False))
            if config.get("reject", False):
                from heimdall_tpu_torch.runtime.plc import RejectionController
                comm = system_config.get("communication.rejection", {})
                self.rejector = RejectionController(
                    delay_ms=comm.get("delay_ms", 100),
                    pulse_duration_ms=comm.get("pulse_duration_ms", 50))
        else:
            self.pipeline = PipelineFactory.create_pipeline(
                f"{station_id}_pipeline", pipeline_type, config,
                device=self.device)

        self.running = False
        self.last_result: Optional[Dict[str, Any]] = None
        self.processing_thread: Optional[threading.Thread] = None
        self.stop_event = threading.Event()

        self.frames_processed = 0
        self.defects_detected = 0
        self.avg_processing_time = 0.0

        self.logger.info("Initialized inspection station %s", station_id)

    def start(self) -> bool:
        if self.running:
            self.logger.warning("Station %s already running", self.station_id)
            return False
        if not self.image_source.open():
            self.logger.error("Failed to open image source for station %s",
                              self.station_id)
            return False
        self.frames_processed = 0
        self.defects_detected = 0
        self.stop_event.clear()
        self.running = True
        self.processing_thread = threading.Thread(
            target=self._processing_loop,
            name=f"station_{self.station_id}", daemon=True)
        self.processing_thread.start()
        self.logger.info("Started inspection station %s", self.station_id)
        return True

    def stop(self) -> None:
        if not self.running:
            return
        self.logger.info("Stopping inspection station %s", self.station_id)
        self.stop_event.set()
        # The loop sees the event between batches; wait for the batch in
        # flight, so that no station thread outlives stop() (a batch on the
        # CPU path can take longer than the JAX package's 5 s timeout).
        if self.processing_thread and self.processing_thread.is_alive():
            self.processing_thread.join()
        self.image_source.close()
        self.running = False
        self.logger.info("Stopped inspection station %s", self.station_id)

    def _processing_loop(self) -> None:
        self.logger.info("Processing loop started for station %s",
                         self.station_id)
        while not self.stop_event.is_set():
            count, batch = self.image_source.read_batch(self.batch_size)
            if count == 0 or batch is None:
                self.logger.warning(
                    "Failed to read frames for station %s", self.station_id)
                time.sleep(0.1)
                continue

            start_time = time.time()
            if self.inspector is not None:
                inspections = self.inspector.inspect_batch(
                    batch, with_images=self.config.get("save_images",
                                                       False))
                if self.repository is not None:
                    for r in inspections:
                        self.repository.store(r)
                if self.capture is not None:
                    self.capture.add_batch(batch, inspections)
                defect_count = sum(r.defect_count for r in inspections)
                worst = max((d.confidence for r in inspections
                             for d in r.defects), default=0.0)
                result = {
                    "success": all(r.success for r in inspections),
                    "defect_count": defect_count,
                    "defects_detected": defect_count > 0,
                    "worst_confidence": worst,
                    "results": [r.to_dict() for r in inspections],
                }
            else:
                result = self.pipeline.process_batch(batch)
                defect_count = int(result.get("contour_count", 0) or 0)
                result["defects_detected"] = defect_count > 0
            processing_time = time.time() - start_time

            self.frames_processed += count
            per_frame = processing_time / max(count, 1)
            if self.avg_processing_time == 0:
                self.avg_processing_time = per_frame
            else:
                self.avg_processing_time = (
                    0.9 * self.avg_processing_time + 0.1 * per_frame)

            if defect_count:
                self.defects_detected += defect_count
            result["timestamp"] = time.time()
            self.last_result = result

            if result.get("defects_detected", False) and \
                    self.config.get("reject", False):
                self._handle_rejection(result)

            rate_limit = self.config.get("rate_limit_ms", 0)
            if rate_limit > 0:
                elapsed_ms = (time.time() - start_time) * 1000
                budget_ms = rate_limit * count
                if elapsed_ms < budget_ms:
                    self.stop_event.wait((budget_ms - elapsed_ms) / 1000)
        self.logger.info("Processing loop ended for station %s",
                         self.station_id)

    def _handle_rejection(self, result: Dict[str, Any]) -> None:
        """Rejection hook: fire the PLC pulse when a rejector is wired,
        else log (the reference's behavior, system.py:152-160)."""
        rejection_threshold = self.config.get(
            "rejection_threshold",
            self.system_config.get("inspection.default.rejection_threshold",
                                   0.7))
        confidence = result.get("worst_confidence", 1.0)
        if self.rejector is not None:
            if confidence >= rejection_threshold:
                self.rejector.reject(self.station_id, confidence)
                self.logger.info(
                    "Reject pulse scheduled at station %s (conf %.2f)",
                    self.station_id, confidence)
        else:
            self.logger.info("Bottle with defects rejected at station %s",
                             self.station_id)

    def get_status(self) -> Dict[str, Any]:
        return {
            "station_id": self.station_id,
            "running": self.running,
            "frames_processed": self.frames_processed,
            "defects_detected": self.defects_detected,
            "avg_processing_time": self.avg_processing_time,
            "last_result_time": (self.last_result or {}).get("timestamp"),
        }


class System:
    """Main system coordinator."""

    def __init__(self, config_path: Optional[str] = None, device=None):
        self._setup_logging()
        self.device = resolve_device(device)
        self.config = Config(config_path)
        self.stations: Dict[str, InspectionStation] = {}
        if config_path is not None:
            self._configure_from_loaded_config()
        logger.info("Heimdall TPU System initialized on %s", self.device)

    def _setup_logging(self) -> None:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")

    def configure_from_file(self, config_path: str) -> bool:
        success = self.config.load_config(config_path)
        if success:
            self._configure_from_loaded_config()
        return success

    def _configure_from_loaded_config(self) -> None:
        for station_id, station_config in \
                self.config.get_all_stations().items():
            self.add_station(station_id, station_config)
        logger.info("Configured %d inspection stations", len(self.stations))

    def add_station(self, station_id: str, config: Dict[str, Any]) -> None:
        if station_id in self.stations:
            logger.warning("Inspection station %s already exists, "
                           "reconfiguring", station_id)
            self.stations[station_id].stop()
        self.stations[station_id] = InspectionStation(
            station_id, config, self.config, device=self.device)
        logger.info("Added inspection station %s", station_id)

    def remove_station(self, station_id: str) -> bool:
        if station_id not in self.stations:
            logger.warning("Inspection station %s not found", station_id)
            return False
        self.stations[station_id].stop()
        del self.stations[station_id]
        logger.info("Removed inspection station %s", station_id)
        return True

    def start(self) -> bool:
        logger.info("Starting Heimdall TPU System")
        for station_id, station in self.stations.items():
            if not station.start():
                logger.error("Failed to start station %s", station_id)
        return True

    def stop(self) -> None:
        logger.info("Stopping Heimdall TPU System")
        for station in self.stations.values():
            station.stop()

    def get_status(self) -> Dict[str, Any]:
        station_statuses = {
            station_id: station.get_status()
            for station_id, station in self.stations.items()
        }
        return {
            "stations": station_statuses,
            "station_count": len(self.stations),
            "running_stations": sum(
                1 for s in self.stations.values() if s.running),
            "system_time": time.time(),
        }
