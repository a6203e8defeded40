"""Contamination inspector (port of
heimdall_tpu/inspection/contamination_inspector.py).

API-compatible with the reference (heimdall/inspection/
contamination_inspector.py:11-55): the "contamination" pipeline and a
ContaminationDetector with the same overridden defaults (min 3 / max 3000 /
contrast 25 / confidence 0.3 / color on), both on the inspector's device.
"""

from heimdall_tpu_torch.core.pipeline import PipelineFactory
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.inspection.base_inspector import Inspector


class ContaminationInspector(Inspector):
    """Inspector for bottle contamination."""

    def _setup_pipeline(self):
        self.logger.info("Setting up contamination inspection pipeline")
        pipeline_type = self.config.get("pipeline_type", "contamination")
        self.pipeline = PipelineFactory.create_pipeline(
            f"{self.inspector_id}_pipeline",
            pipeline_type,
            self.config.get("pipeline_config", {}),
            device=self.device)

    def _setup_detectors(self):
        self.logger.info("Setting up contamination defect detectors")
        detector = ContaminationDetector(
            "contamination_detector",
            self.config.get("contamination_detector_config", {
                "min_contaminant_size": 3,
                "max_contaminant_size": 3000,
                "contrast_threshold": 25,
                "min_confidence": 0.3,
                "use_color": True,
            }),
            device=self.device)
        self.detectors.append(detector)
        self.logger.info("Configured %d detectors", len(self.detectors))
