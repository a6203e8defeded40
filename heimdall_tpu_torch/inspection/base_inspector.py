"""Inspector framework: pipeline + detectors -> InspectionResult (port of
heimdall_tpu/inspection/base_inspector.py).

API-compatible with the reference (heimdall/inspection/base_inspector.py:
11-210): inspect() runs the pipeline, applies every detector to the
*processed* image (the reference's double processing — SURVEY.md §3.1
note), collects per-detector visualizations and a summary visualization,
and wraps everything in an InspectionResult.

``inspect_batch(images)`` runs pipeline + detectors over an [N, H, W, C]
batch: the processed frames stay on the inspector's device between the
pipeline and the detectors, and only the blob tables come back to the
host.  An inspector runs on CUDA unless it is given ``device="cpu"``.
"""

import logging
import time
from typing import Any, Dict, List

import numpy as np
import torch

from heimdall_tpu_torch.detectors.base import Defect
from heimdall_tpu_torch.detectors.contamination_detector import (
    resolve_device)
from heimdall_tpu_torch.utils import draw


class InspectionResult:
    """Result of an inspection (reference base_inspector.py:11-64)."""

    def __init__(self, inspection_id: str, timestamp: float, success: bool,
                 defects: List[Defect] = None,
                 images: Dict[str, np.ndarray] = None,
                 metadata: Dict[str, Any] = None):
        self.inspection_id = inspection_id
        self.timestamp = timestamp
        self.success = success
        self.defects = defects or []
        self.images = images or {}
        self.metadata = metadata or {}
        self.processing_time = (metadata or {}).get("processing_time", 0)

    @property
    def has_defects(self) -> bool:
        return len(self.defects) > 0

    @property
    def defect_count(self) -> int:
        return len(self.defects)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "inspection_id": self.inspection_id,
            "timestamp": self.timestamp,
            "success": self.success,
            "has_defects": self.has_defects,
            "defect_count": self.defect_count,
            "defects": [d.to_dict() for d in self.defects],
            "processing_time": self.processing_time,
            "metadata": self.metadata,
        }

    def __str__(self) -> str:
        return (f"InspectionResult(id={self.inspection_id}, "
                f"success={self.success}, defects={self.defect_count})")


class Inspector:
    """Base inspector; subclasses wire a pipeline and detectors on
    ``self.device``."""

    def __init__(self, inspector_id: str, config: Dict[str, Any] = None,
                 device=None):
        self.inspector_id = inspector_id
        self.config = config or {}
        self.device = resolve_device(device)
        self.logger = logging.getLogger(f"heimdall.inspector.{inspector_id}")
        self.pipeline = None
        self.detectors = []
        self._setup_pipeline()
        self._setup_detectors()

    def _setup_pipeline(self):
        raise NotImplementedError("Subclasses must implement this method")

    def _setup_detectors(self):
        raise NotImplementedError("Subclasses must implement this method")

    # ------------------------------------------------------------------
    def inspect(self, image: np.ndarray,
                context: Dict[str, Any] = None) -> InspectionResult:
        if context is None:
            context = {}
        start_time = time.time()
        inspection_id = context.get(
            "inspection_id", f"{self.inspector_id}_{int(start_time * 1000)}")
        image = np.asarray(image)
        result = InspectionResult(
            inspection_id=inspection_id,
            timestamp=start_time,
            success=False,
            images={"original": image.copy()},
            metadata={"inspector_id": self.inspector_id})
        try:
            pipeline_result = self.pipeline.process(image, context)
            if not pipeline_result.get("success", False):
                raise RuntimeError(pipeline_result.get("error",
                                                       "pipeline failed"))
            processed = pipeline_result["result_image"]
            result.images["processed"] = processed

            all_defects: List[Defect] = []
            for detector in self.detectors:
                defects = detector(processed, context)
                all_defects.extend(defects)
                if hasattr(detector, "visualize") and callable(
                        detector.visualize):
                    key = f"visualization_{detector.name}"
                    result.images[key] = detector.visualize(
                        image.copy(), defects)

            result.defects = all_defects
            result.success = True
            result.images["visualization"] = self._create_visualization(
                image, processed, all_defects)
        except Exception as exc:
            self.logger.error("Inspection failed: %s", exc)
            result.success = False
            result.metadata["error"] = str(exc)
        finally:
            processing_time = time.time() - start_time
            result.processing_time = processing_time
            result.metadata["processing_time"] = processing_time
            self.logger.debug(
                "Inspection %s completed in %.3fs, found %d defects",
                inspection_id, processing_time, len(result.defects))
        return result

    def inspect_batch(self, images, context: Dict[str, Any] = None,
                      with_images: bool = False) -> List[InspectionResult]:
        """Batched inspection: pipeline and detectors in one pass on the
        device, the processed frames never leaving it.

        images: numpy [N, H, W, C] or a tensor.  with_images=False (the
        default) skips visualization synthesis — the production path only
        needs verdicts and blob tables.
        """
        if context is None:
            context = {}
        start_time = time.time()
        batch_ctx = dict(context)
        pipeline_result = self.pipeline.process_batch(images,
                                                      device_only=True)
        processed = pipeline_result["result_image"]

        per_frame_defects: List[List[Defect]] = [[] for _ in range(
            len(images))]
        for detector in self.detectors:
            if not with_images:
                batch_ctx["include_contours"] = False
            batches = detector.detect_batch(processed, batch_ctx)
            for i, dd in enumerate(batches):
                per_frame_defects[i].extend(dd)

        elapsed = time.time() - start_time
        if with_images:
            images_np = (images.cpu().numpy()
                         if isinstance(images, torch.Tensor)
                         else np.asarray(images))
            processed_np = processed.cpu().numpy()
        results = []
        for i, defects in enumerate(per_frame_defects):
            res = InspectionResult(
                inspection_id=f"{self.inspector_id}_{int(start_time*1000)}_{i}",
                timestamp=start_time,
                success=True,
                defects=defects,
                metadata={"inspector_id": self.inspector_id,
                          "processing_time": elapsed / len(images),
                          "batch_size": int(len(images))})
            if with_images:
                res.images["original"] = images_np[i]
                res.images["processed"] = processed_np[i]
                res.images["visualization"] = self._create_visualization(
                    images_np[i], processed_np[i], defects)
            results.append(res)
        return results

    # ------------------------------------------------------------------
    def _create_visualization(self, original, processed,
                              defects: List[Defect]) -> np.ndarray:
        original = np.asarray(original)
        if original.ndim == 2:
            viz = np.stack([original] * 3, axis=-1)
        else:
            viz = original.copy()
        for defect in defects:
            draw.circle_outline(viz, defect.position, 10, (0, 0, 255), 2)
            draw.put_text(
                viz, f"{defect.defect_type}: {defect.confidence:.2f}",
                (defect.position[0] + 15, defect.position[1]), (0, 0, 255), 1)
        draw.put_text(viz, f"DEFECTS: {len(defects)}", (10, 30),
                      (0, 0, 255) if defects else (0, 255, 0), 2)
        return viz
