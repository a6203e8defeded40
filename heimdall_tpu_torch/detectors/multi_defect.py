"""Multi-class defect detection on PyTorch/CUDA: contamination / crack /
deformation / color defect (port of heimdall_tpu/detectors/multi_defect.py).

Rebuilds the reference's richest detection example
(rust/examples/detection/bottle_defect_detector.rs:1-410), which classifies
thresholded contours into Contamination / Crack / Deformation / ColorDefect
by geometry and color statistics.  The classification consumes the blob
table of the contamination front end (no extra image passes): the table
comes back from the card in one packed download
(contamination_detector.py::download_table) and is classified on the host
by a few vectorized comparisons.  On the card a 640x480 batch goes through
the fused kernel and a 1920x1080 one through the tiled routes.

Classification rules (matching the reference example's intent):
  crack         — strongly elongated (aspect >= 3) or very low fill ratio
  deformation   — large area relative to the frame (>= deform_area)
  color defect  — color delta dominates the intensity delta
  contamination — everything else (compact dark blob)
"""

from typing import Any, Dict, List

import numpy as np

from heimdall_tpu_torch.detectors.base import Defect, DefectDetector
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector, download_table)


class MultiClassDefectDetector(DefectDetector):
    """Blob-table-driven multi-class defect detector, on ``device`` (CUDA
    unless "cpu" is named; raises when there is no card)."""

    def __init__(self, name: str = "multi_defect",
                 config: Dict[str, Any] = None, device=None):
        super().__init__(name, config)
        cfg = self.config
        self.crack_aspect = cfg.get("crack_aspect", 3.0)
        self.crack_fill = cfg.get("crack_fill", 0.35)
        self.deform_area = cfg.get("deform_area", 1500.0)
        self.color_dominance = cfg.get("color_dominance", 1.5)
        # reuse the contamination front-end (same preprocess + blob table)
        self._front = ContaminationDetector(
            f"{name}_front",
            {**cfg.get("front_config", {}),
             "min_contaminant_size": cfg.get("min_size", 10),
             "max_contaminant_size": cfg.get("max_size", 100000),
             "include_contours": False}, device=device)
        self.device = self._front.device

    def classify_table(self, table, conf, accepted) -> List[List[Defect]]:
        """Vectorized classification of an accepted blob table (numpy)."""
        valid = np.asarray(accepted)
        w = np.asarray(table.w).astype(np.float64)
        h = np.asarray(table.h).astype(np.float64)
        area = np.asarray(table.area)
        cx, cy = np.asarray(table.cx), np.asarray(table.cy)
        x, y = np.asarray(table.x), np.asarray(table.y)
        intensity = np.asarray(table.intensity_score)
        color = np.asarray(table.color_score)
        shape_sc = np.asarray(table.shape_score)
        conf = np.asarray(conf)

        with np.errstate(divide="ignore", invalid="ignore"):
            aspect = np.maximum(w, h) / np.maximum(np.minimum(w, h), 1.0)
            fill = np.where(w * h > 0, area / (w * h), 0.0)

        is_crack = (aspect >= self.crack_aspect) | \
            ((fill < self.crack_fill) & (area >= 20))
        is_deform = area >= self.deform_area
        is_color = color > self.color_dominance * np.maximum(intensity,
                                                            1e-6)
        results: List[List[Defect]] = []
        for i in range(valid.shape[0]):
            defects: List[Defect] = []
            for k in np.nonzero(valid[i])[0]:
                if is_deform[i][k]:
                    kind = "deformation"
                elif is_crack[i][k]:
                    kind = "crack"
                elif is_color[i][k]:
                    kind = "color_defect"
                else:
                    kind = "contamination"
                defects.append(Defect(
                    defect_type=kind,
                    position=(int(cx[i][k]), int(cy[i][k])),
                    size=float(area[i][k]),
                    confidence=float(conf[i][k]),
                    metadata={
                        "bounding_box": (int(x[i][k]), int(y[i][k]),
                                         int(w[i][k]), int(h[i][k])),
                        "aspect_ratio": float(aspect[i][k]),
                        "fill_ratio": float(fill[i][k]),
                        "intensity_score": float(intensity[i][k]),
                        "color_score": float(color[i][k]),
                        "shape_score": float(shape_sc[i][k]),
                    }))
            results.append(defects)
        return results

    def detect_batch(self, images,
                     context: Dict[str, Any] = None) -> List[List[Defect]]:
        """images: a numpy batch, or a tensor (on the detector's device it
        is used in place)."""
        out = self._front.run_device(images)
        return self.classify_table(*download_table(*out))

    def detect(self, image: np.ndarray,
               context: Dict[str, Any] = None) -> List[Defect]:
        return self.detect_batch(np.asarray(image)[None], context)[0]
