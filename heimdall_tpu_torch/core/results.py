"""Result persistence and querying.

Implements the ResultRepository the reference designed but never built
(docs/architecture_design.md:387-407; the reference only wrote loose JPEGs
from its test script): inspection results persist as JSON records (+
optional images named so the results viewer groups them), with query by
time range / verdict and line-level summary statistics — the audit trail a
production inspection line requires.

A copy of heimdall_tpu/core/results.py: the port imports
nothing of the JAX package.
"""

import json
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

logger = logging.getLogger("heimdall.results")


class ResultRepository:
    """Filesystem-backed repository of InspectionResults."""

    def __init__(self, root: str = "./results", save_images: bool = False):
        self.root = root
        self.save_images = save_images
        os.makedirs(root, exist_ok=True)
        self._counter = self._next_index()

    def _next_index(self) -> int:
        mx = 0
        for name in os.listdir(self.root):
            if name.startswith("result_") and name.endswith(".json"):
                try:
                    mx = max(mx, int(name[7:-5]))
                except ValueError:
                    pass
        return mx + 1

    # ------------------------------------------------------------------
    def store(self, result) -> str:
        """Persist one InspectionResult; returns the record path."""
        idx = self._counter
        self._counter += 1
        record = result.to_dict()
        record["stored_at"] = time.time()
        record["index"] = idx
        path = os.path.join(self.root, f"result_{idx:06d}.json")
        with open(path, "w") as f:
            json.dump(record, f)
        if self.save_images and result.images:
            self._save_images(idx, result.images)
        return path

    def _save_images(self, idx: int, images: Dict[str, np.ndarray]) -> None:
        try:
            import cv2
            for kind in ("original", "processed", "visualization"):
                if kind in images:
                    cv2.imwrite(os.path.join(self.root,
                                             f"{kind}_{idx}.jpg"),
                                np.asarray(images[kind]))
        except ImportError:
            for kind, img in images.items():
                np.save(os.path.join(self.root, f"{kind}_{idx}.npy"),
                        np.asarray(img))

    # ------------------------------------------------------------------
    def iter_records(self) -> Iterator[Dict[str, Any]]:
        for name in sorted(os.listdir(self.root)):
            if name.startswith("result_") and name.endswith(".json"):
                try:
                    with open(os.path.join(self.root, name)) as f:
                        yield json.load(f)
                except (OSError, json.JSONDecodeError):
                    continue

    def query(self, since: Optional[float] = None,
              until: Optional[float] = None,
              only_defective: bool = False,
              limit: int = 1000) -> List[Dict[str, Any]]:
        out = []
        for rec in self.iter_records():
            ts = rec.get("timestamp", 0)
            if since is not None and ts < since:
                continue
            if until is not None and ts > until:
                continue
            if only_defective and not rec.get("has_defects"):
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        return out

    def summary(self) -> Dict[str, Any]:
        total = 0
        defective = 0
        defect_count = 0
        times = []
        for rec in self.iter_records():
            total += 1
            if rec.get("has_defects"):
                defective += 1
            defect_count += rec.get("defect_count", 0)
            times.append(rec.get("processing_time", 0.0))
        return {
            "inspections": total,
            "defective": defective,
            "defect_rate": defective / total if total else 0.0,
            "total_defects": defect_count,
            "avg_processing_time": float(np.mean(times)) if times else 0.0,
        }
