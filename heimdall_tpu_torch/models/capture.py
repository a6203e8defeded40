"""Training-data capture from the live inspection line.

The reference reserves a `models/` directory but never fills it; this
module closes the loop: stations (core/system.py) can stream every
inspected frame's evidence — the frame, the detector's blob records, and
a rasterized defect mask — into compressed npz shards, which feed the
classifier (models/defect_classifier.py) and segmenter
(models/segmentation.py) trainers offline.

Shards are append-only and size-bounded; capture is sampling-controlled so
a 90,000 BPH line doesn't write 25 frames/s of disk forever.

A copy of heimdall_tpu/models/capture.py: the port imports
nothing of the JAX package.
"""

import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np


class TrainingDataCapture:
    """Collects (frame, defects) pairs into npz shards.

    Config: directory, shard_size (frames per file), sample_rate
    (fraction of frames captured; defect frames are always captured when
    capture_all_defects is set).
    """

    def __init__(self, directory: str, shard_size: int = 64,
                 sample_rate: float = 0.05,
                 capture_all_defects: bool = True, seed: int = 0):
        self.directory = directory
        self.shard_size = shard_size
        self.sample_rate = sample_rate
        self.capture_all_defects = capture_all_defects
        os.makedirs(directory, exist_ok=True)
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()
        self._frames: List[np.ndarray] = []
        self._records: List[Dict[str, Any]] = []
        self._shard_idx = self._next_shard_index()
        self.captured = 0
        self.skipped = 0

    def _next_shard_index(self) -> int:
        existing = [f for f in os.listdir(self.directory)
                    if f.startswith("capture_") and f.endswith(".npz")]
        return len(existing)

    # -- ingestion -----------------------------------------------------------
    def add(self, frame: np.ndarray, defects: List[Any]) -> bool:
        """Maybe capture one frame; returns True when it was kept."""
        has_defect = bool(defects)
        keep = (self.capture_all_defects and has_defect) or \
            (self._rng.rand() < self.sample_rate)
        if not keep:
            with self._lock:
                self.skipped += 1
            return False
        record = {
            "timestamp": time.time(),
            "n_defects": len(defects),
            "boxes": np.asarray(
                [list(d.metadata.get("bounding_box", (0, 0, 0, 0)))
                 for d in defects], np.int32).reshape(-1, 4),
            "confidences": np.asarray(
                [d.confidence for d in defects], np.float32),
            "sizes": np.asarray([d.size for d in defects], np.float32),
        }
        with self._lock:
            self._frames.append(np.asarray(frame))
            self._records.append(record)
            self.captured += 1
            if len(self._frames) >= self.shard_size:
                self._flush_locked()
        return True

    def add_batch(self, frames: np.ndarray, results: List[Any]) -> int:
        """Capture from a station batch (results: InspectionResult list)."""
        kept = 0
        for frame, result in zip(frames, results):
            defects = getattr(result, "defects", result)
            kept += int(self.add(frame, defects))
        return kept

    def flush(self) -> Optional[str]:
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> Optional[str]:
        if not self._frames:
            return None
        path = os.path.join(self.directory,
                            f"capture_{self._shard_idx:05d}.npz")
        arrays: Dict[str, np.ndarray] = {
            "frames": np.stack(self._frames),
            "n_defects": np.asarray([r["n_defects"] for r in self._records],
                                    np.int32),
            "timestamps": np.asarray(
                [r["timestamp"] for r in self._records], np.float64),
        }
        for i, r in enumerate(self._records):
            arrays[f"boxes_{i}"] = r["boxes"]
            arrays[f"confidences_{i}"] = r["confidences"]
            arrays[f"sizes_{i}"] = r["sizes"]
        np.savez_compressed(path, **arrays)
        self._frames.clear()
        self._records.clear()
        self._shard_idx += 1
        return path

    # -- consumption ---------------------------------------------------------
    def iter_shards(self) -> Iterator[Dict[str, np.ndarray]]:
        for name in sorted(os.listdir(self.directory)):
            if name.startswith("capture_") and name.endswith(".npz"):
                with np.load(os.path.join(self.directory, name)) as z:
                    yield {k: z[k] for k in z.files}

    def dataset_masks(self) -> Tuple[np.ndarray, np.ndarray]:
        """(frames [N,H,W(,3)], masks [N,H,W]) — bbox-rasterized defect
        masks for segmentation training."""
        frames, masks = [], []
        for shard in self.iter_shards():
            fr = shard["frames"]
            for i in range(fr.shape[0]):
                m = np.zeros(fr.shape[1:3], bool)
                for (x, y, w, h) in shard.get(
                        f"boxes_{i}", np.zeros((0, 4), np.int32)):
                    m[y:y + h, x:x + w] = True
                frames.append(fr[i])
                masks.append(m)
        if not frames:
            return (np.zeros((0, 1, 1), np.uint8),
                    np.zeros((0, 1, 1), bool))
        return np.stack(frames), np.stack(masks)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"captured": self.captured, "skipped": self.skipped,
                    "pending": len(self._frames),
                    "shards": self._shard_idx}
