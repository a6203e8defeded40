"""Host-side frame producers (the acquisition layer).

API-compatible with the reference's ImageSource family
(heimdall/core/acquisition.py:12-433): file / directory / camera /
simulation sources behind one ABC with a factory, context-manager support,
and the same config keys.  Two TPU-native additions:

* ``read_batch(n)`` on every source — the device pipeline consumes batches,
  so sources can produce [N, H, W, 3] blocks in one call instead of
  one-frame reads driven by per-station threads.
* image decode prefers cv2 when present but falls back to pure NumPy
  drawing for simulation, so the framework has no hard OpenCV dependency.

A copy of heimdall_tpu/core/acquisition.py (drawing through
the port's utils/draw.py): the port imports nothing of the JAX package.
"""

import logging
import os
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from heimdall_tpu_torch.utils import draw

try:  # optional — only used for file decode and webcams
    import cv2
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False

logger = logging.getLogger("heimdall.acquisition")


class ImageSource(ABC):
    """Abstract frame producer (context manager, read one or many)."""

    def __init__(self, source_id: str, config: Dict[str, Any]):
        self.source_id = source_id
        self.config = config
        self.is_open = False
        self.logger = logging.getLogger(f"heimdall.acquisition.{source_id}")

    @abstractmethod
    def open(self) -> bool:
        ...

    @abstractmethod
    def close(self) -> None:
        ...

    @abstractmethod
    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        ...

    def read_batch(self, n: int) -> Tuple[int, Optional[np.ndarray]]:
        """Read up to n frames; returns (count, [count, H, W, C] or None)."""
        frames: List[np.ndarray] = []
        for _ in range(n):
            ok, frame = self.read()
            if not ok or frame is None:
                break
            frames.append(frame)
        if not frames:
            return 0, None
        return len(frames), np.stack(frames)

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()


class FileImageSource(ImageSource):
    """Reads a single image file repeatedly (reference acquisition.py:62)."""

    def __init__(self, source_id: str, config: Dict[str, Any]):
        super().__init__(source_id, config)
        self.file_path = config.get("file_path")
        self._image: Optional[np.ndarray] = None

    def open(self) -> bool:
        if not self.file_path:
            self.logger.error("No file path specified")
            return False
        if not os.path.exists(self.file_path):
            self.logger.error("File not found: %s", self.file_path)
            return False
        self._image = _imread(self.file_path)
        if self._image is None:
            self.logger.error("Failed to load image: %s", self.file_path)
            return False
        self.is_open = True
        self.logger.info("Loaded image: %s, shape: %s",
                         self.file_path, self._image.shape)
        return True

    def close(self) -> None:
        self._image = None
        self.is_open = False

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        if self._image is None and not self.open():
            return False, None
        return True, self._image.copy()


class DirectoryImageSource(ImageSource):
    """Iterates a directory of images, sorted, optional loop
    (reference acquisition.py:123)."""

    def __init__(self, source_id: str, config: Dict[str, Any]):
        super().__init__(source_id, config)
        self.directory_path = config.get("directory_path")
        self.extensions = config.get(
            "extensions", [".jpg", ".jpeg", ".png", ".bmp"])
        self.loop = config.get("loop", False)
        self.file_paths: List[str] = []
        self.current_index = 0

    def open(self) -> bool:
        if not self.directory_path:
            self.logger.error("No directory path specified")
            return False
        if not os.path.exists(self.directory_path):
            self.logger.error("Directory not found: %s", self.directory_path)
            return False
        self.file_paths = sorted(
            os.path.join(self.directory_path, f)
            for f in os.listdir(self.directory_path)
            if os.path.splitext(f)[1].lower() in self.extensions)
        self.current_index = 0
        if not self.file_paths:
            self.logger.warning("No image files found in: %s",
                                self.directory_path)
            return False
        self.is_open = True
        self.logger.info("Found %d images in: %s",
                         len(self.file_paths), self.directory_path)
        return True

    def close(self) -> None:
        self.current_index = 0
        self.is_open = False

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        if not self.file_paths and not self.open():
            return False, None
        if self.current_index >= len(self.file_paths):
            if self.loop:
                self.current_index = 0
            else:
                self.logger.info("Reached end of directory")
                return False, None
        path = self.file_paths[self.current_index]
        self.current_index += 1
        image = _imread(path)
        if image is None:
            self.logger.warning("Failed to load image: %s", path)
            return False, None
        return True, image


class CameraImageSource(ImageSource):
    """cv2.VideoCapture webcam source (reference acquisition.py:208)."""

    def __init__(self, source_id: str, config: Dict[str, Any]):
        super().__init__(source_id, config)
        self.camera_id = config.get("camera_id", 0)
        self.width = config.get("width", 640)
        self.height = config.get("height", 480)
        self.fps = config.get("fps", 30)
        self.camera = None

    def open(self) -> bool:
        if not _HAS_CV2:
            self.logger.error("camera source requires OpenCV")
            return False
        self.camera = cv2.VideoCapture(self.camera_id)
        if not self.camera.isOpened():
            self.logger.error("Failed to open camera %s", self.camera_id)
            return False
        self.camera.set(cv2.CAP_PROP_FRAME_WIDTH, self.width)
        self.camera.set(cv2.CAP_PROP_FRAME_HEIGHT, self.height)
        self.camera.set(cv2.CAP_PROP_FPS, self.fps)
        self.is_open = True
        self.logger.info("Opened camera %s", self.camera_id)
        return True

    def close(self) -> None:
        if self.camera is not None:
            self.camera.release()
            self.camera = None
        self.is_open = False

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        if self.camera is None and not self.open():
            return False, None
        ok, frame = self.camera.read()
        if not ok:
            self.logger.warning("Failed to capture frame")
            return False, None
        return True, frame


class SimulationImageSource(ImageSource):
    """Synthetic bottle / checkerboard frames with probabilistic defect
    injection (reference acquisition.py:280-402).

    Geometry matches the reference: 220-gray background, bottle outline
    rectangle, dark bottle-base disc, optional dark defect disc with radius
    in [3, 10) placed inside the bottle, "DEFECT" label and frame counter.
    A ``seed`` config key makes the stream deterministic, and
    ``sleep_per_frame`` (default 0 — the reference slept 10 ms) keeps
    batched generation fast.
    """

    def __init__(self, source_id: str, config: Dict[str, Any]):
        super().__init__(source_id, config)
        self.width = config.get("width", 640)
        self.height = config.get("height", 480)
        self.pattern = config.get("pattern", "bottle")
        self.inject_defects = config.get("inject_defects", True)
        self.defect_probability = config.get("defect_probability", 0.3)
        self.sleep_per_frame = config.get("sleep_per_frame", 0.0)
        self.rng = np.random.RandomState(config.get("seed"))
        self.frame_count = 0

    def open(self) -> bool:
        self.is_open = True
        self.frame_count = 0
        return True

    def close(self) -> None:
        self.is_open = False

    def _create_bottle_image(self, with_defect: bool) -> np.ndarray:
        h, w = self.height, self.width
        image = np.full((h, w, 3), 220, np.uint8)
        cx, cy = w // 2, h // 2
        bw = min(w, h) // 3
        bh = min(w, h) // 2
        draw.rect_outline(image, (cx - bw // 2, cy - bh // 2),
                          (cx + bw // 2, cy + bh // 2), (100, 100, 100), 2)
        draw.filled_circle(image, (cx, cy + bh // 2 - 20), bw // 2 - 5,
                           (80, 80, 80))
        if with_defect:
            dx = self.rng.randint(cx - bw // 3, cx + bw // 3)
            dy = self.rng.randint(cy - bh // 3, cy + bh // 3)
            radius = self.rng.randint(3, 10)
            draw.filled_circle(image, (dx, dy), radius, (40, 40, 40))
            draw.put_text(image, "DEFECT", (10, 30), (0, 0, 255), 2)
        draw.put_text(image, f"FRAME: {self.frame_count}", (10, h - 10),
                      (0, 0, 0), 1)
        return image

    def _create_checkerboard(self, with_defect: bool) -> np.ndarray:
        h, w = self.height, self.width
        image = np.zeros((h, w, 3), np.uint8)
        tile = 50
        yy = (np.arange(h) // tile)[:, None]
        xx = (np.arange(w) // tile)[None, :]
        image[(yy + xx) % 2 == 0] = 255
        if with_defect:
            dx = self.rng.randint(0, w)
            dy = self.rng.randint(0, h)
            radius = self.rng.randint(10, 30)
            draw.filled_circle(image, (dx, dy), radius, (0, 0, 255))
        return image

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        if not self.is_open:
            self.open()
        self.frame_count += 1
        with_defect = (self.inject_defects
                       and self.rng.random_sample() < self.defect_probability)
        if self.pattern == "bottle":
            image = self._create_bottle_image(with_defect)
        else:
            image = self._create_checkerboard(with_defect)
        if self.sleep_per_frame:
            time.sleep(self.sleep_per_frame)
        return True, image


class ImageSourceFactory:
    """Creates sources from config dicts (reference acquisition.py:405-433)."""

    _TYPES = {
        "file": FileImageSource,
        "directory": DirectoryImageSource,
        "camera": CameraImageSource,
        "simulation": SimulationImageSource,
    }

    @staticmethod
    def create_source(source_id: str, config: Dict[str, Any]) -> ImageSource:
        source_type = config.get("type", "simulation")
        cls = ImageSourceFactory._TYPES.get(source_type)
        if cls is None:
            raise ValueError(f"Unsupported image source type: {source_type}")
        return cls(source_id, config)

    @classmethod
    def register(cls, name: str, source_cls) -> None:
        """Extension hook: register custom source types (e.g. GigE feeder)."""
        cls._TYPES[name] = source_cls


def _imread(path: str) -> Optional[np.ndarray]:
    if _HAS_CV2:
        return cv2.imread(path)
    try:  # numpy-only fallback for uncompressed formats
        from PIL import Image  # pragma: no cover
        return np.asarray(Image.open(path))[..., ::-1].copy()
    except Exception:
        return None
