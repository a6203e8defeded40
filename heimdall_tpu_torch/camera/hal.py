"""Camera hardware-abstraction layer (copy of heimdall_tpu/camera/hal.py).

Rebuilds the reference's camera HAL (rust/heimdall-camera/src/lib.rs:
11-278): the Camera interface (initialize/start/stop/acquire_frame/
trigger/set_parameter), the 12 PixelFormat variants, TriggerMode, a
factory with simulated backends, and frame→ndarray conversion.  Real
GigE/Aravis hardware plugs in by registering a backend; everything in
this repo is simulated (as in the reference, where every hardware
interaction is a fake — SURVEY.md §4 "Fake backends").  The real-hardware
backend "aravis-hw" drives a GigE camera through the native shim
(camera/aravis.py).
"""

import enum
import logging
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

logger = logging.getLogger("heimdall.camera")


class CameraError(Exception):
    """Camera errors (reference lib.rs:11-30 — 6 variants)."""

    class Kind(enum.Enum):
        NOT_FOUND = "not_found"
        CONNECTION = "connection"
        ACQUISITION = "acquisition"
        CONFIGURATION = "configuration"
        TIMEOUT = "timeout"
        INTERNAL = "internal"

    def __init__(self, kind: "CameraError.Kind", message: str):
        super().__init__(f"{kind.value}: {message}")
        self.kind = kind


class PixelFormat(enum.Enum):
    """Pixel formats (reference lib.rs:33-47 — 12 variants)."""
    MONO8 = "Mono8"
    MONO10 = "Mono10"
    MONO12 = "Mono12"
    MONO16 = "Mono16"
    BAYER_RG8 = "BayerRG8"
    BAYER_GB8 = "BayerGB8"
    BAYER_GR8 = "BayerGR8"
    BAYER_BG8 = "BayerBG8"
    RGB8 = "RGB8"
    BGR8 = "BGR8"
    YUV422 = "YUV422"
    YUV422_PACKED = "YUV422Packed"

    @property
    def bytes_per_pixel(self) -> float:
        return {
            PixelFormat.MONO8: 1, PixelFormat.MONO10: 2,
            PixelFormat.MONO12: 2, PixelFormat.MONO16: 2,
            PixelFormat.BAYER_RG8: 1, PixelFormat.BAYER_GB8: 1,
            PixelFormat.BAYER_GR8: 1, PixelFormat.BAYER_BG8: 1,
            PixelFormat.RGB8: 3, PixelFormat.BGR8: 3,
            PixelFormat.YUV422: 2, PixelFormat.YUV422_PACKED: 2,
        }[self]


class TriggerMode(enum.Enum):
    """Trigger modes (reference lib.rs:97-107)."""
    CONTINUOUS = "continuous"
    SOFTWARE = "software"
    HARDWARE = "hardware"


@dataclass
class CameraInfo:
    camera_id: str
    model: str
    vendor: str
    serial: str
    max_width: int
    max_height: int
    pixel_formats: List[PixelFormat]
    max_fps: float
    supports_hardware_trigger: bool = True
    supports_strobe: bool = True


@dataclass
class CameraFrame:
    """Raw frame + metadata (reference lib.rs:110-132)."""
    data: np.ndarray
    width: int
    height: int
    pixel_format: PixelFormat
    timestamp: float
    frame_id: int
    exposure_us: float = 0.0
    gain_db: float = 0.0

    def to_ndarray(self) -> np.ndarray:
        """Decode to [H, W] or [H, W, C] (reference lib.rs:260-278)."""
        if self.pixel_format in (PixelFormat.MONO8,):
            return self.data.reshape(self.height, self.width)
        if self.pixel_format in (PixelFormat.MONO10, PixelFormat.MONO12,
                                 PixelFormat.MONO16):
            return self.data.view(np.uint16).reshape(self.height, self.width)
        if self.pixel_format in (PixelFormat.RGB8, PixelFormat.BGR8):
            return self.data.reshape(self.height, self.width, 3)
        raise CameraError(CameraError.Kind.INTERNAL,
                          f"decode not implemented for {self.pixel_format}")


class Camera(ABC):
    """Camera interface (reference lib.rs:135-160)."""

    def __init__(self, camera_id: str, config: Dict[str, Any] = None):
        self.camera_id = camera_id
        self.config = config or {}
        self.is_initialized = False
        self.is_acquiring = False
        self.logger = logging.getLogger(f"heimdall.camera.{camera_id}")

    @abstractmethod
    def initialize(self) -> None:
        ...

    @abstractmethod
    def start_acquisition(self) -> None:
        ...

    @abstractmethod
    def stop_acquisition(self) -> None:
        ...

    @abstractmethod
    def acquire_frame(self, timeout_s: float = 1.0) -> CameraFrame:
        ...

    @abstractmethod
    def trigger(self) -> None:
        ...

    def set_parameter(self, name: str, value: Any) -> None:
        self.config[name] = value

    def get_parameter(self, name: str, default: Any = None) -> Any:
        return self.config.get(name, default)

    def info(self) -> CameraInfo:
        return CameraInfo(
            camera_id=self.camera_id, model="generic", vendor="heimdall",
            serial="0", max_width=self.config.get("width", 640),
            max_height=self.config.get("height", 480),
            pixel_formats=[PixelFormat.MONO8], max_fps=50.0)


class SimulatedCamera(Camera):
    """Checkerboard + bottle + deterministic defect every 5th frame
    (reference simulator.rs:42-268), frame-rate paced."""

    def __init__(self, camera_id: str, config: Dict[str, Any] = None):
        super().__init__(camera_id, config)
        self.width = self.config.get("width", 640)
        self.height = self.config.get("height", 480)
        self.fps = self.config.get("fps", 30.0)
        self.trigger_mode = TriggerMode(self.config.get("trigger_mode",
                                                        "continuous"))
        self.frame_counter = 0
        self._last_frame_time = 0.0
        # Event, not a polled flag: under host load (e.g. concurrent H2D
        # streaming) a 0.5 ms poll-sleep loop can stretch to tens of ms
        # per wakeup; Event.wait gets a direct OS wakeup on trigger.
        self._triggered = threading.Event()

    def initialize(self) -> None:
        self.is_initialized = True
        self.logger.info("Simulated camera %s initialized", self.camera_id)

    def start_acquisition(self) -> None:
        if not self.is_initialized:
            raise CameraError(CameraError.Kind.CONFIGURATION,
                              "not initialized")
        self.is_acquiring = True

    def stop_acquisition(self) -> None:
        self.is_acquiring = False

    def trigger(self) -> None:
        if self.trigger_mode == TriggerMode.CONTINUOUS:
            raise CameraError(CameraError.Kind.CONFIGURATION,
                              "trigger on continuous camera")
        self._triggered.set()

    def _synthesize(self) -> np.ndarray:
        h, w = self.height, self.width
        base = getattr(self, "_scene_cache", None)
        if base is None:
            pattern = self.config.get("pattern", "checker")
            if pattern == "bottle":
                # calm production-like scene: gradient + bright bottle
                img = (96 + (64 * np.arange(h)[:, None]) // h
                       ).astype(np.uint8).repeat(w, axis=1)
                img[h // 4:3 * h // 4, w // 3:2 * w // 3] = 210
            else:
                # high-contrast checkerboard (reference simulator.rs scene)
                img = np.zeros((h, w), np.uint8)
                tile = 32
                yy = (np.arange(h) // tile)[:, None]
                xx = (np.arange(w) // tile)[None, :]
                img[(yy + xx) % 2 == 0] = 200
                img[(yy + xx) % 2 == 1] = 60
                img[h // 4:3 * h // 4, w // 3:2 * w // 3] = 210
            cy, cx = h // 2, w // 2
            yy2, xx2 = np.ogrid[:h, :w]
            # static scene + defect pixel indices cached once: a simulated
            # camera must cost microseconds per frame, or IT becomes the
            # line bottleneck instead of the path under test
            self._scene_cache = img
            self._defect_idx = np.nonzero(
                (yy2 - cy) ** 2 + (xx2 - cx) ** 2 <= 64)
            base = img
        img = base.copy()
        if self.frame_counter % 5 == 4:  # deterministic defect
            img[self._defect_idx] = 25
        return img

    def acquire_frame(self, timeout_s: float = 1.0) -> CameraFrame:
        if not self.is_acquiring:
            raise CameraError(CameraError.Kind.ACQUISITION, "not acquiring")
        if self.trigger_mode != TriggerMode.CONTINUOUS:
            if not self._triggered.wait(timeout_s):
                raise CameraError(CameraError.Kind.TIMEOUT,
                                  "no trigger received")
            self._triggered.clear()
        else:
            # pace to fps
            period = 1.0 / self.fps
            wait = self._last_frame_time + period - time.time()
            if wait > 0:
                time.sleep(wait)
        self._last_frame_time = time.time()
        data = self._synthesize()
        frame = CameraFrame(
            data=data.reshape(-1), width=self.width, height=self.height,
            pixel_format=PixelFormat.MONO8, timestamp=self._last_frame_time,
            frame_id=self.frame_counter,
            exposure_us=self.config.get("exposure_us", 10000.0),
            gain_db=self.config.get("gain_db", 0.0))
        self.frame_counter += 1
        return frame

    def info(self) -> CameraInfo:
        return CameraInfo(
            camera_id=self.camera_id, model="SimCam-64", vendor="heimdall",
            serial=f"SIM{abs(hash(self.camera_id)) % 10000:04d}",
            max_width=self.width, max_height=self.height,
            pixel_formats=[PixelFormat.MONO8, PixelFormat.MONO16],
            max_fps=120.0)


class AravisCamera(SimulatedCamera):
    """Placeholder for the Aravis/GigE backend.

    Like the reference (aravis.rs:9-340, simulated throughout), this is a
    simulation that presents GigE-flavoured metadata; a production build
    links the native feeder (native/heimdall_native.cpp) to a real Aravis
    stream at this seam.
    """

    def info(self) -> CameraInfo:
        return CameraInfo(
            camera_id=self.camera_id, model="acA1920-50gm", vendor="Basler",
            serial=f"40{abs(hash(self.camera_id)) % 100000:05d}",
            max_width=1920, max_height=1080,
            pixel_formats=[PixelFormat.MONO8, PixelFormat.MONO16],
            max_fps=50.0)


class CameraFactory:
    """create("aravis"|"simulator") + enumerate (reference lib.rs:163-199)."""

    _BACKENDS = {
        "simulator": SimulatedCamera,
        "aravis": AravisCamera,
    }

    @classmethod
    def create(cls, backend: str, camera_id: str,
               config: Dict[str, Any] = None) -> Camera:
        if backend == "aravis-hw":
            # real GigE hardware through the native dlopen shim
            from heimdall_tpu_torch.camera.aravis import AravisHardwareCamera
            return AravisHardwareCamera(camera_id, config)
        camera_cls = cls._BACKENDS.get(backend)
        if camera_cls is None:
            raise CameraError(CameraError.Kind.NOT_FOUND,
                              f"unknown backend: {backend}")
        return camera_cls(camera_id, config)

    @classmethod
    def register(cls, name: str, camera_cls) -> None:
        cls._BACKENDS[name] = camera_cls

    @classmethod
    def enumerate(cls, backend: str = "aravis") -> List[CameraInfo]:
        """Simulated discovery: 4 GigE cameras (reference camera.rs:36-145)."""
        return [
            AravisCamera(f"cam_{i}", {"width": 1920, "height": 1080}).info()
            for i in range(4)
        ]
