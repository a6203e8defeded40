"""Real Aravis/GigE camera backend via the native dlopen shim.

The reference simulates every Aravis call (rust/heimdall-camera/src/
aravis.rs:9-340); this module is the production seam it leaves open: the
native shim (native/aravis_shim.cpp) dlopens libaravis at runtime and this
class drives it through ctypes.  On hosts without libaravis the backend
reports unavailable and ``CameraFactory.create("aravis")`` keeps returning
the simulated camera — the same graceful-degradation contract as the
reference's rust_bridge (rust_bridge.py:19-26).

Set HEIMDALL_ARAVIS_LIB to point the shim at a specific library — the test
suite uses this to run the whole binding against native/libaravis_fake.so.

A copy of heimdall_tpu/camera/aravis.py: the port imports nothing of the JAX
package.
"""

import ctypes
import os
from typing import Any, Dict, List, Optional

import numpy as np

from heimdall_tpu_torch.camera.hal import (Camera, CameraError, CameraFrame,
                                     CameraInfo, PixelFormat)

_shim = None
_shim_checked = False


def _load_shim() -> Optional[ctypes.CDLL]:
    """Load the native shim library (built by native/Makefile)."""
    global _shim, _shim_checked
    if _shim_checked:
        return _shim
    _shim_checked = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates = [
        os.environ.get("HEIMDALL_ARAVIS_SHIM", ""),
        os.path.join(here, "native", "libheimdall_aravis.so"),
    ]
    for path in candidates:
        if not path or not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.hv_aravis_available.restype = ctypes.c_int
        lib.hv_aravis_n_devices.restype = ctypes.c_int
        lib.hv_aravis_device_id.restype = ctypes.c_int
        lib.hv_aravis_device_id.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                            ctypes.c_int]
        lib.hv_aravis_open.restype = ctypes.c_void_p
        lib.hv_aravis_open.argtypes = [ctypes.c_char_p]
        lib.hv_aravis_configure.restype = ctypes.c_int
        lib.hv_aravis_configure.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                            ctypes.c_double, ctypes.c_double]
        lib.hv_aravis_start.restype = ctypes.c_int
        lib.hv_aravis_start.argtypes = [ctypes.c_void_p]
        lib.hv_aravis_trigger.restype = ctypes.c_int
        lib.hv_aravis_trigger.argtypes = [ctypes.c_void_p]
        lib.hv_aravis_grab.restype = ctypes.c_long
        lib.hv_aravis_grab.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_uint64]
        lib.hv_aravis_stop.restype = ctypes.c_int
        lib.hv_aravis_stop.argtypes = [ctypes.c_void_p]
        lib.hv_aravis_close.restype = None
        lib.hv_aravis_close.argtypes = [ctypes.c_void_p]
        _shim = lib
        return _shim
    return None


def hardware_available() -> bool:
    """True when the shim loaded AND it found a libaravis to dlopen."""
    lib = _load_shim()
    return bool(lib) and bool(lib.hv_aravis_available())


def enumerate_hardware() -> List[str]:
    """Device ids visible to libaravis (empty when unavailable)."""
    lib = _load_shim()
    if not lib or not lib.hv_aravis_available():
        return []
    ids = []
    buf = ctypes.create_string_buffer(256)
    for i in range(lib.hv_aravis_n_devices()):
        if lib.hv_aravis_device_id(i, buf, 256) > 0:
            ids.append(buf.value.decode())
    return ids


class AravisHardwareCamera(Camera):
    """Camera backed by a real Aravis stream through the native shim.

    config keys: device_id (Aravis id; empty = first camera),
    exposure_us, gain_db, frame_rate, grab_timeout_s.
    """

    def __init__(self, camera_id: str, config: Dict[str, Any] = None):
        super().__init__(camera_id, config)
        self._handle = None
        self._width = 0
        self._height = 0

    # -- Camera interface ----------------------------------------------------
    def initialize(self) -> None:
        lib = _load_shim()
        if not lib or not lib.hv_aravis_available():
            raise CameraError(CameraError.Kind.NOT_FOUND,
                              "libaravis not available on this host")
        device_id = self.config.get("device_id", "")
        handle = lib.hv_aravis_open(device_id.encode())
        if not handle:
            raise CameraError(CameraError.Kind.NOT_FOUND,
                              f"Aravis camera not found: {device_id!r}")
        self._handle = handle
        rc = lib.hv_aravis_configure(
            handle, float(self.config.get("exposure_us", 10000.0)),
            float(self.config.get("gain_db", 0.0)),
            float(self.config.get("frame_rate", 30.0)))
        if rc != 0:
            raise CameraError(CameraError.Kind.CONFIGURATION,
                              "Aravis configure failed")
        self.is_initialized = True
        self.logger.info("Aravis camera %s opened", self.camera_id)

    def start_acquisition(self) -> None:
        if not self.is_initialized:
            self.initialize()
        lib = _load_shim()
        if lib.hv_aravis_start(self._handle) != 0:
            raise CameraError(CameraError.Kind.ACQUISITION,
                              "Aravis stream start failed")
        self.is_acquiring = True

    def stop_acquisition(self) -> None:
        if self._handle is not None and self.is_acquiring:
            _load_shim().hv_aravis_stop(self._handle)
        self.is_acquiring = False

    def acquire_frame(self, timeout_s: float = 1.0) -> CameraFrame:
        if not self.is_acquiring:
            raise CameraError(CameraError.Kind.ACQUISITION,
                              "acquisition not started")
        lib = _load_shim()
        cap = self.config.get("max_payload", 8 << 20)
        buf = np.empty(cap, np.uint8)
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        n = lib.hv_aravis_grab(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            ctypes.byref(w), ctypes.byref(h), int(timeout_s * 1e6))
        if n <= 0:
            raise CameraError(CameraError.Kind.TIMEOUT,
                              f"Aravis grab timed out after {timeout_s}s")
        self._width, self._height = w.value, h.value
        import time
        self._frame_count = getattr(self, "_frame_count", 0) + 1
        return CameraFrame(
            data=buf[:n].copy(), width=self._width, height=self._height,
            pixel_format=PixelFormat.MONO8, timestamp=time.time(),
            frame_id=self._frame_count,
            exposure_us=float(self.config.get("exposure_us", 10000.0)),
            gain_db=float(self.config.get("gain_db", 0.0)))

    def trigger(self) -> None:
        if self._handle is None:
            raise CameraError(CameraError.Kind.ACQUISITION, "not open")
        _load_shim().hv_aravis_trigger(self._handle)

    def info(self) -> CameraInfo:
        return CameraInfo(
            camera_id=self.camera_id, model="aravis", vendor="GigE Vision",
            serial=self.config.get("device_id", ""),
            max_width=self._width or 1920, max_height=self._height or 1080,
            pixel_formats=[PixelFormat.MONO8], max_fps=50.0)

    def close(self) -> None:
        if self._handle is not None:
            self.stop_acquisition()
            _load_shim().hv_aravis_close(self._handle)
            self._handle = None
            self.is_initialized = False

    def __del__(self):  # best-effort native cleanup
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
