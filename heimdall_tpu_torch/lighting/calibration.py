"""Lighting calibration: auto-intensity control + uniformity correction.

Rebuilds the reference's calibration stack (lib.rs:418-501,
calibration/auto_intensity.rs:14-438, calibration/uniformity.rs:76-330):
a simple proportional adjuster, an advanced adjuster with PID /
binary-search / gradient / histogram algorithms (full PID controller),
and a UniformityCalibrator that builds a correction map from reference
frames.

The uniformity correction map is applied **on the device** as one
elementwise multiply (``apply_on_device``) instead of per-pixel host loops.

A copy of heimdall_tpu/lighting/calibration.py but for ``apply_on_device``,
which runs in PyTorch on the frames' device; maps saved by either package
load in the other (both are ``np.save`` of the float32 map).
"""

import enum
import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from heimdall_tpu_torch.lighting.controller import LightingController

logger = logging.getLogger("heimdall.lighting.calibration")


class AutoIntensityAdjuster:
    """Proportional brightness servo (reference lib.rs:418-501)."""

    def __init__(self, controller: LightingController, channel: int,
                 target_brightness: float = 128.0, gain: float = 0.002,
                 tolerance: float = 2.0):
        self.controller = controller
        self.channel = channel
        self.target = target_brightness
        self.gain = gain
        self.tolerance = tolerance

    def step(self, measured_brightness: float) -> float:
        """One control step; returns the new intensity (0..1)."""
        error = self.target - measured_brightness
        state = self.controller.get_channel_state(self.channel)
        if abs(error) <= self.tolerance:
            return state.intensity
        new_intensity = min(max(state.intensity + self.gain * error, 0.0),
                            1.0)
        self.controller.set_intensity(self.channel, new_intensity)
        return new_intensity


class IntensityAlgorithm(enum.Enum):
    """Reference calibration/auto_intensity.rs:14-23."""
    PID = "pid"
    BINARY_SEARCH = "binary_search"
    GRADIENT = "gradient"
    HISTOGRAM = "histogram"


@dataclass
class PIDController:
    """Classic PID (reference auto_intensity.rs:155-238)."""
    kp: float = 0.004
    ki: float = 0.0005
    kd: float = 0.001
    integral_limit: float = 100.0
    _integral: float = 0.0
    _last_error: Optional[float] = None

    def update(self, error: float, dt: float = 1.0) -> float:
        self._integral += error * dt
        self._integral = min(max(self._integral, -self.integral_limit),
                             self.integral_limit)
        derivative = 0.0 if self._last_error is None else \
            (error - self._last_error) / dt
        self._last_error = error
        return (self.kp * error + self.ki * self._integral
                + self.kd * derivative)

    def reset(self) -> None:
        self._integral = 0.0
        self._last_error = None


class AdvancedAutoIntensityAdjuster:
    """Multi-algorithm intensity calibration
    (reference auto_intensity.rs:72-152,241-438)."""

    def __init__(self, controller: LightingController, channel: int,
                 target_brightness: float = 128.0,
                 algorithm: IntensityAlgorithm = IntensityAlgorithm.PID,
                 tolerance: float = 2.0):
        self.controller = controller
        self.channel = channel
        self.target = target_brightness
        self.algorithm = algorithm
        self.tolerance = tolerance
        self.pid = PIDController()
        self._lo, self._hi = 0.0, 1.0   # binary-search bracket
        self.history: List[Tuple[float, float]] = []

    def step(self, measured_brightness: float) -> float:
        state = self.controller.get_channel_state(self.channel)
        intensity = state.intensity
        error = self.target - measured_brightness
        self.history.append((intensity, measured_brightness))
        if abs(error) <= self.tolerance:
            return intensity

        if self.algorithm == IntensityAlgorithm.PID:
            new = intensity + self.pid.update(error)
        elif self.algorithm == IntensityAlgorithm.BINARY_SEARCH:
            if error > 0:
                self._lo = intensity
            else:
                self._hi = intensity
            new = (self._lo + self._hi) / 2.0
        elif self.algorithm == IntensityAlgorithm.GRADIENT:
            if len(self.history) >= 2:
                (i0, b0), (i1, b1) = self.history[-2], self.history[-1]
                slope = (b1 - b0) / (i1 - i0) if abs(i1 - i0) > 1e-6 else 255.0
                slope = max(slope, 1e-3)
                new = intensity + error / slope
            else:
                new = intensity + 0.05 * np.sign(error)
        else:  # HISTOGRAM: step toward putting the median at target
            new = intensity + 0.002 * error

        new = float(min(max(new, 0.0), 1.0))
        self.controller.set_intensity(self.channel, new)
        return new

    def calibrate(self, measure_fn, max_iters: int = 50) -> float:
        """Run the loop with a measurement callback until converged."""
        for _ in range(max_iters):
            brightness = measure_fn()
            error = abs(self.target - brightness)
            if error <= self.tolerance:
                break
            self.step(brightness)
        return self.controller.get_channel_state(self.channel).intensity


class UniformityCalibrator:
    """Illumination-uniformity correction map
    (reference calibration/uniformity.rs:76-330).

    ``build_map`` averages reference frames of a white target and derives a
    per-pixel multiplicative correction toward the mean; the map is applied
    on device as one elementwise multiply fused into the inspection
    preprocess.
    """

    def __init__(self, smoothing_kernel: int = 31,
                 clip_range: Tuple[float, float] = (0.5, 2.0)):
        self.smoothing_kernel = smoothing_kernel
        self.clip_range = clip_range
        self.correction_map: Optional[np.ndarray] = None

    def build_map(self, reference_frames: np.ndarray) -> np.ndarray:
        """reference_frames: [N, H, W] uint8 of a uniform target."""
        mean_img = reference_frames.astype(np.float64).mean(axis=0)
        # heavy smoothing to capture illumination falloff, not texture
        k = self.smoothing_kernel
        kernel = np.ones(k) / k
        sm = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="same"), 0, mean_img)
        sm = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="same"), 1, sm)
        target = sm.mean()
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.where(sm > 1.0, target / sm, 1.0)
        self.correction_map = np.clip(corr, *self.clip_range) \
            .astype(np.float32)
        return self.correction_map

    def uniformity_score(self, frame: np.ndarray) -> float:
        """1 - coefficient-of-variation (higher = more uniform)."""
        f = frame.astype(np.float64)
        return float(1.0 - f.std() / max(f.mean(), 1e-9))

    def apply(self, frame: np.ndarray) -> np.ndarray:
        """Host-side application (reference behavior)."""
        if self.correction_map is None:
            return frame
        out = frame.astype(np.float32) * self.correction_map
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)

    def save(self, path: str) -> None:
        """Persist the correction map (calibration artifact —
        the checkpoint/resume surface of SURVEY.md §5)."""
        if self.correction_map is None:
            raise ValueError("no correction map built")
        np.save(path, self.correction_map)

    def load(self, path: str) -> np.ndarray:
        self.correction_map = np.load(path)
        return self.correction_map

    def apply_on_device(self, frames, device=None):
        """Device-side application on a [N, H, W(, C)] uint8 batch: float32
        multiply, round half to even, clamp, uint8 (``apply``'s numbers).

        A tensor is corrected on its own device; a numpy batch is uploaded
        to ``device`` first (CUDA unless "cpu" is named; raises where there
        is no card).  Without a map the frames come back unchanged."""
        if self.correction_map is None:
            return frames
        if not isinstance(frames, torch.Tensor):
            from heimdall_tpu_torch.detectors.contamination_detector import (
                resolve_device)
            frames = torch.from_numpy(np.ascontiguousarray(frames)).to(
                resolve_device(device))
        corr = torch.from_numpy(self.correction_map).to(frames.device)
        if frames.dim() == 4:
            corr = corr[..., None]
        out = frames.to(torch.float32) * corr
        return torch.round(out).clamp_(0, 255).to(torch.uint8)
