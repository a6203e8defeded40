"""System diagnostics with pass/fail gates (port of
heimdall_tpu/runtime/diagnostics.py).

Rebuilds the reference's diagnostics framework (rust/heimdall-gige/src/
diagnostics.rs:18-461): a DiagnosticReport aggregating per-subsystem tests
with the same gate values — acquisition fps >= 25 and latency <= 5 ms,
sync jitter < 100 us, image dynamic range >= 50 with no saturation — plus
the device checks: the device is reachable, a 16x16 product runs on it,
and the contamination detector finds a synthetic defect there.  The tests
keep the JAX package's names ("tpu_device", "compile_sanity", ...) so that
readers of saved reports find them; "tpu_device" names the platform in its
details.  The suite runs on CUDA unless it is given ``device="cpu"``, and
raises where there is no card.
"""

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# Reference gate values (diagnostics.rs:360,438 and SURVEY.md §6).
MIN_FPS = 25.0
MAX_LATENCY_MS = 5.0
MAX_SYNC_JITTER_US = 100.0
MIN_DYNAMIC_RANGE = 50
SATURATION_FRACTION = 0.25


@dataclasses.dataclass
class DiagnosticTest:
    name: str
    passed: bool
    details: Dict[str, Any]
    duration_s: float


@dataclasses.dataclass
class DiagnosticReport:
    timestamp: float
    tests: List[DiagnosticTest]

    @property
    def passed(self) -> bool:
        return all(t.passed for t in self.tests)

    def summary(self) -> str:
        n_pass = sum(t.passed for t in self.tests)
        lines = [f"Diagnostics: {n_pass}/{len(self.tests)} passed"]
        for t in self.tests:
            status = "PASS" if t.passed else "FAIL"
            lines.append(f"  [{status}] {t.name} ({t.duration_s*1000:.1f} ms)")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "timestamp": self.timestamp,
            "passed": self.passed,
            "tests": [dataclasses.asdict(t) for t in self.tests],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def _timed(name, fn) -> DiagnosticTest:
    start = time.time()
    try:
        passed, details = fn()
    except Exception as exc:  # noqa: BLE001 - diagnostics must not raise
        passed, details = False, {"error": str(exc)}
    return DiagnosticTest(name, passed, details, time.time() - start)


def check_device(device=None) -> DiagnosticTest:
    """The device is reachable: its platform ("cuda" or "cpu") and, for
    CUDA, every visible card's name."""
    def run():
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            n = torch.cuda.device_count()
            names = [torch.cuda.get_device_name(i) for i in range(n)]
        else:
            names = [str(dev)]
        return len(names) > 0, {"devices": names, "platform": dev.type}
    return _timed("tpu_device", run)


def check_compile_sanity(device=None) -> DiagnosticTest:
    """A 16x16 float32 product summed on the device is finite."""
    def run():
        dev = torch.device("cuda" if device is None else device)
        x = torch.arange(256, dtype=torch.float32, device=dev).reshape(16, 16)
        y = float((x @ x.T).sum())
        return bool(np.isfinite(y)), {"result": y}
    return _timed("compile_sanity", run)


def check_image_quality(frame: np.ndarray) -> DiagnosticTest:
    """Dynamic range >= 50 and < 25% saturated pixels
    (reference diagnostics.rs:385-423)."""
    def run():
        gray = frame if frame.ndim == 2 else frame.mean(axis=-1)
        lo, hi = int(gray.min()), int(gray.max())
        dynamic_range = hi - lo
        saturated = float((gray >= 250).mean())
        ok = dynamic_range >= MIN_DYNAMIC_RANGE and \
            saturated < SATURATION_FRACTION
        return ok, {"dynamic_range": dynamic_range,
                    "saturated_fraction": saturated}
    return _timed("image_quality", run)


def check_acquisition(feeder, n_frames: int = 30) -> DiagnosticTest:
    """fps >= 25 and queue latency <= 5 ms (reference diagnostics.rs:360)."""
    def run():
        start = time.time()
        got = 0
        while got < n_frames and time.time() - start < 5.0:
            if feeder.ring.pop() is not None:
                got += 1
            else:
                time.sleep(0.001)
        elapsed = time.time() - start
        fps = got / elapsed if elapsed > 0 else 0.0
        stats = feeder.stats()
        latency_ms = stats.get("latency_mean_us", 0) / 1000.0
        ok = fps >= MIN_FPS and latency_ms <= MAX_LATENCY_MS
        return ok, {"fps": fps, "latency_ms": latency_ms,
                    "frames": got, **stats}
    return _timed("acquisition", run)


def check_sync_jitter(feeder) -> DiagnosticTest:
    """Producer pacing jitter < 100 us (reference diagnostics.rs:426-461)."""
    def run():
        stats = feeder.stats()
        jitter = stats.get("pacing_jitter_mean_us", 0.0)
        return jitter < MAX_SYNC_JITTER_US, {"jitter_mean_us": jitter,
                                             "jitter_max_us":
                                             stats.get("pacing_jitter_max_us",
                                                       0.0)}
    return _timed("sync_jitter", run)


def check_detection_pipeline(device=None) -> DiagnosticTest:
    """End-to-end smoke: a synthetic defect must be detected on the
    device."""
    def run():
        from heimdall_tpu_torch.detectors.contamination_detector import (
            ContaminationDetector)
        from heimdall_tpu_torch.utils import draw
        img = np.full((128, 128, 3), 220, np.uint8)
        draw.filled_circle(img, (64, 64), 8, (30, 30, 30))
        det = ContaminationDetector(config={"include_contours": False},
                                    device=device)
        defects = det.detect(img)
        return len(defects) >= 1, {"defects": len(defects)}
    return _timed("detection_pipeline", run)


def run_diagnostics(feeder=None, frame: Optional[np.ndarray] = None,
                    include_detection: bool = True,
                    device=None) -> DiagnosticReport:
    """Run the diagnostic suite (subset depends on provided components) on
    ``device``: CUDA unless "cpu" is named; raises where there is no card.
    ``feeder``: any object with a ``ring.pop()`` and ``stats()``."""
    from heimdall_tpu_torch.detectors.contamination_detector import (
        resolve_device)
    device = resolve_device(device)
    tests = [check_device(device), check_compile_sanity(device)]
    if frame is not None:
        tests.append(check_image_quality(frame))
    if feeder is not None:
        tests.append(check_acquisition(feeder))
        tests.append(check_sync_jitter(feeder))
    if include_detection:
        tests.append(check_detection_pipeline(device))
    return DiagnosticReport(timestamp=time.time(), tests=tests)
