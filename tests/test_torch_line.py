"""The port's line examples on the CPU against heimdall_tpu's detector.

examples/line_simulation's ``main`` (two sets a batch) and ``latency_main``
(one set a batch) run for about a second at 96x128 with ``device="cpu"``;
every harvested batch's frames are kept, and its flags must equal JAX's
``verdict_device`` on the same frames exactly, its confidences to 1e-6
(XLA's CPU code is not a bit-exact float reference).  The simulated
cameras are deterministic (a defect every 5th frame), so most batches
repeat and JAX runs once per distinct batch.  The other three examples run
at the same size.
"""

import numpy as np
import pytest
import torch

from heimdall_tpu.detectors.contamination_detector import (
    ContaminationDetector as JaxDetector)
from heimdall_tpu_torch.examples import (gige_bottle_inspection,
                                         line_simulation,
                                         pet_bottle_inspection,
                                         realtime_processing)

H, W = 96, 128
# the JAX example's return keys (examples/line_simulation.py:203-208,
# :313-317)
JAX_MAIN_KEYS = {"net_bph", "h2d_mb_s", "net_p99_ms", "transfer_ms_per_batch",
                 "n_batches", "bottles", "rejects"}
JAX_LATENCY_KEYS = {"bottles", "floor_ms", "p99_ms", "net_p99_ms",
                    "net_p95_ms", "net_p50_ms", "rejects"}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the line's timed loops must not contend with
    the other test workers' threads for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_verdict():
    det = JaxDetector(config={"include_contours": False, "use_color": False,
                              "backend": "xla"})
    memo = {}

    def verdict(frames):
        key = (frames.shape, frames.tobytes())
        if key not in memo:
            flags, confs = det.verdict_device(frames)
            memo[key] = (np.asarray(flags), np.asarray(confs))
        return memo[key]

    return verdict


def _held(batches, jax_verdict, sets):
    rejects = 0
    for frames, flags, confs in batches:
        assert frames.shape == (4 * sets, H, W)
        want_flags, want_confs = jax_verdict(frames)
        np.testing.assert_array_equal(flags, want_flags)
        np.testing.assert_allclose(confs, want_confs, rtol=0, atol=1e-6)
        rejects += int(flags.reshape(sets, 4).any(axis=1).sum())
    return rejects


def _defect_sets(n):
    """The sets the cameras' defect falls on: frame ids 4, 9, ..."""
    return [i % 5 == 4 for i in range(n)]


def test_line_simulation_main_equals_jax(jax_verdict):
    # 5 sets a batch: every batch holds one defect set, however few the
    # run makes
    bph, p99, d = line_simulation.main(
        1.0, 5, width=W, height=H, return_detail=True, device="cpu",
        keep_batches=10_000)
    assert JAX_MAIN_KEYS <= set(d)
    batches = d["batches"]
    assert len(batches) == d["n_batches"] >= 1
    assert d["bottles"] == 5 * d["n_batches"]
    assert _held(batches, jax_verdict, 5) == d["rejects"] == d["n_batches"]
    flags = np.concatenate([b[1].reshape(5, 4)[:, 0] for b in batches])
    assert flags.tolist() == _defect_sets(len(flags))
    assert bph == pytest.approx(d["bottles"] / d["elapsed_s"] * 3600)
    assert p99 == d["p99_ms"] >= d["p95_ms"] >= d["p50_ms"] > 0
    assert d["floor_ms"] > 0


def test_line_simulation_latency_equals_jax(jax_verdict):
    d = line_simulation.latency_main(1.0, width=W, height=H,
                                     return_detail=True, device="cpu",
                                     keep_batches=10_000)
    assert JAX_LATENCY_KEYS <= set(d)
    assert len(d["batches"]) == d["bottles"] >= 1
    assert _held(d["batches"], jax_verdict, 1) == d["rejects"] == \
        sum(_defect_sets(d["bottles"]))
    assert d["p99_ms"] >= d["p95_ms"] >= d["p50_ms"] > 0
    assert d["floor_ms"] > 0


def test_line_simulation_without_detail():
    bph, p99 = line_simulation.main(0.3, 1, width=W, height=H,
                                    device="cpu")
    assert bph > 0 and p99 > 0
    assert line_simulation.latency_main(0.3, width=W, height=H,
                                        device="cpu") > 0


def test_gige_bottle_inspection_equals_jax():
    verdicts, diag = gige_bottle_inspection.main(
        ["--device", "cpu", "--triggers", "3", "--width", str(W),
         "--height", str(H)])
    # the checkerboard scene: JAX's detector on the cameras' frame
    from heimdall_tpu.camera.hal import SimulatedCamera
    cam = SimulatedCamera("c", {"width": W, "height": H, "fps": 10_000})
    cam.initialize()
    cam.start_acquisition()
    frames = [cam.acquire_frame().to_ndarray() for _ in range(3)]
    det = JaxDetector(config={"include_contours": False, "use_color": False,
                              "backend": "xla"})
    want = [["REJECT" if d else "pass" for d in
             det.detect_batch(np.stack([f] * 4))] for f in frames]
    assert verdicts == want
    # diag["pass"] gates on trigger jitter, which a loaded host can break
    assert diag["cameras"] == 4 and diag["frames_acquired"] == 52
    assert diag["acquisition_errors"] == 0 and diag["fps"] > 0


def test_realtime_processing_runs_on_the_native_ring():
    frames, defects, stats = realtime_processing.main(
        ["--device", "cpu", "--batches", "2", "--width", str(W),
         "--height", str(H)])
    assert 0 < frames <= 16 and defects >= 0
    assert stats["pops"] >= frames and "frames_produced" in stats


def test_pet_bottle_inspection_calibrates_each_point():
    summary = pet_bottle_inspection.main(["--device", "cpu", "--width",
                                          str(W), "--height", str(H)])
    assert set(summary) == set(pet_bottle_inspection.POINTS)
    for name, (intensity, defects) in summary.items():
        target = pet_bottle_inspection.POINTS[name]["target_brightness"]
        assert abs(255 * intensity - target) <= 2.0 and defects > 0
