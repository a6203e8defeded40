"""The port's tiled detection program against heimdall_tpu's (JAX on the
CPU; its tiled route runs the Pallas kernels in interpret mode).

The same seeded frames go through JAX's contamination_program with
tiled_band=32 (band-tiled fill, labeling and stats; for BGR frames its
run-table route B2/B3) and tiled_band=0 (whole-frame XLA), and through the
port's contamination_program(tiled_band=32) on the CPU, i.e. through the
plain PyTorch versions of the CUDA kernels.  Integer and boolean table
fields and the gates are equal exactly; float fields and the confidence
are within 1e-6 of jitted XLA (it rewrites x / 30 as x * (1/30)).

This slice has no parameters, so no weights are carried across; the
detector's config carries over through config_from_reference, and the
tiled route reads the same keys as the fused one.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heimdall_tpu.detectors.contamination_detector import (
    contamination_program as jax_program)

from heimdall_tpu_torch.detectors import contamination_detector as det_mod
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector, config_from_reference, contamination_program)

GATES = (15, 3.0, 3000.0, 0.2)


def _frames(n, h, w, seed):
    """Light BGR frames with dark colored discs, some over band borders."""
    rng = np.random.RandomState(seed)
    frames = np.full((n, h, w, 3), 215, np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        for _ in range(5):
            cy, cx = rng.randint(8, h - 8), rng.randint(8, w - 8)
            r = rng.randint(2, 7)
            frames[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = (
                rng.randint(0, 90), rng.randint(0, 90), rng.randint(0, 90))
    return frames


BGR = _frames(2, 90, 128, seed=7)       # 90 rows: a short last band at 32
MONO = np.ascontiguousarray(BGR[..., 1])


@functools.lru_cache(maxsize=None)
def _jax(form, tiled_band):
    x = BGR if form == "bgr" else MONO
    ct, lo, hi, conf = GATES
    out = jax_program(jnp.asarray(x), jnp.int32(ct), jnp.float32(lo),
                      jnp.float32(hi), jnp.float32(conf), return_labels=True,
                      tiled_band=tiled_band)
    table = type(out[0])(*(np.asarray(f) for f in out[0]))
    return (table,) + tuple(np.asarray(a) for a in out[1:])


def _assert_outputs(want, got):
    (wt, wc, wa, wl), (gt, gc, ga, gl) = want, got
    for f in wt._fields:
        a, b = getattr(wt, f), getattr(gt, f).numpy()
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_allclose(gc.numpy(), wc, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ga.numpy(), wa)
    np.testing.assert_array_equal(gl.numpy(), wl)


@pytest.mark.parametrize("jax_band", [32, 0])
@pytest.mark.parametrize("form", ["mono8", "bgr"])
def test_tiled_program_matches_jax(form, jax_band):
    x = BGR if form == "bgr" else MONO
    got = contamination_program(torch.from_numpy(x), *GATES,
                                return_labels=True, tiled_band=32)
    _assert_outputs(_jax(form, jax_band), got)
    assert got[2].any() and int(got[0].n_blobs.min()) > 0


@pytest.mark.parametrize("form", ["mono8_planes", "bgr_planes"])
def test_tiled_program_channel_major(form):
    if form == "bgr_planes":
        x = BGR.transpose(0, 3, 1, 2)
    else:
        x = MONO[:, None]
    got = contamination_program(torch.from_numpy(np.ascontiguousarray(x)),
                                *GATES, return_labels=True, tiled_band=32,
                                channel_major=True)
    _assert_outputs(_jax(form.split("_")[0].replace("mono8", "mono"), 32),
                    got)


def _big_mono():
    """1 x 401 x 1000 Mono8: just over the fused route's 400,000 px."""
    return np.ascontiguousarray(_frames(1, 401, 1000, seed=11)[..., 2])


def test_large_frame_takes_tiled_route_on_cpu(monkeypatch):
    calls = []
    real = det_mod.fill_holes_tiled

    def spy(*a, **k):
        calls.append(k.get("band"))
        return real(*a, **k)

    monkeypatch.setattr(det_mod, "fill_holes_tiled", spy)
    cfg = {"include_contours": False, "contrast_threshold": 12,
           "min_contaminant_size": 5, "max_contaminant_size": 400,
           "min_confidence": 0.3, "max_blobs": 16, "backend": "pallas"}
    det = ContaminationDetector(config=config_from_reference(cfg),
                                device="cpu")
    frame = _big_mono()
    got = det.run_device(frame, return_labels=True)
    assert calls == [det_mod.TILED_BAND]
    want = contamination_program(torch.from_numpy(frame), 12, 5.0, 400.0,
                                 0.3, max_blobs=16, return_labels=True,
                                 tiled_band=0)
    for f in want[0]._fields:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    assert int(got[0].n_blobs[0]) > 0 and got[3].shape == (1, 401, 1000)
    # the channel-major Mono8 form takes the same route
    planes = det.run_device(frame[:, None], channel_major=True)
    assert calls == [det_mod.TILED_BAND] * 2
    assert torch.equal(planes[1], got[1])


def test_detect_batch_with_contours_on_large_frames():
    det = ContaminationDetector(config={"min_contaminant_size": 5},
                                device="cpu")
    defects = det.detect_batch(_big_mono())
    assert defects[0] and all("contour" in d.metadata for d in defects[0])
    reject, conf = det.verdict_device(_big_mono())
    assert bool(reject[0]) and float(conf[0]) > 0.3


def test_int32_sum_bound_raises():
    frame = np.full((1, 2, 250_000), 200, np.uint8)      # 500,000 px
    with pytest.raises(ValueError, match="int32"):
        ContaminationDetector(device="cpu").run_device(frame)
    with pytest.raises(ValueError, match="int32"):
        contamination_program(torch.zeros((1, 4, 40_000), dtype=torch.uint8),
                              *GATES, tiled_band=32)
