"""The port's ContaminationDetector against heimdall_tpu's (JAX on the CPU).

The JAX detector runs its default XLA route here; the port runs with
device="cpu", i.e. through the plain PyTorch version of the fused kernel.
"""

import numpy as np
import pytest
import torch

from heimdall_tpu.detectors.contamination_detector import (
    ContaminationDetector as JaxDetector)

import heimdall_tpu_torch
from heimdall_tpu_torch.detectors.contamination_detector import (
    TPU_TUNING_KEYS, ContaminationDetector, config_from_reference)
from heimdall_tpu_torch.ops import fused_kernels


def _frames(n=3, h=64, w=128, seed=5):
    """Light frames with dark discs large enough to pass the size gate."""
    rng = np.random.RandomState(seed)
    frames = np.full((n, h, w, 3), 215, np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        for _ in range(3):
            y, x = rng.randint(6, h - 6), rng.randint(6, w - 6)
            r = rng.randint(2, 8)
            frames[i][(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = (
                rng.randint(0, 90), rng.randint(0, 90), rng.randint(0, 90))
    return frames


FRAMES = _frames()
CFG = {"include_contours": False}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_outputs(want, got):
    """(table, conf, accepted) of both detectors: integers and gates equal,
    floats within 1e-6."""
    (wt, wc, wa), (gt, gc, ga) = want, got
    for f in wt._fields:
        a, b = _np(getattr(wt, f)), _np(getattr(gt, f))
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_allclose(_np(gc), _np(wc), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_np(ga), _np(wa))


FORMS = {
    "nhwc": (FRAMES, False),
    "channel_major": (np.ascontiguousarray(FRAMES.transpose(0, 3, 1, 2)),
                      True),
    "mono8": (np.ascontiguousarray(FRAMES[..., 1]), False),
    "mono8_planes": (np.ascontiguousarray(FRAMES[:, None, :, :, 1]), True),
    "uint16": (FRAMES.astype(np.uint16) * 257 + 3, False),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_run_device_input_forms(form):
    x, cm = FORMS[form]
    want = JaxDetector(config=CFG).run_device(x, channel_major=cm)
    got = ContaminationDetector(config=CFG, device="cpu").run_device(
        x, channel_major=cm)
    _assert_outputs(want, got)
    assert _np(got[2]).any()


def test_verdict_device():
    want = JaxDetector(config=CFG).verdict_device(FRAMES)
    got = ContaminationDetector(config=CFG, device="cpu").verdict_device(
        FRAMES)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6, rtol=0)
    assert got[0].any()


def _assert_defects(want, got):
    assert len(want) == len(got)
    for dw, dg in zip(want, got):
        assert [d.position for d in dg] == [d.position for d in dw]
        for a, b in zip(dw, dg):
            assert b.defect_type == a.defect_type
            assert b.size == pytest.approx(a.size, abs=1e-6)
            assert b.confidence == pytest.approx(a.confidence, abs=1e-6)
            assert set(b.metadata) == set(a.metadata)
            for k, v in a.metadata.items():
                if isinstance(v, float):
                    assert b.metadata[k] == pytest.approx(v, abs=1e-6), k
                else:
                    assert b.metadata[k] == v, k


@pytest.mark.parametrize("exact", ["auto", False])
def test_detect_batch_with_contours(exact):
    cfg = {"include_contours": True, "exact_geometry": exact}
    want = JaxDetector(config=cfg).detect_batch(FRAMES)
    got = ContaminationDetector(config=cfg, device="cpu").detect_batch(FRAMES)
    assert sum(len(d) for d in got) > 0
    assert all("contour" in d.metadata for ds in got for d in ds)
    _assert_defects(want, got)


def test_detect_and_visualize():
    cfg = {"include_contours": True}
    jd = JaxDetector(config=cfg)
    td = ContaminationDetector(config=cfg, device="cpu")
    want, got = jd.detect(FRAMES[0]), td.detect(FRAMES[0])
    _assert_defects([want], [got])
    np.testing.assert_array_equal(td.visualize(FRAMES[0], got),
                                  jd.visualize(FRAMES[0], want))


def test_config_from_reference():
    ref_cfg = {"min_contaminant_size": 12, "max_contaminant_size": 2500,
               "contrast_threshold": 11, "min_confidence": 0.3,
               "use_color": False, "max_blobs": 32,
               "confidence_formula": "native", "include_contours": False,
               "exact_geometry": True, "backend": "xla", "ccl_sweeps": 4,
               "ccl_adaptive": False, "ccl_scan_steps": 3, "rt_ccl": 8,
               "rt_fill": 12}
    cfg = config_from_reference(ref_cfg)
    assert not set(cfg) & {"backend", "ccl_sweeps", "ccl_adaptive",
                           "ccl_scan_steps", "rt_ccl", "rt_fill"}
    ref = JaxDetector(config=ref_cfg)
    port = ContaminationDetector(config=cfg, device="cpu")
    for attr in ("min_contaminant_size", "max_contaminant_size",
                 "contrast_threshold", "min_confidence", "use_color",
                 "max_blobs", "formula", "include_contours",
                 "exact_geometry"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    _assert_outputs(ref.run_device(FRAMES), port.run_device(FRAMES))


@pytest.mark.parametrize("steps", [0, -1, None, 5])
def test_ccl_scan_steps_checked_as_in_jax(steps):
    """ccl_scan_steps of 0 or less raises the JAX detector's ValueError,
    with its message; None and values >= 1 are accepted (and ignored)."""
    cfg = dict(CFG, ccl_scan_steps=steps)
    if steps is not None and steps < 1:
        with pytest.raises(ValueError) as want:
            JaxDetector(config=cfg)
        with pytest.raises(ValueError) as got:
            ContaminationDetector(config=cfg, device="cpu")
        assert str(got.value) == str(want.value)
        return
    JaxDetector(config=cfg)
    port = ContaminationDetector(config=cfg, device="cpu")
    assert "ccl_scan_steps" in TPU_TUNING_KEYS
    assert "ccl_scan_steps" not in config_from_reference(cfg)
    table, _, _ = port.run_device(FRAMES[:1])
    assert table.n_blobs.shape == (1,)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContaminationDetector(config=CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContaminationDetector(config=CFG, device="cuda")


def test_large_frames_need_the_tiled_slice_on_the_card():
    x = torch.zeros((1, 700, 600), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="2 MP"):
        fused_kernels._launch(x, 15, 64, False, False)
    # the plain path on the CPU takes any size
    table, conf, accepted = ContaminationDetector(
        config=CFG, device="cpu").run_device(x.numpy())
    assert table.n_blobs.tolist() == [0] and conf.shape == (1, 64)


def test_package_exports():
    assert heimdall_tpu_torch.ContaminationDetector is ContaminationDetector
    assert heimdall_tpu_torch.BlobTable._fields[-1] == "n_blobs"
    d = heimdall_tpu_torch.Defect("contamination", (1, 2), 3.0, 0.5)
    assert d.to_dict()["position"] == (1, 2)
