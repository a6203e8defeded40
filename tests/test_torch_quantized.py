"""The port's int8 U-Net (models/quantized.py) against heimdall_tpu's (JAX
on the CPU): the logits exact against JAX's forward run eagerly
(jax.disable_jit) on the same qparams, the probabilities within one
float32 ulp there (XLA's logistic and torch's sigmoid may round the last
bit apart); the calibration's int8 kernels equal and its activation scales
within 1e-6 relative; JAX's .npz files read by the port and the port's by
JAX.  The jitted JAX forward fuses its epilogue y * (s * w_scale) + bias
into multiply-adds, so round(v / s) flips at .5 from layer to layer: those
differences are counted and printed, not held.

The port runs with device="cpu"; the UNet's width is cut (base 8), the
frames are small and odd-sized.
"""

import functools

import jax
import numpy as np
import torch

from heimdall_tpu.models import quantized as jq

from heimdall_tpu_torch.models import quantized as tq
from heimdall_tpu_torch.models import segmentation as tseg

from test_torch_segmentation import (_frames, jax_segmenter,
                                     port_segmenter)

ULP_1 = 6e-8             # one float32 ulp just below 1.0


@functools.lru_cache(maxsize=None)
def _segmenters():
    theirs = jax_segmenter()
    return theirs, port_segmenter(theirs)


@functools.lru_cache(maxsize=None)
def _jax_quantized():
    return jq.QuantizedSegmenter.from_segmenter(_segmenters()[0],
                                                _frames()[0])


def _jax_logits_eager(qseg, images):
    """JAX's int8 forward run eagerly, without its final sigmoid."""
    sigmoid = jax.nn.sigmoid
    jax.nn.sigmoid = lambda v: v
    try:
        with jax.disable_jit():
            return qseg.predict(images)
    finally:
        jax.nn.sigmoid = sigmoid


def _port_logits(qseg, images):
    x, (H, W) = tseg._to_model_input(images, qseg.device)
    with torch.no_grad():
        out = tseg.unet_forward(
            qseg._qconv,
            lambda n, v: qseg._qconv(n, v, relu=False, transpose=True), x)
    return out[:, 0, :H, :W].numpy()


def test_quantized_forward_exact_against_eager_jax():
    frames = _frames()[0]
    jqs = _jax_quantized()
    mine = tq.QuantizedSegmenter(jax.device_get(jqs.qparams), device="cpu")
    want = _jax_logits_eager(jqs, frames)
    got = _port_logits(mine, frames)
    np.testing.assert_array_equal(got, want)
    assert (want > 0).any() and (want < 0).any()
    prob = mine.predict(frames)
    with jax.disable_jit():
        eager = jqs.predict(frames)
    assert prob.shape == frames.shape[:3] and prob.dtype == np.float32
    np.testing.assert_allclose(prob, eager, rtol=0, atol=ULP_1)
    jitted = jqs.predict(frames)
    flips = int((jitted != prob).sum())
    print(f"int8 forward: {flips} of {prob.size} probabilities differ from "
          f"the jitted JAX forward (max {np.abs(jitted - prob).max():.3g})")


def test_quantized_calibration_matches_jax():
    frames = _frames()[0]
    mine = tq.QuantizedSegmenter.from_segmenter(_segmenters()[1], frames)
    theirs = jax.device_get(_jax_quantized().qparams)
    assert mine.device == torch.device("cpu")
    assert set(mine.qparams) == set(theirs) == {n for n, _ in tq._LAYERS}
    for name, p in theirs.items():
        q = mine.qparams[name]
        assert q["kernel_q"].dtype == np.int8
        np.testing.assert_array_equal(q["kernel_q"], p["kernel_q"])
        np.testing.assert_array_equal(q["w_scale"], p["w_scale"])
        np.testing.assert_array_equal(q["bias"], p["bias"])
        np.testing.assert_allclose(q["act_scale"], p["act_scale"],
                                   rtol=1e-6, atol=0)


def test_quantized_npz_moves_both_ways(tmp_path):
    frames = _frames()[0]
    jqs = _jax_quantized()
    path = str(tmp_path / "jax_q.npz")
    jqs.save(path)
    mine = tq.QuantizedSegmenter.load(path, device="cpu")
    want = _jax_logits_eager(jqs, frames)
    np.testing.assert_array_equal(_port_logits(mine, frames), want)
    back = str(tmp_path / "port_q.npz")
    mine.save(back)
    a, b = np.load(path), np.load(back)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])
    theirs = jq.QuantizedSegmenter.load(back)
    np.testing.assert_array_equal(_jax_logits_eager(theirs, frames), want)


def test_int_convolutions_are_exact_past_float32():
    """The int8 products stay exact where a float32 sum would round:
    127^2 x 1152 terms > 2^24."""
    qx = torch.full((1, 128, 3, 3), 127.0, dtype=torch.float64)
    w = torch.full((2, 128, 3, 3), -127.0, dtype=torch.float64)
    acc = tq._int_conv_same(qx, w)
    assert int(acc[0, 0, 1, 1]) == -127 * 127 * 128 * 9
    assert int(acc[0, 1, 0, 0]) == -127 * 127 * 128 * 4
    wt = torch.full((128, 3, 2, 2), 127.0, dtype=torch.float64)
    up = tq._int_conv_transpose2(qx, wt)
    assert up.shape == (1, 3, 6, 6)
    assert int(up.abs().max()) == 127 * 127 * 128
