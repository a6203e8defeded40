"""The port's Bayer demosaic and YUV422 conversion (ops/demosaic.py)
against heimdall_tpu's (JAX on the CPU): exactly equal to the JAX functions
run eagerly (jax.disable_jit), for the four Bayer patterns, odd sizes and
extra batch axes.  Against the jitted functions, which XLA may rewrite
(fused multiply-adds), the differing pixels are counted and printed (0 on
these frames when written).  The port runs on the CPU.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from heimdall_tpu.ops import demosaic as jdemosaic

from heimdall_tpu_torch.ops import demosaic

PATTERNS = ("rg", "gr", "gb", "bg")
# mosaic shapes: odd sizes, one row or column, extra batch axes
RAW_SHAPES = ((37, 53), (1, 7), (6, 1), (2, 3, 17, 29), (3, 24, 32))
# YUYV shapes [..., H, 2W] (JAX's chroma upsampling needs an even W)
YUV_SHAPES = ((37, 2 * 54), (1, 4), (2, 3, 17, 2 * 30))


def _raw(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_bayer(shape, pattern, jit):
    raw = _raw(shape)
    if jit:
        return np.asarray(jdemosaic.demosaic_bilinear(raw, pattern))
    with jax.disable_jit():
        return np.asarray(jdemosaic.demosaic_bilinear(raw, pattern))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("shape", RAW_SHAPES)
def test_demosaic_equals_eager_jax(shape, pattern):
    raw = _raw(shape)
    got = demosaic.demosaic_bilinear(torch.from_numpy(raw), pattern)
    assert got.dtype == torch.uint8 and got.shape == shape + (3,)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_bayer(shape, pattern, False))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_demosaic_flips_against_jit(pattern):
    shape = (3, 24, 32)
    got = demosaic.demosaic_bilinear(_raw(shape), pattern, device="cpu")
    flips = int((got.numpy() != _jax_bayer(shape, pattern, True)).sum())
    print(f"demosaic {pattern} {shape}: {flips} values differ from the "
          f"jitted JAX function")
    assert flips <= got.numel() // 1000


def test_demosaic_sites_keep_their_samples():
    raw = _raw((8, 10), seed=3)
    for pattern, (ry, rx) in demosaic._PATTERNS.items():
        bgr = demosaic.demosaic_bilinear(torch.from_numpy(raw),
                                         pattern).numpy()
        np.testing.assert_array_equal(bgr[ry::2, rx::2, 2],
                                      raw[ry::2, rx::2])
        np.testing.assert_array_equal(bgr[1 - ry::2, 1 - rx::2, 0],
                                      raw[1 - ry::2, 1 - rx::2])
    with pytest.raises(ValueError, match="unknown Bayer pattern"):
        demosaic.demosaic_bilinear(torch.from_numpy(raw), "xy")


@pytest.mark.parametrize("shape", YUV_SHAPES)
def test_yuv422_equals_eager_jax(shape):
    yuv = _raw(shape, seed=1)
    with jax.disable_jit():
        want = np.asarray(jdemosaic.yuv422_to_bgr(yuv))
    got = demosaic.yuv422_to_bgr(torch.from_numpy(yuv))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    jitted = np.asarray(jdemosaic.yuv422_to_bgr(yuv))
    flips = int((got.numpy() != jitted).sum())
    print(f"yuv422 {shape}: {flips} values differ from the jitted JAX "
          f"function")
    assert flips <= max(got.numel() // 1000, 1)


def test_numpy_input_goes_to_the_named_device():
    raw = _raw((4, 6))
    out = demosaic.demosaic_bilinear(raw, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert demosaic.yuv422_to_bgr(_raw((2, 8)), device="cpu").shape == (
        2, 4, 3)
    if torch.cuda.is_available():
        pytest.skip("holds the no-card error")
    for call in (lambda: demosaic.demosaic_bilinear(raw),
                 lambda: demosaic.yuv422_to_bgr(_raw((2, 8)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
