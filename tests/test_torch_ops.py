"""The port's plain PyTorch ops against heimdall_tpu.ops (JAX on the CPU).

Same numpy inputs, made from a seed, go to both; integer planes, labels,
counts, bboxes and gates must be exactly equal.  The blob table's float
fields are the same float32 formulas in the same order on both sides; they
are held to 1e-6 (absolute) only because XLA's CPU codegen under jit may
replace a division by a constant with a multiplication by its reciprocal.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heimdall_tpu import ops as jops
from heimdall_tpu.ops import blobs as jblobs
from heimdall_tpu.ops import ccl as jccl
from heimdall_tpu.ops import filters as jfilters

from heimdall_tpu_torch.ops import blobs, ccl, color, filters, morphology
# the module: the package exports its function of the same name
threshold = importlib.import_module("heimdall_tpu_torch.ops.threshold")
from heimdall_tpu_torch.scene import adversarial_masks

SIZES = [(64, 128), (48, 96), (56, 72)]


def _gray(h, w, seed):
    rng = np.random.RandomState(seed)
    # smooth structure plus noise, so thresholds and morphology have work
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    return np.clip(base + rng.randint(-40, 40, (2, h, w)), 0,
                   255).astype(np.uint8)


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


# The JAX references are computed once per frame size, in one jitted
# program each where the result is integer arithmetic (eager JAX compiles
# every primitive per shape).  The float32 mean11 and the thresholds built
# on it run eagerly: XLA's CPU fusion under jit rounds the sequential tap
# sum differently (it flips one rint in the 48x96 case), while eager JAX,
# the Pallas kernel and the port all sum strictly in sequence.
KSIZES = (3, 5, 7, 11)
THRESH = (("binary_inv", 15), ("binary_inv", 2.5), ("binary", 2),
          ("binary", -3.5))
MORPH_OPS = ("erode", "dilate", "open", "close", "gradient", "tophat",
             "blackhat")
SES = (("rect", 3), ("cross", 5), ("ellipse", 5))
MASK_NAMES = ("random0.3", "random0.5", "random0.7", "noise", "spiral",
              "rings", "edges")


@functools.lru_cache(maxsize=None)
def _jax_filters(h, w):
    g = jnp.asarray(_gray(h, w, 1))
    out = jax.jit(lambda g: {("blur", k): jops.gaussian_blur(g, k, 0)
                             for k in KSIZES})(g)
    out[("mean", 11)] = jfilters.gaussian_mean_u8(g, 11)
    for tt, c in THRESH:
        out[("thr", tt, c)] = jops.adaptive_threshold(
            g, 255, "gaussian", tt, 11, c)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("h,w", SIZES)
def test_bgr_to_gray(h, w):
    x = np.random.RandomState(0).randint(0, 256, (2, h, w, 3)).astype(np.uint8)
    _eq(jax.jit(jops.bgr_to_gray)(jnp.asarray(x)),
        color.bgr_to_gray(torch.from_numpy(x)))


@pytest.mark.parametrize("ksize", KSIZES)
@pytest.mark.parametrize("h,w", SIZES)
def test_gaussian_blur_u8(h, w, ksize):
    _eq(_jax_filters(h, w)[("blur", ksize)],
        filters.gaussian_blur(torch.from_numpy(_gray(h, w, 1)), ksize, 0))


def test_gaussian_blur_color_channels():
    x = np.random.RandomState(2).randint(0, 256, (2, 48, 96, 3)).astype(
        np.uint8)
    _eq(jax.jit(lambda a: jops.gaussian_blur(a, 5, 0))(jnp.asarray(x)),
        filters.gaussian_blur(torch.from_numpy(x), 5, 0))


@pytest.mark.parametrize("h,w", SIZES)
def test_gaussian_mean_u8(h, w):
    _eq(_jax_filters(h, w)[("mean", 11)],
        filters.gaussian_mean_u8(torch.from_numpy(_gray(h, w, 1)), 11))


def test_taps_equal_jax():
    """Q8 taps (5 and 11) and the float32 mean11 taps equal the JAX
    package's: the detector's only host-computed state."""
    for k in (5, 11):
        kern = jfilters.gaussian_kernel_1d(k, 0.0)
        np.testing.assert_array_equal(filters.gaussian_kernel_1d(k, 0.0), kern)
        assert filters._q8_taps(kern) == jfilters._q8_taps(kern)
        assert (filters._q8_taps_bitexact(kern)
                == jfilters._q8_taps_bitexact(kern))
    k11 = np.asarray([float(t) for t in jfilters.gaussian_kernel_1d(11, 0.0)],
                     np.float32)
    np.testing.assert_array_equal(np.asarray(filters.f32_taps(11), np.float32),
                                  k11)


@pytest.mark.parametrize("ttype,c", THRESH)
@pytest.mark.parametrize("h,w", SIZES)
def test_adaptive_threshold(h, w, ttype, c):
    _eq(_jax_filters(h, w)[("thr", ttype, c)],
        threshold.adaptive_threshold(torch.from_numpy(_gray(h, w, 1)), 255,
                                     "gaussian", ttype, 11, c))


@functools.lru_cache(maxsize=None)
def _jax_morphology():
    def run(g):
        return {(op, se): jops.morphology_ex(
            g, op, jops.structuring_element(*se))
            for op in MORPH_OPS for se in SES}
    return {k: np.asarray(v)
            for k, v in jax.jit(run)(jnp.asarray(_gray(48, 96, 5))).items()}


@pytest.mark.parametrize("op", MORPH_OPS)
@pytest.mark.parametrize("se", SES)
def test_morphology(op, se):
    np.testing.assert_array_equal(jops.structuring_element(*se),
                                  morphology.structuring_element(*se))
    _eq(_jax_morphology()[(op, se)],
        morphology.morphology_ex(torch.from_numpy(_gray(48, 96, 5)), op,
                                 morphology.structuring_element(*se)))


@functools.lru_cache(maxsize=None)
def _masks(h, w):
    """[7, h, w] bool: random masks at three densities plus the
    adversarial shapes, in MASK_NAMES order."""
    rng = np.random.RandomState(h * w)
    out = {f"random{d}": rng.rand(h, w) < d for d in (0.3, 0.5, 0.7)}
    out.update(adversarial_masks(h, w, seed=7))
    return np.stack([out[n] for n in MASK_NAMES])


@functools.lru_cache(maxsize=None)
def _jax_labels(h, w):
    def run(m):
        return {"fill": jccl.fill_holes(m),
                "cc8": jops.connected_components(m, connectivity=8),
                "cc4": jops.connected_components(m, connectivity=4)}
    return {k: np.asarray(v)
            for k, v in jax.jit(run)(jnp.asarray(_masks(h, w))).items()}


MASK_CASES = [(h, w, i, name) for (h, w) in SIZES
              for i, name in enumerate(MASK_NAMES)]


@pytest.mark.parametrize("h,w,i,name", MASK_CASES)
def test_fill_holes(h, w, i, name):
    _eq(_jax_labels(h, w)["fill"][i],
        ccl.fill_holes(torch.from_numpy(_masks(h, w)[i])))


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("h,w,i,name", MASK_CASES)
def test_connected_components(h, w, i, name, connectivity):
    _eq(_jax_labels(h, w)[f"cc{connectivity}"][i],
        ccl.connected_components(torch.from_numpy(_masks(h, w)[i]),
                                 connectivity=connectivity))


def test_rings_absorb_the_blob_in_their_hole():
    m = adversarial_masks(64, 128)["rings"]
    filled = ccl.fill_holes(torch.from_numpy(m))
    labels = ccl.connected_components(filled)
    lin = torch.arange(64 * 128).view(64, 128)
    assert int((filled & (labels == lin)).sum()) == 1   # one filled disc
    assert int(filled.sum()) > int(m.sum())


@functools.lru_cache(maxsize=None)
def _blob_inputs(h, w):
    """Hole-filled masks, their labels, gray and color planes (numpy)."""
    rng = np.random.RandomState(11)
    m = _jax_labels(h, w)["fill"]
    lab = np.asarray(jax.jit(jops.connected_components)(jnp.asarray(m)))
    gray = rng.randint(0, 256, m.shape).astype(np.uint8)
    col = rng.randint(0, 256, m.shape + (3,)).astype(np.uint8)
    return m, lab, gray, col


@functools.lru_cache(maxsize=None)
def _jax_blob_stats(h, w, K, with_color):
    m, lab, gray, col = _blob_inputs(h, w)

    def run(lab, m, gray, col):
        t = jblobs.blob_stats(lab, m, gray, col if with_color else None,
                              max_blobs=K)
        return (t, jblobs.confidence_python(t), jblobs.confidence_native(t))
    out = jax.jit(run)(*map(jnp.asarray, (lab, m, gray, col)))
    return jax.tree_util.tree_map(np.asarray, out)


BLOB_CASES = [(h, w, i, MASK_NAMES[i]) for (h, w) in ((64, 128), (56, 72))
              for i in (0, 3, 4, 5, 6)]


@pytest.mark.parametrize("with_color", [True, False])
@pytest.mark.parametrize("K", [4, 64])
@pytest.mark.parametrize("h,w,i,name", BLOB_CASES)
def test_blob_stats(h, w, i, name, K, with_color):
    m, lab, gray, col = (torch.from_numpy(a.copy()) for a in _blob_inputs(h, w))
    want, jconf_py, jconf_nat = _jax_blob_stats(h, w, K, with_color)
    got = blobs.blob_stats(lab, m, gray, col if with_color else None,
                           max_blobs=K)
    if name == "noise" and K == 4:
        assert int(got.n_blobs[i]) > K     # overflow: only K slots filled
    for f in want._fields:
        a, b = getattr(want, f)[i], getattr(got, f)[i].numpy()
        if a.dtype == np.float32:
            # XLA's CPU codegen under jit turns x / 30 into x * (1/30)
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_allclose(blobs.confidence_python(got)[i].numpy(),
                               jconf_py[i], atol=1e-6, rtol=0)
    np.testing.assert_allclose(blobs.confidence_native(got)[i].numpy(),
                               jconf_nat[i], atol=1e-6, rtol=0)
