"""The port's pipeline ops against heimdall_tpu.ops (JAX on the CPU):
fixed, Otsu, Triangle and adaptive thresholds, box blur and mean, Sobel,
Canny, gray_to_bgr, equalizeHist, CLAHE and the Hough transform.

Same numpy inputs, made from a seed, go to both; every output is an
integer plane, a threshold or a count, and must be exactly equal.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heimdall_tpu.ops import color as jcolor
from heimdall_tpu.ops import filters as jfilters
from heimdall_tpu.ops import histogram as jhist
from heimdall_tpu.ops import hough as jhough
jthresh = importlib.import_module("heimdall_tpu.ops.threshold")

from heimdall_tpu_torch.ops import color, filters, histogram, hough
# the module: the package exports its function of the same name
threshold = importlib.import_module("heimdall_tpu_torch.ops.threshold")

SIZES = [(48, 64), (120, 160), (61, 93)]


def _gray(h, w, seed, n=2):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 70 * np.sin(xx / 6.0) * np.cos(yy / 9.0)
    return np.clip(base + rng.randint(-50, 50, (n, h, w)), 0,
                   255).astype(np.uint8)


def _bimodal(h, w, seed, n=2):
    """Dark discs on a light ground with noise: histograms with two modes
    and a long tail, where Otsu and Triangle have work."""
    rng = np.random.RandomState(seed)
    out = np.clip(rng.normal(190, 12, (n, h, w)), 0, 255)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        for _ in range(4):
            y, x, r = rng.randint(0, h), rng.randint(0, w), rng.randint(4, 14)
            out[i][(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = rng.normal(
                60, 15)
    return out.astype(np.uint8)


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


@pytest.mark.parametrize("hw", SIZES[:2])
@pytest.mark.parametrize("method", ["binary", "binary_inv", "trunc",
                                    "tozero", "tozero_inv"])
@pytest.mark.parametrize("t,mv", [(127, 255), (49.5, 200), (50.5, 255.6)])
def test_threshold(hw, method, t, mv):
    img = _gray(*hw, seed=1)
    _eq(jthresh.threshold(jnp.asarray(img), t, mv, method),
        threshold.threshold(torch.from_numpy(img), t, mv, method))


def test_threshold_unknown_method_raises_as_in_jax():
    img = _gray(8, 8, seed=0)
    with pytest.raises(ValueError, match="unknown threshold method"):
        jthresh.threshold(jnp.asarray(img), 1, 255, "bogus")
    with pytest.raises(ValueError, match="unknown threshold method"):
        threshold.threshold(torch.from_numpy(img), 1, 255, "bogus")


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("auto", ["otsu", "triangle"])
@pytest.mark.parametrize("method", ["binary", "binary_inv"])
@pytest.mark.parametrize("kind", ["gray", "bimodal"])
def test_threshold_auto(hw, auto, method, kind):
    img = (_gray if kind == "gray" else _bimodal)(*hw, seed=2, n=3)
    jt, jo = jthresh.threshold_auto(jnp.asarray(img), 255, method, auto)
    tt, to = threshold.threshold_auto(torch.from_numpy(img), 255, method,
                                      auto)
    _eq(jt, tt)
    _eq(jo, to)


@pytest.mark.parametrize("hw", SIZES)
def test_histogram256(hw):
    img = _gray(*hw, seed=3)
    _eq(jthresh.histogram256(jnp.asarray(img)),
        threshold.histogram256(torch.from_numpy(img)))


@pytest.mark.parametrize("hw", SIZES[:2])
@pytest.mark.parametrize("ttype,c", [("binary", 2), ("binary_inv", 2.5),
                                     ("binary", -3.5)])
@pytest.mark.parametrize("block", [3, 11])
def test_adaptive_threshold_mean(hw, ttype, c, block):
    img = _gray(*hw, seed=4)
    _eq(jthresh.adaptive_threshold(jnp.asarray(img), 255, "mean", ttype,
                                   block, c),
        threshold.adaptive_threshold(torch.from_numpy(img), 255, "mean",
                                     ttype, block, c))


def test_adaptive_threshold_unknown_method_raises_as_in_jax():
    img = _gray(8, 8, seed=0)
    with pytest.raises(ValueError, match="unknown adaptive method"):
        jthresh.adaptive_threshold(jnp.asarray(img), 255, "median")
    with pytest.raises(ValueError, match="unknown adaptive method"):
        threshold.adaptive_threshold(torch.from_numpy(img), 255, "median")


@pytest.mark.parametrize("hw", SIZES[:2])
@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("border", ["reflect101", "replicate"])
@pytest.mark.parametrize("normalize", [True, False])
def test_box_blur(hw, ksize, border, normalize):
    img = _gray(*hw, seed=5)
    _eq(jfilters.box_blur(jnp.asarray(img), ksize, border, normalize),
        filters.box_blur(torch.from_numpy(img), ksize, border, normalize))


def test_box_blur_bgr():
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (2, 48, 64, 3)).astype(np.uint8)
    _eq(jfilters.box_blur(jnp.asarray(img), 5),
        filters.box_blur(torch.from_numpy(img), 5))


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("d", [(1, 0), (0, 1)])
def test_sobel(hw, d):
    img = _gray(*hw, seed=7)
    _eq(jfilters.sobel(jnp.asarray(img), *d),
        filters.sobel(torch.from_numpy(img), *d))


@pytest.mark.parametrize("hw", SIZES[:2])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("t1,t2", [(50, 150), (30, 120), (120.5, 40.2)])
def test_canny(hw, l2, t1, t2):
    img = _gray(*hw, seed=8)
    _eq(jfilters.canny(jnp.asarray(img).astype(jnp.int32), t1, t2,
                       l2_gradient=l2),
        filters.canny(torch.from_numpy(img).to(torch.int32), t1, t2,
                      l2_gradient=l2))


def _spiral_frame(h=120, w=160):
    """A weak-contrast corridor wound as a spiral with a bright patch at its
    outer end: every edge of the corridor is a candidate, only the patch's
    are strong, so the hysteresis grows the edges around the whole spiral
    one pixel a round."""
    img = np.full((h, w), 100, np.uint8)
    y0, x0, y1, x1 = 4, 4, h - 5, w - 5
    while y1 - y0 > 8 and x1 - x0 > 8:
        img[y0, x0:x1] = 130
        img[y0:y1, x1] = 130
        img[y1, x0 + 4:x1 + 1] = 130
        img[y0 + 4:y1 + 1, x0 + 4] = 130
        y0, x0, y1, x1 = y0 + 8, x0 + 8, y1 - 8, x1 - 8
    img[2:7, 2:7] = 250
    return img


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("check_every", [1, 16, 1000])
def test_canny_many_hysteresis_rounds(monkeypatch, l2, check_every):
    img = _spiral_frame()
    t1, t2 = (40, 300) if not l2 else (40, 250)
    want = np.asarray(jfilters.canny(jnp.asarray(img).astype(jnp.int32),
                                     t1, t2, l2_gradient=l2))
    rounds = []
    dilate8 = filters._dilate8
    monkeypatch.setattr(filters, "_dilate8",
                        lambda a: rounds.append(1) or dilate8(a))
    monkeypatch.setattr(filters, "HYSTERESIS_CHECK_EVERY", check_every)
    got = filters.canny(torch.from_numpy(img).to(torch.int32), t1, t2,
                        l2_gradient=l2).numpy()
    np.testing.assert_array_equal(got, want)
    if check_every == 1:
        # the fixpoint takes many rounds: several checks at the default 16
        assert len(rounds) > 4 * 16
    else:
        assert len(rounds) % check_every == 0


@pytest.mark.parametrize("hw", SIZES)
def test_gray_to_bgr(hw):
    img = _gray(*hw, seed=9)
    _eq(jcolor.gray_to_bgr(jnp.asarray(img)),
        color.gray_to_bgr(torch.from_numpy(img)))
    bgr = np.stack([img] * 3, -1)
    _eq(jcolor.gray_to_bgr(jnp.asarray(bgr)),
        color.gray_to_bgr(torch.from_numpy(bgr)))


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("kind", ["gray", "bimodal", "constant"])
def test_equalize_hist(hw, kind):
    if kind == "constant":
        img = np.full((2,) + hw, 77, np.uint8)
    else:
        img = (_gray if kind == "gray" else _bimodal)(*hw, seed=10)
    _eq(jhist.equalize_hist(jnp.asarray(img)),
        histogram.equalize_hist(torch.from_numpy(img)))


@pytest.mark.parametrize("hw,clip,grid", [
    ((48, 64), 2.0, 8), ((48, 64), 4.0, 4), ((61, 93), 0.0, 8),
    ((120, 160), 1.0, 3)])
def test_clahe(hw, clip, grid):
    img = _bimodal(*hw, seed=11)
    _eq(jhist.clahe(jnp.asarray(img), clip, grid),
        histogram.clahe(torch.from_numpy(img), clip, grid))


def _edge_frames(h, w, seed):
    """Random edge pixels plus long lines at several angles."""
    rng = np.random.RandomState(seed)
    e = (rng.rand(2, h, w) < 0.05).astype(np.uint8) * 255
    e[0, h // 2, 3:w - 3] = 255
    e[0, 2:h - 2, w // 3] = 255
    for t in range(min(h, w) - 4):
        e[1, 2 + t, 2 + t] = 255
        e[1, h - 3 - t // 2, 2 + t] = 255
    return e


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("kind", ["random", "lines"])
def test_hough_accumulator(hw, kind):
    if kind == "random":
        e = (np.random.RandomState(12).rand(2, *hw) < 0.2).astype(
            np.uint8) * 255
    else:
        e = _edge_frames(*hw, seed=13)
    want = np.asarray(jhough.hough_accumulator(jnp.asarray(e)))
    got = hough.hough_accumulator(torch.from_numpy(e))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_hough_accumulator_with_xla_trig_table(monkeypatch):
    """The one divergence (ROADMAP.md §C): XLA's float32 cos and sin on the
    CPU are not correctly rounded at four of the 180 angles, and the port's
    table is.  With XLA's own table the port's votes equal JAX's on frames
    where the correctly rounded table moves a vote to the next rho bin."""
    thetas = jnp.arange(180, dtype=jnp.float32) * (math.pi / 180)
    xla = (np.asarray(jax.jit(jnp.cos)(thetas)),
           np.asarray(jax.jit(jnp.sin)(thetas)))
    mine = hough._trig_table(180)
    differ = sorted(set(np.nonzero(xla[0] != mine[0])[0])
                    | set(np.nonzero(xla[1] != mine[1])[0]))
    assert 0 < len(differ) <= 8
    e = (np.random.RandomState(2).rand(2, 240, 320) < 0.2).astype(
        np.uint8) * 255
    want = np.asarray(jhough.hough_accumulator(jnp.asarray(e)))
    own = hough.hough_accumulator(torch.from_numpy(e)).numpy()
    moved = np.argwhere(own != want)
    assert set(moved[:, 1]) <= set(differ)       # only those angles' votes
    monkeypatch.setattr(hough, "_trig_table", lambda bins: xla)
    np.testing.assert_array_equal(
        hough.hough_accumulator(torch.from_numpy(e)).numpy(), want)


@pytest.mark.parametrize("hw", [(120, 160), (61, 93)])
@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("args", [(40, 20, 5), (60, 50, 10), (100, 50, 10)])
def test_hough_lines_p(hw, frame, args):
    e = _edge_frames(*hw, seed=14)[frame]
    want = jhough.hough_lines_p(e, *args)
    got = hough.hough_lines_p(e, *args)
    assert got.dtype == np.int32 and got.shape[1:] == (1, 4)
    np.testing.assert_array_equal(got, want)
    got_t = hough.hough_lines_p(torch.from_numpy(e), *args, device="cpu")
    np.testing.assert_array_equal(got_t, want)
    for a, b in zip(jhough.hough_lines(e, args[0]),
                    hough.hough_lines(e, args[0])):
        np.testing.assert_array_equal(b, np.asarray(a))
