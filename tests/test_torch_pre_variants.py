"""The port's preprocess probes (ops/pre_variants.py) against heimdall_tpu's.

The Pallas kernels of scripts/profile_preprocess.py (its "_roll" stages)
and scripts/profile_pre_variants.py are closures inside the scripts' main(),
so this file rebuilds their bodies from heimdall_tpu's own helpers
(pallas_kernels._conv_axis, _shift, _minmax3, pltpu.roll) and runs them with
tests/test_torch_split.py's interpret-mode harness on its 16 frames of
64x128 (bench cases, adversarial masks, the check_joint_label geometry).

* The roll stages (blur5_roll, mean11_roll, full_roll) and the variants
  cur, roll_conv, pair_sym and roll_pair: the plain versions equal the JAX
  bodies exactly, and the four variants equal the port's "pre" stage.
* mxu_conv: the plain version's f32 mean (float32 matrix products) is
  within 1e-3 of JAX's f32 dot_general on the CPU; its threshold differs
  from JAX's only where JAX's mean lies within 1e-3 of a half-integer, and
  its pre plane only within flip_reach of such a pixel (flip_reach itself
  is tested on a made-up mean).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_probes_cuda.py and chip_smoke.py.  JAX outputs are
computed once per file (cached).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from heimdall_tpu.ops import pallas_kernels as pk

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import pre_variants as pv
from heimdall_tpu_torch.ops import split_kernels as sk

from test_torch_split import (CT, FRAMES, H, NAMES, W, _K11, _TAPS5, _ct,
                              _gray_of, _pallas)

MEAN_TOL = 1e-3


def _conv_wrap(x, taps, axis):
    """profile_preprocess.py's conv_roll: wrap-around borders."""
    r = len(taps) // 2
    out = None
    for i, t in enumerate(taps):
        term = t * pltpu.roll(x, (r - i) % x.shape[axis], axis)
        out = term if out is None else out + term
    return out


def _roll_stage_body(ct_ref, frame_ref, stage):
    """profile_preprocess.py's make(stage) for the "_roll" stages."""
    gray = _gray_of(frame_ref)
    acc = _conv_wrap(_conv_wrap(gray, _TAPS5, 1), _TAPS5, 0)
    blurred = jnp.clip((acc + (1 << 15)) >> 16, 0, 255)
    if stage == "blur5_roll":
        return blurred
    mf = _conv_wrap(_conv_wrap(blurred.astype(jnp.float32), _K11, 1), _K11, 0)
    binary = jnp.where(blurred <= jnp.rint(mf).astype(jnp.int32) - ct_ref[0],
                       255, 0)
    if stage == "mean11_roll":
        return binary
    binary = pk._minmax3(pk._minmax3(binary, True), False)
    return pk._minmax3(pk._minmax3(binary, False), True)


def _conv_roll(x, taps, axis, mode):
    """profile_pre_variants.py's conv_roll: rolled interior, the border band
    recomputed with the concat-shift formula and spliced back."""
    r = len(taps) // 2
    out = None
    for i, t in enumerate(taps):
        s = r - i
        rolled = pltpu.roll(x, s % x.shape[axis], axis) if s else x
        term = t * rolled
        out = term if out is None else out + term
    n = x.shape[axis]
    fix = None
    for i, t in enumerate(taps):
        term = t * pk._shift(x, r - i, axis, mode)
        fix = term if fix is None else fix + term
    idx = jax.lax.broadcasted_iota(jnp.int32, x.shape, axis)
    return jnp.where((idx < r) | (idx >= n - r), fix, out)


def _conv_mxu(x, taps, axis, mode):
    """profile_pre_variants.py's conv_mxu: the f32 correlation as a banded
    matrix product (the int blur keeps _conv_axis)."""
    if x.dtype != jnp.float32:
        return pk._conv_axis(x, taps, axis, mode)
    n = x.shape[axis]
    kk = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    cc = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    T = jnp.zeros((n, n), jnp.float32)
    for i, t in enumerate(taps):
        p = jnp.clip(cc + (i - 5), 0, n - 1)
        T = T + jnp.where(kk == p, jnp.float32(t), 0.0)
    if axis == 1:
        return jax.lax.dot_general(x, T, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)
    return jax.lax.dot_general(T, x, (((0,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


# name: (conv, pair5), as profile_pre_variants.py's VARIANTS
S3 = {"cur": (pk._conv_axis, False), "roll_conv": (_conv_roll, False),
      "pair_sym": (pk._conv_axis, True), "roll_pair": (_conv_roll, True),
      "mxu_conv": (_conv_mxu, True)}


def _s3_body(ct_ref, frame_ref, name, out="pre"):
    """profile_pre_variants.py's make_body: the pre plane (int32 0/1), or
    with out="mean" the f32 mean11 before rint."""
    conv, pair5 = S3[name]
    t5 = _TAPS5
    gray = _gray_of(frame_ref)
    if pair5:
        def ax(x, axis):
            acc = t5[2] * pk._shift(x, 0, axis, "reflect101")
            for d in (1, 2):
                acc = acc + t5[2 - d] * (pk._shift(x, d, axis, "reflect101")
                                         + pk._shift(x, -d, axis,
                                                     "reflect101"))
            return acc
        acc = ax(ax(gray, 1), 0)
    else:
        acc = conv(conv(gray, t5, 1, "reflect101"), t5, 0, "reflect101")
    blurred = jnp.clip((acc + (1 << 15)) >> 16, 0, 255)
    mf = conv(conv(blurred.astype(jnp.float32), _K11, 1, "replicate"), _K11,
              0, "replicate")
    if out == "mean":
        return mf
    binary = jnp.where(blurred <= jnp.rint(mf).astype(jnp.int32) - ct_ref[0],
                       255, 0)
    binary = pk._minmax3(pk._minmax3(binary, True), False)
    binary = pk._minmax3(pk._minmax3(binary, False), True)
    return (binary > 0).astype(jnp.int32)


@functools.lru_cache(maxsize=None)
def _jax(body, arg, out="pre"):
    dtype = jnp.float32 if out == "mean" else jnp.int32

    def kernel(ct_ref, frame_ref, out_ref):
        if body == "roll":
            out_ref[0] = _roll_stage_body(ct_ref, frame_ref, arg)
        else:
            out_ref[0] = _s3_body(ct_ref, frame_ref, arg, out)

    return np.asarray(_pallas(kernel, 1, [(H, W)], dtype)(
        _ct(), jnp.asarray(FRAMES))[0])


def _x():
    return torch.from_numpy(FRAMES)


def _assert_frames_equal(want, got):
    for i, name in enumerate(NAMES):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)


@pytest.mark.parametrize("stage", pv.ROLL_STAGES)
def test_roll_stages_match_profiler_bodies(stage):
    got = pv.roll_stage_reference(_x(), CT, stage).numpy()
    assert got.dtype == np.uint8
    if stage == "full_roll":                # the profiler keeps 255 for fg
        got = got.astype(np.int32) * 255
    _assert_frames_equal(_jax("roll", stage), got)


def _jax_roll_frames(frames, stage):
    """profile_preprocess.py's roll-stage body over BGR planes [n, 3, h, w]
    of any size, one grid step a frame, in interpret mode."""
    n, _, h, w = frames.shape

    def kernel(ct_ref, frame_ref, out_ref):
        out_ref[0] = _roll_stage_body(ct_ref, frame_ref, stage)

    spec = pl.BlockSpec((1, 3, h, w), lambda i, c: (i, 0, 0, 0),
                        memory_space=pltpu.VMEM)
    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n,), in_specs=[spec],
        out_specs=[pl.BlockSpec((1, h, w), lambda i, c: (i, 0, 0),
                                memory_space=pltpu.VMEM)])
    return np.asarray(pl.pallas_call(
        kernel, grid_spec=gs,
        out_shape=(jax.ShapeDtypeStruct((n, h, w), jnp.int32),),
        interpret=True)(_ct(), jnp.asarray(frames))[0])


@pytest.mark.parametrize("size", [(6, 6), (7, 13), (13, 17)],
                         ids=lambda s: "%dx%d" % s)
def test_roll_stages_on_frames_where_the_halo_wraps(size):
    """At 6x6 the mean's 11 taps wrap past the frame's far edge; at 7x13
    and 13x17 the 11-pixel halo of the port's tiles does: the plain roll
    stages equal the JAX bodies there (scene.tile_case_frames)."""
    frames = np.ascontiguousarray(np.stack(list(scene.tile_case_frames(
        *size, seed=2).values())).transpose(0, 3, 1, 2))
    x = torch.from_numpy(frames)
    for stage in pv.ROLL_STAGES:
        got = pv.roll_stage_reference(x, CT, stage).numpy().astype(np.int32)
        if stage == "full_roll":
            got = got * 255
        np.testing.assert_array_equal(got, _jax_roll_frames(frames, stage),
                                      err_msg=stage)


def test_roll_stages_differ_from_exact_only_near_the_edge():
    """The wrap-around borders are wrong by design, and only near the edge:
    the blur within 2 px of it, the mean's threshold within 7."""
    x = _x()
    blur = pv.roll_stage_reference(x, CT, "blur5_roll")
    exact = sk.label_kernel_reference(x, CT, "blur5")
    assert torch.equal(blur[:, 2:-2, 2:-2], exact[:, 2:-2, 2:-2])
    assert not torch.equal(blur, exact)
    mean = pv.roll_stage_reference(x, CT, "mean11_roll")
    assert torch.equal(mean[:, 7:-7, 7:-7],
                       sk.label_kernel_reference(x, CT, "mean11")[:, 7:-7,
                                                                  7:-7])


@pytest.mark.parametrize("name", ["cur", "roll_conv", "pair_sym",
                                  "roll_pair"])
def test_exact_variants_match_profiler_bodies_and_pre(name):
    got = pv.pre_variant_reference(_x(), CT, name).numpy()
    assert got.dtype == np.uint8
    _assert_frames_equal(_jax("s3", name), got)
    _assert_frames_equal(sk.label_kernel_reference(_x(), CT, "pre").numpy(),
                         got)


def test_mxu_conv_mean_within_tolerance_of_dot_general():
    x = _x()
    blurred = sk.label_kernel_reference(x, CT, "blur5")
    got = pv.mxu_mean_reference(blurred).numpy()
    want = _jax("s3", "mxu_conv", "mean")
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= MEAN_TOL
    near_half = np.abs(want - np.floor(want) - 0.5) <= MEAN_TOL
    blur = blurred.numpy().astype(np.int32)

    def binary(m):
        return blur <= np.rint(m).astype(np.int32) - CT

    flips = binary(got) != binary(want)
    assert not (flips & ~near_half).any()
    pre = pv.pre_variant_reference(x, CT, "mxu_conv").numpy()
    reach = pv.flip_reach(torch.from_numpy(want), MEAN_TOL).numpy()
    assert not ((pre != _jax("s3", "mxu_conv")) & ~reach).any()
    if not flips.any():
        _assert_frames_equal(_jax("s3", "mxu_conv"), pre)


@pytest.mark.parametrize("case", ["one_pixel", "rounded_hole"])
def test_flip_reach_bounds_where_pre_planes_differ(case):
    """flip_reach is the 9x9 window (the open's and the close's four 3x3
    passes) around each mean within tol of a half-integer, and two means
    within tol of each other give pre planes that differ only inside it."""
    if case == "one_pixel":
        mean = torch.full((1, 20, 30), 7.25)
        mean[0, 2, 10] = 7.5
        want = torch.zeros((1, 20, 30), dtype=torch.bool)
        want[0, :7, 6:15] = True
        assert torch.equal(pv.flip_reach(mean, MEAN_TOL), want)
        return
    # all foreground, but for a 5x5 block whose means lie 1e-4 either side
    # of the half-integer that decides it: a hole in one plane only
    blurred = sk.label_kernel_reference(_x(), CT, "blur5")
    edge = blurred.to(torch.float32) + CT - 0.5
    mean = edge + 0.75
    other = mean.clone()
    block = (slice(None), slice(10, 15), slice(20, 25))
    mean[block] = edge[block] + 1e-4
    other[block] = edge[block] - 1e-4
    plane = (pv._threshold_morph(blurred, m, CT, "pre") for m in (mean, other))
    differ = next(plane) != next(plane)
    assert int(differ.sum()) == 25 * blurred.shape[0]
    reach = pv.flip_reach(mean, MEAN_TOL)
    assert int(reach.sum()) == 13 * 13 * blurred.shape[0]
    assert not (differ & ~reach).any()


def test_band_matrix_matches_profiler_construction():
    """band_matrix is profile_pre_variants.py's band_matrix (np.float32
    sums in tap order): the replicate border folded into the edge rows."""
    taps = [float(t) for t in np.float32(_K11)]
    for n in (6, 11, 64):
        T = np.zeros((n, n), np.float32)
        for c in range(n):
            for i, t in enumerate(taps):
                T[min(max(c + i - 5, 0), n - 1), c] += np.float32(t)
        np.testing.assert_array_equal(pv.band_matrix(n, taps).numpy(), T)


def test_cpu_wrappers_run_plain_versions():
    x = _x()[:2]
    before = (pv.roll_stage.launches, pv.pre_variant.launches,
              pv.mxu_mean.launches)
    for stage in pv.ROLL_STAGES:
        assert torch.equal(pv.roll_stage(x, CT, stage),
                           pv.roll_stage_reference(x, CT, stage))
    for name in pv.VARIANTS:
        assert torch.equal(pv.pre_variant(x, CT, name),
                           pv.pre_variant_reference(x, CT, name))
    blurred = sk.label_kernel_reference(x, CT, "blur5")
    assert torch.equal(pv.mxu_mean(blurred), pv.mxu_mean_reference(blurred))
    assert (pv.roll_stage.launches, pv.pre_variant.launches,
            pv.mxu_mean.launches) == before


@pytest.mark.parametrize("case", ["bad_stage", "bad_variant", "too_small",
                                  "nhwc", "mean_int32"])
def test_wrappers_reject_other_forms(case):
    x = _x()[:2]
    calls = {
        "bad_stage": lambda: pv.roll_stage(x, CT, "blur5"),
        "bad_variant": lambda: pv.pre_variant(x, CT, "mxu"),
        "too_small": lambda: pv.pre_variant(x[..., :5, :], CT, "cur"),
        "nhwc": lambda: pv.roll_stage(x.permute(0, 2, 3, 1), CT,
                                      "blur5_roll"),
        "mean_int32": lambda: pv.mxu_mean(x[:, 0].to(torch.int32)),
    }
    with pytest.raises(ValueError):
        calls[case]()

