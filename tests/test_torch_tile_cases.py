"""The cases that attack the 2 MP kernels' tiles, on the CPU: the plain
versions of the hole fill (ops/ccl_tiled.py::flood_reference) and of the
preprocess (ops/fused_kernels.py::preprocess_reference) against
heimdall_tpu (JAX on the CPU).

The masks and frames come from heimdall_tpu_torch/scene.py
(``tile_case_masks``, ``tile_case_frames``): a background spiral and a
one-pixel corridor across every tile edge and corner, each closed and open
to the border; background pixels meeting at tile corners only diagonally;
all foreground, all background and noise; noise frames and a uniform frame
at contrast 15 and -15.  The sizes are 96x160 (three rows and two columns
of the fill's 32x128 tiles) and the odd sizes up to 13x17.  The same cases
hold the CUDA kernels against these plain versions on the card
(tests/test_torch_tiled_cuda.py, tests/test_torch_runtable_cuda.py,
chip_smoke.py phases 3b and 3c), so they guard parity with JAX as well.

Equality is exact.  JAX's preprocess runs eagerly on one 2-D frame at a
time: its gaussian_blur takes a last axis of 1, 3 or 4 for colour, so a
gray batch of that width would be blurred across frames, and jit sums the
f32 mean in another order (tests/test_torch_ops.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heimdall_tpu import ops as jops
from heimdall_tpu.ops import ccl as jccl

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops.ccl_tiled import flood_reference
from heimdall_tpu_torch.ops.fused_kernels import preprocess_reference

SIZES = [(96, 160), (13, 17), (3, 3), (3, 17), (17, 3)]
MASKS = tuple(scene.tile_case_masks(3, 3))
FRAMES = tuple(scene.tile_case_frames(3, 3))


@functools.lru_cache(maxsize=None)
def _jax_filled(h, w):
    masks = np.stack(list(scene.tile_case_masks(h, w).values()))
    return np.asarray(jccl.fill_holes(jnp.asarray(masks)))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", MASKS)
def test_fill_plain_version_matches_jax(size, name):
    masks = scene.tile_case_masks(*size)
    got = flood_reference(torch.from_numpy(masks[name])[None])[0]
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_filled(*size)[MASKS.index(name)])


def test_tile_cases_are_what_they_claim():
    m = scene.tile_case_masks(96, 160)
    fill = {n: flood_reference(torch.from_numpy(v)[None])[0].numpy()
            for n, v in m.items()}
    for closed in ("spiral_closed", "snake_closed"):
        assert (~m[closed]).sum() > 300 and fill[closed].all()
    for opened in ("spiral_open", "snake_open"):
        np.testing.assert_array_equal(fill[opened], m[opened])
    # the corridor crosses the tile corner (32, 128) through its three tiles
    assert not m["snake_open"][31, 127] and not m["snake_open"][31, 128]
    assert not m["snake_open"][32, 128]
    # at (32, 128) the corner pixel touching the corridor only diagonally
    # stays a hole; at (64, 128) both pixels are holes
    corners = m["diagonal_corners"]
    assert not corners[31, 127] and not corners[32, 128]
    assert not fill["diagonal_corners"][31, 127]
    assert fill["diagonal_corners"][32, 128]
    assert fill["diagonal_corners"][63, 127] and fill["diagonal_corners"][64,
                                                                          128]


@functools.lru_cache(maxsize=None)
def _jax_preprocess(h, w, name, ct, mono):
    frame = scene.tile_case_frames(h, w)[name]
    gray = jnp.asarray(frame[..., 1]) if mono else jops.bgr_to_gray(
        jnp.asarray(frame))
    blurred = jops.gaussian_blur(gray, 5, 0)
    binary = jops.adaptive_threshold(blurred, 255, "gaussian", "binary_inv",
                                     11, ct)
    se3 = np.ones((3, 3), np.uint8)
    binary = jops.morphology_ex(binary, "open", se3)
    binary = jops.morphology_ex(binary, "close", se3)
    return np.asarray(gray), np.asarray(binary)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", FRAMES)
@pytest.mark.parametrize("ct", [15, -15])
def test_preprocess_plain_version_matches_jax(size, name, ct):
    frame = scene.tile_case_frames(*size)[name]
    for mono in (False, True):
        x = np.ascontiguousarray(frame[..., 1] if mono else frame)
        gray, binary = preprocess_reference(torch.from_numpy(x)[None], ct)
        want_gray, want_binary = _jax_preprocess(*size, name, ct, mono)
        np.testing.assert_array_equal(gray[0].numpy(), want_gray)
        np.testing.assert_array_equal(binary[0].numpy() * 255, want_binary)


def test_contrast_minus_15_is_all_foreground():
    frame = scene.tile_case_frames(13, 17)["uniform"]
    _, binary = preprocess_reference(torch.from_numpy(frame)[None], -15)
    assert bool(binary.all())
    _, binary = preprocess_reference(torch.from_numpy(frame)[None], 15)
    assert not bool(binary.any())


def test_plain_preprocess_of_a_gray_batch_three_wide():
    """A gray batch of width 3 is blurred frame by frame, not as colour."""
    frames = np.stack([scene.tile_case_frames(17, 3, seed=s)["noise"]
                       for s in range(2)])
    x = torch.from_numpy(np.ascontiguousarray(frames[..., 1]))
    gray, binary = preprocess_reference(x, 15)
    for i in range(2):
        one = preprocess_reference(x[i:i + 1], 15)
        assert torch.equal(gray[i], one[0][0])
        assert torch.equal(binary[i], one[1][0])
        np.testing.assert_array_equal(
            binary[i].numpy() * 255, _jax_preprocess_seed(i))


@functools.lru_cache(maxsize=None)
def _jax_preprocess_seed(seed):
    frame = scene.tile_case_frames(17, 3, seed=seed)["noise"]
    blurred = jops.gaussian_blur(jnp.asarray(frame[..., 1]), 5, 0)
    binary = jops.adaptive_threshold(blurred, 255, "gaussian", "binary_inv",
                                     11, 15)
    se3 = np.ones((3, 3), np.uint8)
    binary = jops.morphology_ex(binary, "open", se3)
    return np.asarray(jops.morphology_ex(binary, "close", se3))
