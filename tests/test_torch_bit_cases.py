"""The cases that attack the sweep fill's bit words, on the CPU: the plain
versions of the sweep fill and of the label kernel's stages against
heimdall_tpu (JAX on the CPU).

The masks come from heimdall_tpu_torch/scene.py (``bit_case_masks``):
background runs that end on a word's last bit, start on its first bit,
cross a word edge, run through the whole row and on alternate columns; a
corridor snaking down and up columns through more than 31 rows, closed and
open; holes against the first and last rows and columns, closed and opened
through one pixel; background stripes of whole words; all foreground and
all background.  The sizes (``BIT_CASE_SIZES``) are widths one under, at
and one over a word of 32 columns and 641 (the frames: 31 and 641).  They
are held here:

1. the plain sweep fill (``sweep_fill_reference``, the TPU code's ladders)
   on the masks against JAX's eager ``ops.ccl.fill_holes``, and the sweep
   fill probe's plain version (``fill_sweeps_reference``) on the masks
   drawn as frames (``bit_case_frames``) against ``fill_holes`` of JAX's
   XLA preprocess;
2. ``label_kernel_reference`` at every stage on those frames against JAX's
   XLA preprocess (gray, blur5, the mean11 threshold, open and close),
   ``fill_holes`` and ``connected_components`` (8).

The same cases hold the CUDA kernels against these plain versions on the
card (tests/test_torch_probes_cuda.py: every sweep fill variant on the
masks; tests/test_torch_split_cuda.py: every stage on the frames;
chip_smoke.py phases 3d and 3e), so they guard parity with JAX as well.
Equality is exact.  JAX's f32 mean and threshold run eagerly (jit sums the
mean in another order, tests/test_torch_ops.py); its integer stages, the
fill and the labels are jitted.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heimdall_tpu import ops as jops
from heimdall_tpu.ops import ccl as jccl

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import fill_sweeps as fs
from heimdall_tpu_torch.ops import split_kernels as sk

SIZES = scene.BIT_CASE_SIZES
# the frames' sizes: under a word and past 640 (JAX's eager f32 mean takes
# about 1.5 s a size)
FRAME_SIZES = ((40, 31), (70, 641))
NAMES = tuple(scene.bit_case_masks(40, 32))
CT = 15


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain sweeps run many small ops: with one intra-op thread each,
    none waits on threads that the other test workers keep off the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(h, w):
    return np.stack(list(scene.bit_case_masks(h, w).values()))


def _frames(h, w):
    return torch.from_numpy(np.ascontiguousarray(
        scene.bit_case_frames(h, w).transpose(0, 3, 1, 2)))


@jax.jit
def _jax_gray_blur(frames):
    gray = jops.bgr_to_gray(frames)
    return gray, jops.gaussian_blur(gray, 5, 0)


@jax.jit
def _jax_close_fill_label(binary):
    se3 = np.ones((3, 3), np.uint8)
    closed = jops.morphology_ex(jops.morphology_ex(binary, "open", se3),
                                "close", se3)
    filled = jccl.fill_holes(closed > 0)
    return closed, filled, jccl.connected_components(filled, 8)


@functools.lru_cache(maxsize=None)
def _jax_stages(h, w):
    """JAX's planes of every stage on the drawn frames: the integer stages
    jitted, the f32 mean's threshold eagerly."""
    gray, blurred = _jax_gray_blur(jnp.asarray(scene.bit_case_frames(h, w)))
    binary = jops.adaptive_threshold(blurred, 255, "gaussian", "binary_inv",
                                     11, CT)
    closed, filled, labels = _jax_close_fill_label(binary)
    stages = {"gray": gray, "blur5": blurred, "mean11": binary,
              "pre": np.asarray(closed) > 0, "fill": filled, "ccl": labels}
    return {s: np.asarray(v) for s, v in stages.items()}


@pytest.mark.parametrize("size", SIZES)
def test_sweep_fill_plain_version_matches_jax(size):
    masks = _masks(*size)
    want = np.asarray(jccl.fill_holes(jnp.asarray(masks))).astype(np.uint8)
    got = fs.sweep_fill_reference(torch.from_numpy(masks)).numpy()
    for i, name in enumerate(NAMES):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)


@pytest.mark.parametrize("size", FRAME_SIZES)
def test_fill_probe_plain_version_matches_jax(size):
    got = fs.fill_sweeps_reference(_frames(*size), CT).numpy()
    want = _jax_stages(*size)["fill"].astype(np.uint8)
    for i, name in enumerate(NAMES):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)


@pytest.mark.parametrize("size", FRAME_SIZES)
@pytest.mark.parametrize("stage", sk.STAGES)
def test_label_stages_match_jax(size, stage):
    got = sk.label_kernel_reference(_frames(*size), CT, stage).numpy()
    want = _jax_stages(*size)[stage]
    if want.dtype == bool:
        want = want.astype(np.uint8)
    for i, name in enumerate(NAMES):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)


def test_bit_cases_are_what_they_claim():
    h, w = 70, 641
    m = scene.bit_case_masks(h, w)
    filled = {n: fs.sweep_fill_reference(torch.from_numpy(v)[None])[0]
              .numpy().astype(bool) for n, v in m.items()}
    runs = m["word_runs"]
    # row 2 ends background runs on bit 31 (column 31), row 4 starts them
    # on bit 0 (column 32), row 6 crosses the word edge at 64
    assert not runs[2, 31] and runs[2, 32] and runs[2, 15]
    assert runs[4, 31] and not runs[4, 32] and not runs[4, 0]
    assert not runs[6, 63] and not runs[6, 64]
    # row 8 is background through the row, row 10 all but its ends, row 12
    # on alternate columns; the first is exterior, the others holes
    assert not runs[8].any() and not filled["word_runs"][8].any()
    assert runs[10, 0] and runs[10, w - 1] and filled["word_runs"][10].all()
    assert (runs[12, 1:w - 1:2] == 0).all() and filled["word_runs"][12, 1]
    # the snake's legs run down more than 31 rows, past the word edge
    legs = [x for x in range(w) if not m["snake_closed"][1:h - 1, x].any()]
    assert len(legs) == scene.SNAKE_LEGS and legs[0] < 32 < legs[-1]
    assert filled["snake_closed"].all()
    np.testing.assert_array_equal(filled["snake_open"], m["snake_open"])
    # holes against the frame's edges, and the same opened through it
    assert not m["edge_holes"][1, 2] and filled["edge_holes"].all()
    np.testing.assert_array_equal(filled["edge_open"], m["edge_open"])
    # whole-word stripes: the first and last touch the sides, others holes
    stripes = m["word_stripes"]
    assert not stripes[5, 0] and not filled["word_stripes"][5, 0]
    assert not stripes[5, w - 1] and not filled["word_stripes"][5, w - 1]
    assert not stripes[5, 64] and filled["word_stripes"][5, 64]
    assert filled["all_fg"].all() and not filled["all_bg"].any()
