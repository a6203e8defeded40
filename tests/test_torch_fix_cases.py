"""The run-table route on masks whose components cross every row block of the
union-finds many times (scene.fix_case_masks: a serpentine of four corridors
as foreground and as background open at its far end or closed, a ring over
the frame's height, a staircase diagonal as foreground and as background
open on the last row, a comb whose teeth meet only on the last row, as
foreground and as background) against heimdall_tpu's (JAX on the CPU,
Pallas kernels in interpret mode).

The same numpy masks go through the JAX package's fill_label_runtable_tiled
and through the port's with CPU tensors, i.e. through the plain PyTorch
versions of the flood fix and label fix kernels.  Every case fits the
detector's tables (rt_bg 8, rt_fg 7), so every frame takes the tables.
Everything compared is an integer or boolean: tolerance 0.  The CUDA kernels
are held against these plain versions on the card at the 2 MP size, an odd
size and heights around the cluster's 8 blocks by
tests/test_torch_runtable_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heimdall_tpu.ops.runtable_tiled import (fill_label_runtable_tiled as
                                             jax_fill_label)

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import runtable_tiled as rt

BAND = 16
R_BG, R_FG = 8, 7
SIZES = [(96, 160), (70, 96)]


def _padded(masks):
    """JAX's input: u8 {0, 255}, whole bands of BAND rows."""
    B, H, W = masks.shape
    out = np.zeros((B, -(-H // BAND) * BAND, W), np.uint8)
    out[:, :H] = masks * np.uint8(255)
    return out


def _masks(size):
    return np.stack(list(scene.fix_case_masks(*size).values()))


@functools.lru_cache(maxsize=None)
def _jax_route(size, k):
    masks = _masks(size)
    out = jax_fill_label(jnp.asarray(_padded(masks)), band=BAND,
                         frame_h=size[0], max_blobs=k, r_bg=R_BG, r_fg=R_FG,
                         interpret=True)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("k", [16, 2])
@pytest.mark.parametrize("size", SIZES)
def test_fix_cases_match_jax(size, k):
    """Filled plane, labels, root table, root count and each band's listed
    slots equal JAX's; every case takes the tables."""
    got = rt.fill_label_runtable_tiled(torch.from_numpy(_padded(_masks(size))),
                                       BAND, frame_h=size[0], max_blobs=k,
                                       r_bg=R_BG, r_fg=R_FG)
    assert rt.fill_label_runtable_tiled.last_route.all()
    want = _jax_route(size, k)
    names = ("filled", "labels", "root_table", "n_blobs", "slot_list",
             "slot_count")
    for name, a, b in zip(names, want, got):
        assert b.shape == a.shape, name
        if name != "slot_list":
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    sc = want[5]
    for f in range(sc.shape[0]):
        for r in range(sc.shape[1]):
            n = sc[f, r]
            np.testing.assert_array_equal(got[4][f, r, :n].numpy(),
                                          want[4][f, r, :n])


@pytest.mark.parametrize("size", SIZES + list(scene.FIX_CASE_SIZES[1:]))
def test_fix_cases_cross_every_block(size):
    """The cases do what they are for: each fits the tables, and the
    serpentine, staircase and comb are one foreground component whose runs
    lie in every one of the 8 row blocks of a frame's cluster (or in every
    row, when the frame has fewer); the closed serpentine and the ring are
    filled, the open background serpentine, staircase and comb are not."""
    h, w = size
    cases = scene.fix_case_masks(h, w)
    masks = torch.from_numpy(np.stack(list(cases.values())))
    filled, labels, _, n, _, _ = rt.fill_label_runtable_tiled(
        masks, BAND, max_blobs=16, r_bg=R_BG, r_fg=R_FG)
    assert rt.fill_label_runtable_tiled.last_route.all()
    names = list(cases)
    blocks = sorted({y * 8 // h for y in range(h)})
    for name in ("serpentine", "staircase", "comb"):
        i = names.index(name)
        assert int(n[i]) == 1, name
        rows = torch.nonzero(labels[i] < h * w)[:, 0].unique()
        assert sorted({int(y) * 8 // h for y in rows}) == blocks, name
    if h >= 3:
        for name in ("serpentine_bg_closed", "ring"):
            i = names.index(name)
            assert bool((filled[i] & ~masks[i]).any()), name
    for name in ("serpentine_bg_open", "staircase_bg", "comb_bg"):
        i = names.index(name)
        assert torch.equal(filled[i], masks[i]), name
