"""The bbox-window sums on masks whose windows attack a walk of the windows a
row at a time (scene.window_case_masks: one blob over the whole frame, a
filled disk over all but the edge bands, one-pixel columns on the first and
last column, one-pixel corner blobs, blobs whose top or bottom row lies on a
band edge, more blobs in one band than the lists' slots, no blob) against
heimdall_tpu's (JAX on the CPU, the Pallas kernel in interpret mode).

The same inputs go to the JAX package's _bbox_sums_banded and to the port's
bbox_sums with CPU tensors, i.e. to its plain PyTorch version: the bboxes
and the slot lists come from the port's plain labeling and stats of the
masks (held against JAX by tests/test_torch_tiled.py), gray and colour
from a seeded RandomState.  The sums are integers: tolerance 0.  The CUDA
kernel is held against this plain version on the card at 1080x1920 and
301x517 by tests/test_torch_tiled_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heimdall_tpu.ops.stats_tiled import _bbox_sums_banded

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import ccl_tiled, stats_tiled

SIZES = [(64, 96), (37, 53)]
BANDS = [16, 2, 1]
KS = [8, 1]


@functools.lru_cache(maxsize=None)
def _inputs(size, band, k):
    """(bbox, slot_list, slot_count, gray, BGR frames) of the window cases,
    numpy; gray and the frames are random bytes."""
    h, w = size
    masks = np.stack(list(scene.window_case_masks(h, w).values()))
    rng = np.random.RandomState(h * w + band)
    gray = rng.randint(0, 256, masks.shape).astype(np.uint8)
    frames = rng.randint(0, 256, masks.shape + (3,)).astype(np.uint8)
    m = torch.from_numpy(masks)
    lab, rl, n, sl, sc = ccl_tiled.connected_components_tiled(
        m, band=band, return_roots=k, band_slots=True)
    _, bbox = stats_tiled.banded_stats_reference(
        lab, m, torch.from_numpy(gray), None, rl, n, k)
    return bbox.numpy(), sl.numpy(), sc.numpy(), gray, frames


@functools.lru_cache(maxsize=None)
def _jax_sums(size, band, k, with_color, longer=0):
    """JAX's sums [B, 4, K] (rows 1-3 zero without colour), the slot counts
    raised by `longer` past the listed slots."""
    bbox, sl, sc, gray, frames = _inputs(size, band, k)
    B, H, W = gray.shape
    R = sl.shape[1]
    pad = [(0, 0), (0, R * band - H), (0, 0)]
    gray_p = jnp.asarray(np.pad(gray, pad))
    cm = (jnp.asarray(np.pad(frames.transpose(0, 3, 1, 2),
                             [(0, 0), (0, 0)] + pad[1:]))
          if with_color else None)
    got = np.asarray(_bbox_sums_banded(
        jnp.asarray(bbox), jnp.asarray(sl), jnp.asarray(sc + longer), gray_p,
        cm, band, W, k, R, with_color, True))
    out = np.zeros((B, 4, k), np.int32)
    out[:, :got.shape[1]] = got
    return out


def _port_sums(size, band, k, layout, longer=0):
    bbox, sl, sc, gray, frames = _inputs(size, band, k)
    color = {None: None, "nhwc": frames,
             "planes": np.ascontiguousarray(frames.transpose(0, 3, 1, 2))}
    color = color[layout]
    return stats_tiled.bbox_sums(
        torch.from_numpy(bbox), torch.from_numpy(sl),
        torch.from_numpy(sc + longer), band, torch.from_numpy(gray),
        None if color is None else torch.from_numpy(color),
        channel_major=layout == "planes").numpy()


@pytest.mark.parametrize("layout", [None, "nhwc", "planes"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("size", SIZES)
def test_window_cases_match_jax(size, band, k, layout):
    """Gray (and b, g, r in either colour layout) summed over every listed
    (slot, band) window equals JAX's, on every window case."""
    want = _jax_sums(size, band, k, layout is not None)
    np.testing.assert_array_equal(_port_sums(size, band, k, layout), want)


@pytest.mark.parametrize("size", SIZES)
def test_slot_counts_past_k_are_clamped(size):
    """Slot counts beyond K read only the K list positions, as in JAX; the
    positions past a band's own slots list slots whose windows miss the
    band (a blob's rows are contiguous), so the sums do not change."""
    band, k = 16, 8
    want = _jax_sums(size, band, k, True, longer=k + 3)
    np.testing.assert_array_equal(
        _port_sums(size, band, k, "planes", longer=k + 3), want)
    np.testing.assert_array_equal(want, _jax_sums(size, band, k, True))


@pytest.mark.parametrize("size", SIZES + [(301, 517), (1080, 1920)])
def test_window_cases_do_what_they_are_for(size):
    """Each case's windows are the ones named: whole frame, a disk over all
    but the edge bands of 128 rows at 1080 rows, full-height columns on the
    first and last column, the four corners, blobs ending on band edges,
    more blobs in the middle row than the lists' 64 slots at 2 MP."""
    h, w = size
    cases = scene.window_case_masks(h, w)
    assert cases["whole"].all() and not cases["empty"].any()
    rows = np.nonzero(cases["disk"].any(1))[0]
    if h == 1080:
        assert rows.min() // 128 == 1 and rows.max() // 128 == 7
    assert (cases["columns"][:, [0, w - 1]]).all()
    assert cases["columns"].sum() == 2 * h
    assert [tuple(p) for p in np.argwhere(cases["corners"])] == [
        (0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)]
    edges = cases["band_edges"]
    for e in (16, 32) + tuple(range(128, h, 128)):
        if e < h:     # a blob starts on row e and one ends on row e - 1
            assert (edges[e] & ~edges[e - 1]).any(), e
            assert (edges[e - 1] & ~edges[e]).any(), e
    assert cases["crowded"].sum() == -(-w // 2)
    if w >= 130:
        assert cases["crowded"].sum() > 64


def test_window_bytes_counts_the_listed_windows():
    """The B4b byte bound of scripts/profile_bbox_sums.py: C bytes of each
    listed (slot, band) window's pixels within the band, each listed slot
    id, the band counts, 16 bytes of bbox for each slot that some band
    lists (once, however many bands list it) and 4 sums a slot."""
    from heimdall_tpu_torch.scripts.profile_bbox_sums import window_bytes
    # slot 0: columns 1-3, rows 2-5, listed in bands 0 and 1; slot 1 unused
    bbox = torch.tensor([[[1, 8], [2, 8], [3, -1], [5, -1]]],
                        dtype=torch.int32)
    slot_list = torch.tensor([[[0, 1], [0, 1]]], dtype=torch.int32)
    slot_count = torch.tensor([[1, 1]], dtype=torch.int32)
    # 3 columns x (rows 2-3 in band 0 + rows 4-5 in band 1) = 12 pixels
    assert window_bytes(bbox, slot_list, slot_count, 4, 4) == (
        12 * 4 + 16 + (2 + 2 + 4 * 2) * 4)
    assert window_bytes(bbox, slot_list, slot_count, 4, 1) == (
        12 + 16 + (2 + 2 + 4 * 2) * 4)
    # a second frame listing no slot reads its counts and writes its sums
    two = [torch.cat([t, t]) for t in (bbox, slot_list, slot_count)]
    two[2][1] = 0
    assert window_bytes(*two, 4, 1) == (
        12 + 16 + (2 + 2 + 4 * 2) * 4 + (2 + 4 * 2) * 4)


def test_window_case_checks_cover_every_form():
    """profile_bbox_sums.window_case_checks, the case set that chip_smoke.py
    and tests/test_torch_tiled_cuda.py hold the kernels to: every band, K
    and colour form, the BGR planes the frames' channel-major copy, and
    counts as labeled and past K; on the CPU its bbox sums are the plain
    version's."""
    from heimdall_tpu_torch.scripts.profile_bbox_sums import (
        window_case_checks)
    seen = []
    for band, name, stats, boxes in window_case_checks(
            37, 53, (16, 1), (8, 1), torch.device("cpu"), seed=3):
        labels, masks, gray, color, rl, n, k, cm = stats
        seen.append((band, name))
        assert masks.shape == gray.shape == (7, 37, 53)
        if name.endswith("bgr_planes"):
            assert cm and color.shape == (7, 3, 37, 53)
        elif name.endswith("bgr"):
            assert not cm and color.shape == (7, 37, 53, 3)
        else:
            assert color is None
        (sl, sc, *_), (sl2, past, *_) = boxes
        assert sl2 is sl and torch.equal(past, sc + k)
        bbox = stats_tiled.banded_stats(*stats)[1]
        for box in boxes:
            assert torch.equal(stats_tiled.bbox_sums(bbox, *box),
                               stats_tiled.bbox_sums_reference(bbox, *box))
    assert seen == [(b, f"k{k}_{f}") for b in (16, 1) for k in (8, 1)
                    for f in ("gray", "bgr", "bgr_planes")]


def test_profile_bbox_sums_needs_a_card(monkeypatch):
    from heimdall_tpu_torch.scripts import profile_bbox_sums
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_bbox_sums.main([])
    with pytest.raises(SystemExit, match="usage"):
        profile_bbox_sums.main(["x"])
    with pytest.raises(SystemExit, match="window cases: whole"):
        profile_bbox_sums.main(["--cases", "whole,nothing"])
