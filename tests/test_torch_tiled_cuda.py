"""The band-tiled CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; each test skips where torch.cuda.is_available() is
false).  This file imports no JAX, so it runs on a machine with a card and
no JAX:

    python -m pytest tests/test_torch_tiled_cuda.py -q -m cuda

Equality is exact: every kernel computes integers (labels, counts, int32
sums) and the table formulas are the same float32 operations in the same
order on both sides.
"""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.detectors.contamination_detector import (
    contamination_program)
from heimdall_tpu_torch.ops import ccl_tiled, stats_tiled
from heimdall_tpu_torch.ops import fused_kernels
from heimdall_tpu_torch.scripts import profile_bbox_sums


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _masks(h, w):
    """Adversarial masks and thresholded bench frames, [6, h, w] bool."""
    adv = np.stack(list(scene.adversarial_masks(h, w, seed=2).values()))
    bench = scene.make_frames(2, h, w, seed=3)[..., 1] < 120
    return np.concatenate([adv, bench])


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [16, 128])
@pytest.mark.parametrize("k", [64, 4])
def test_tiled_kernels_match_plain_versions(card, band, k):
    masks = torch.from_numpy(_masks(301, 517)).to(card)
    frames = scene.make_frames(6, 301, 517, seed=4)
    gray = torch.from_numpy(np.ascontiguousarray(frames[..., 1])).to(card)
    color = torch.from_numpy(frames).to(card)
    filled = ccl_tiled.flood_fill(masks)
    _equal((filled,), (ccl_tiled.flood_reference(masks),))
    out = ccl_tiled.band_ccl(filled, band, 8, max(k, 128))
    _equal(out, ccl_tiled.band_ccl_reference(filled, band, 8, max(k, 128)))
    merged = ccl_tiled.merge_bands(out[0].clone(), out[1], out[2], band, 8,
                                   k)
    _equal(merged, ccl_tiled.merge_reference(out[0], out[1], out[2], band, 8,
                                             k))
    lab, rl, n, sl, sc = merged
    args = (lab, filled, gray, color, rl, n, k)
    sums = stats_tiled.banded_stats(*args)
    _equal(sums, stats_tiled.banded_stats_reference(*args))
    box = (sums[1], sl, sc, band, gray, color)
    _equal((stats_tiled.bbox_sums(*box),),
           (stats_tiled.bbox_sums_reference(*box),))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("band", [128, 16, 1])
@pytest.mark.parametrize("size", [(1080, 1920), (301, 517)])
def test_bbox_sums_window_cases(card, size, band):
    """The bbox sums on scripts/profile_bbox_sums.py's window_case_checks
    (scene.window_case_masks: the whole frame, a disk over all but the edge
    bands, full-height columns on the first and last
    column, the corners, blobs ending on band edges, more blobs in one band
    than slots, no blob) with random gray and colour: K 64, 4 and 1, gray
    only, BGR frames and BGR planes, and slot counts past K; the banded
    stats on them too."""
    h, w = size
    for _, _, args, boxes in profile_bbox_sums.window_case_checks(
            h, w, (band,), (64, 4, 1), card, seed=h + band):
        sums = stats_tiled.banded_stats(*args)
        _equal(sums, stats_tiled.banded_stats_reference(*args))
        for box in boxes:
            _equal((stats_tiled.bbox_sums(sums[1], *box),),
                   (stats_tiled.bbox_sums_reference(sums[1], *box),))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_preprocess_matches_plain_version(card):
    frames = torch.from_numpy(scene.make_frames(3, 301, 517, seed=5)).to(card)
    _equal(fused_kernels.preprocess(frames, 15),
           fused_kernels.preprocess_reference(frames, 15))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["mono8", "bgr", "bgr_planes"])
def test_tiled_route_on_card_equals_cpu_path(card, form):
    frames = scene.make_frames(2, 301, 517, seed=6)
    x, cm = {"mono8": (frames[..., 1], False), "bgr": (frames, False),
             "bgr_planes": (frames.transpose(0, 3, 1, 2), True)}[form]
    x = torch.from_numpy(np.ascontiguousarray(x))
    cpu = contamination_program(x, 15, 3.0, 3000.0, 0.2, return_labels=True,
                                tiled_band=64, channel_major=cm)
    gpu = contamination_program(x.to(card), 15, 3.0, 3000.0, 0.2,
                                return_labels=True, tiled_band=64,
                                channel_major=cm)
    for f in cpu[0]._fields:
        assert torch.equal(getattr(gpu[0], f).cpu(), getattr(cpu[0], f)), f
    for a, b in zip(gpu[1:], cpu[1:]):
        assert torch.equal(a.cpu(), b)


# The cases that attack the tiles (scene.tile_case_masks / tile_case_frames;
# tests/test_torch_tile_cases.py holds the plain versions against JAX).
TILE_SIZES = [(96, 160), (301, 517), *scene.TILE_CASE_SIZES]


@pytest.mark.cuda
@pytest.mark.parametrize("size", TILE_SIZES)
def test_flood_fill_tile_cases(card, size):
    masks = np.stack(list(scene.tile_case_masks(*size).values()))
    for x in (torch.from_numpy(masks).to(card),
              torch.from_numpy(masks.astype(np.uint8) * 255).to(card)):
        _equal((ccl_tiled.flood_fill(x),), (ccl_tiled.flood_reference(x),))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_flood_fill_leaves_skipped_frames_untouched(card):
    masks = torch.from_numpy(np.stack(
        list(scene.tile_case_masks(1037, 1531).values()))).to(card)
    B = masks.shape[0]
    active = torch.arange(B, device=card) % 3 != 1
    sentinel = torch.from_numpy(
        np.random.RandomState(7).rand(*masks.shape) < 0.5).to(card)
    out = sentinel.clone()
    ccl_tiled.flood_fill(masks, active=active, out=out)
    torch.cuda.synchronize()
    want = ccl_tiled.flood_reference(masks)
    assert torch.equal(out[active], want[active])
    assert torch.equal(out[~active], sentinel[~active])


@pytest.mark.cuda
@pytest.mark.parametrize("size", TILE_SIZES)
@pytest.mark.parametrize("form", ["mono8", "bgr", "bgr_planes"])
def test_preprocess_tile_cases(card, size, form):
    frames = np.stack(list(scene.tile_case_frames(*size).values()))
    x, cm = {"mono8": (frames[..., 1], False), "bgr": (frames, False),
             "bgr_planes": (frames.transpose(0, 3, 1, 2), True)}[form]
    x = torch.from_numpy(np.ascontiguousarray(x)).to(card)
    for ct in (15, -15):
        _equal(fused_kernels.preprocess(x, ct, cm),
               fused_kernels.preprocess_reference(x, ct, cm))
    torch.cuda.synchronize()


# The cases that attack the foreground labeling's tiles
# (scene.label_case_masks; tests/test_torch_label_cases.py holds the plain
# versions against JAX): every band the route or a caller may take, bands
# that cut the 32-row tiles, both connectivities.
LABEL_SIZES = [(64, 256), (301, 517), *scene.TILE_CASE_SIZES]


@pytest.mark.cuda
@pytest.mark.parametrize("size", LABEL_SIZES)
@pytest.mark.parametrize("connectivity", [8, 4])
def test_band_ccl_label_cases(card, size, connectivity):
    masks = torch.from_numpy(np.stack(
        list(scene.label_case_masks(*size).values()))).to(card)
    for band in (1, 2, 16, 32, 48, 64, 128, size[0]):
        for cap in (128, 4):
            out = ccl_tiled.band_ccl(masks, band, connectivity, cap)
            _equal(out, ccl_tiled.band_ccl_reference(masks, band,
                                                     connectivity, cap))
            merged = ccl_tiled.merge_bands(out[0].clone(), out[1], out[2],
                                           band, connectivity, 64)
            _equal(merged, ccl_tiled.merge_reference(
                out[0], out[1], out[2], band, connectivity, 64))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_band_ccl_leaves_skipped_frames_untouched(card):
    masks = torch.from_numpy(np.stack(
        list(scene.label_case_masks(1037, 1531).values()))).to(card)
    B = masks.shape[0]
    active = torch.arange(B, device=card) % 3 != 1
    sentinel = torch.from_numpy(np.random.RandomState(8).randint(
        0, 1037 * 1531, masks.shape).astype(np.int32)).to(card)
    for band, conn in ((128, 8), (48, 4)):
        out = sentinel.clone()
        lab, roots, counts = ccl_tiled.band_ccl(masks, band, conn, 128,
                                                active=active, out=out)
        torch.cuda.synchronize()
        want = ccl_tiled.band_ccl_reference(masks, band, conn, 128)
        _equal((lab[active], roots[active], counts[active]),
               tuple(w[active] for w in want))
        assert torch.equal(out[~active], sentinel[~active])
