"""The run-table CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; each test skips where torch.cuda.is_available() is
false).  This file imports no JAX; on a machine with a card:

    python -m pytest tests/test_torch_runtable_cuda.py -q -m cuda \
        --noconftest

(--noconftest skips tests/conftest.py, which sets JAX up.)

Equality is exact: every kernel computes integers (tables, flags, labels,
counts).
"""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.detectors.contamination_detector import (
    contamination_program)
from heimdall_tpu_torch.ops import ccl_tiled, preprocess_tiled
from heimdall_tpu_torch.ops import runtable_tiled as rt


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _stripes(h, w, n=8):
    """n full-height stripes from column 0 to column w-1: n - 1 background
    runs per row, n foreground runs (trips only the foreground guard)."""
    m = np.zeros((h, w), bool)
    for s in np.linspace(0, w - 4, n).astype(int):
        m[:, s:s + 4] = True
    return m


def _masks(h, w):
    """[8, h, w] bool: adversarial masks (dense noise overflows every
    table), thresholded bench frames, stripes, and checker rows."""
    adv = list(scene.adversarial_masks(h, w, seed=2).values())
    bench = list(scene.make_frames(2, h, w, seed=3)[..., 1] < 120)
    checker = np.zeros((h, w), bool)
    checker[h // 3:h // 3 + 9] = np.arange(w) % 6 < 3
    return np.stack(adv + bench + [_stripes(h, w), checker])


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def _kernels_against_plain(masks, r_bg, r_fg, band, k, path="cluster"):
    """Every run-table kernel against its plain version on masks; the two
    union-finds must take `path` (their wrappers' record)."""
    W = masks.shape[-1]
    tables = rt.run_extract(masks, r_bg, invert=True)
    _equal(tables, rt.run_extract_reference(masks, r_bg, invert=True))
    runid, S, E, _ = tables
    F = rt.flood_fix(S, E, W)
    assert rt.flood_fix.last_path == path
    _equal((F,), (rt.flood_fix_reference(S, E, W),))
    fill = rt.fill_extract(masks, runid, F, r_fg)
    _equal(fill, rt.fill_extract_reference(masks, runid, F, r_fg))
    filled, runid_fg, S_fg, E_fg, _ = fill
    lab = rt.label_fix(S_fg, E_fg, W, band, k)
    assert rt.label_fix.last_path == path
    _equal(lab, rt.label_fix_reference(S_fg, E_fg, W, band, k))
    L = lab[0]
    _equal((rt.writeback(filled, runid_fg, L),),
           (rt.writeback_reference(filled, runid_fg, L),))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("r", [(8, 7), (12, 10)])
@pytest.mark.parametrize("k", [64, 4])
def test_runtable_kernels_match_plain_versions(card, r, k):
    masks = torch.from_numpy(_masks(301, 517)).to(card)
    before = rt.label_fix.launches
    _kernels_against_plain(masks, *r, band=16, k=k)
    assert rt.label_fix.launches == before + 1


def _tall(h):
    """Two [h, 64] masks: noise at 0.1, and a bar with a hole down most of
    its height."""
    masks = np.zeros((2, h, 64), bool)
    masks[0] = np.random.RandomState(1).rand(h, 64) < 0.1
    masks[1, :, 10:20] = True
    masks[1, 100:h - 100, 14:16] = False
    return masks


@pytest.mark.cuda
def test_tables_in_global_scratch(card):
    """Frames whose tables exceed the shared memory of a cluster's blocks
    (16000 rows at R 12: 2000 rows a block) take the union-finds' global-
    scratch kernels."""
    _kernels_against_plain(torch.from_numpy(_tall(16000)).to(card), 12, 12,
                           128, 64, path="scratch")


@pytest.mark.cuda
def test_tall_tables_in_cluster(card):
    """5000 rows at R 12 (625 rows a block) still fit the cluster."""
    _kernels_against_plain(torch.from_numpy(_tall(5000)).to(card), 12, 12,
                           128, 64)


# The cases whose components cross every row block of the union-finds
# (scene.fix_case_masks; tests/test_torch_fix_cases.py holds the plain
# versions against JAX): the 2 MP size, an odd size, 1 row and heights
# below, at and above the cluster's 8 blocks.
@pytest.mark.cuda
@pytest.mark.parametrize("size", scene.FIX_CASE_SIZES)
@pytest.mark.parametrize("band, k", [(128, 64), (16, 4), (1, 64)])
def test_fix_cases_match_plain_versions(card, size, band, k):
    masks = torch.from_numpy(np.stack(
        list(scene.fix_case_masks(*size).values()))).to(card)
    _kernels_against_plain(masks, 8, 7, band, k)
    rt.fill_label_runtable_tiled(masks, band, max_blobs=k, r_bg=8, r_fg=7)
    assert rt.fill_label_runtable_tiled.last_route.all()


@pytest.mark.cuda
def test_route_mixed_batch_equals_band_route(card):
    """Per-frame fallback on the card: frames that fit take the tables, the
    others the band route, into the same outputs, with no host sync."""
    masks = torch.from_numpy(_masks(301, 517)).to(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rt.fill_label_runtable_tiled(masks, 16, max_blobs=64, r_bg=8,
                                           r_fg=7)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    route = rt.fill_label_runtable_tiled.last_route.tolist()
    assert True in route and False in route
    filled = ccl_tiled.fill_holes_tiled(masks, band=16)
    want = ccl_tiled.connected_components_tiled(
        filled, band=16, return_roots=64, band_slots=True)
    _equal(got, (filled,) + want)
    cpu = rt.fill_label_runtable_tiled(masks.cpu(), 16, max_blobs=64,
                                       r_bg=8, r_fg=7)
    _equal([t.cpu() for t in got], cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bgr", "bgr_planes"])
def test_preprocess_tiled_matches_plain_version(card, form):
    frames = scene.make_frames(3, 301, 517, seed=5)
    cm = form == "bgr_planes"
    x = torch.from_numpy(np.ascontiguousarray(
        frames.transpose(0, 3, 1, 2) if cm else frames)).to(card)
    _equal(preprocess_tiled.contamination_preprocess_tiled(x, 15, cm, 8),
           preprocess_tiled.contamination_preprocess_tiled_reference(
               x, 15, cm, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bgr", "bgr_planes"])
def test_runtable_route_equals_band_route_at_2mp(card, form):
    frames = scene.make_frames(2, 1080, 1920, seed=2)
    cm = form == "bgr_planes"
    x = torch.from_numpy(np.ascontiguousarray(
        frames.transpose(0, 3, 1, 2) if cm else frames)).to(card)
    tables = contamination_program(x, 15, 10.0, 3000.0, 0.25,
                                   return_labels=True, tiled_band=128,
                                   channel_major=cm)
    assert rt.fill_label_runtable_tiled.last_route.all()
    bands = contamination_program(x, 15, 10.0, 3000.0, 0.25,
                                  return_labels=True, tiled_band=128,
                                  channel_major=cm, tiled_runtable=False)
    for f in tables[0]._fields:
        assert torch.equal(getattr(tables[0], f), getattr(bands[0], f)), f
    for a, b in zip(tables[1:], bands[1:]):
        assert torch.equal(a, b)


# The cases that attack the tiles (scene.tile_case_masks / tile_case_frames;
# tests/test_torch_tile_cases.py holds the plain versions against JAX).
TILE_SIZES = [(96, 160), (301, 517), *scene.TILE_CASE_SIZES]


@pytest.mark.cuda
@pytest.mark.parametrize("size", TILE_SIZES)
def test_route_tile_cases_equal_band_route(card, size):
    """The run-table route with its per-frame fallback to the flood fill,
    on every tile case, against the band route and the CPU path."""
    masks = torch.from_numpy(np.stack(
        list(scene.tile_case_masks(*size).values()))).to(card)
    got = rt.fill_label_runtable_tiled(masks, 16, max_blobs=64, r_bg=8,
                                       r_fg=7)
    filled = ccl_tiled.fill_holes_tiled(masks, band=16)
    _equal((filled,), (ccl_tiled.flood_reference(masks),))
    want = ccl_tiled.connected_components_tiled(
        filled, band=16, return_roots=64, band_slots=True)
    _equal(got, (filled,) + want)
    cpu = rt.fill_label_runtable_tiled(masks.cpu(), 16, max_blobs=64,
                                       r_bg=8, r_fg=7)
    _equal([t.cpu() for t in got], cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("size", TILE_SIZES)
@pytest.mark.parametrize("form", ["bgr", "bgr_planes"])
def test_preprocess_tiled_tile_cases(card, size, form):
    frames = np.stack(list(scene.tile_case_frames(*size).values()))
    cm = form == "bgr_planes"
    x = torch.from_numpy(np.ascontiguousarray(
        frames.transpose(0, 3, 1, 2) if cm else frames)).to(card)
    for ct in (15, -15):
        _equal(preprocess_tiled.contamination_preprocess_tiled(x, ct, cm, 8),
               preprocess_tiled.contamination_preprocess_tiled_reference(
                   x, ct, cm, 8))


# The cases that attack the run extraction's lanes and steps
# (scene.run_case_masks; tests/test_torch_run_cases.py holds the plain
# versions against JAX).  A background width past 32 slots takes the fill's
# flags from memory instead of a ballot.
@pytest.mark.cuda
@pytest.mark.parametrize("size", [(1080, 1920), (1037, 1531)])
@pytest.mark.parametrize("r", [(8, 7), (12, 10), (40, 7)])
def test_extraction_run_cases_match_plain_versions(card, size, r):
    h, w = size
    r_bg, r_fg = r
    masks = torch.from_numpy(np.stack(
        list(scene.run_case_masks(h, w).values()))).to(card)
    u8 = masks.to(torch.uint8) * 255
    for plane in (masks, u8):
        for invert in (False, True):
            _equal(rt.run_extract(plane, r_fg, invert),
                   rt.run_extract_reference(plane, r_fg, invert))
    runid, S, E, _ = rt.run_extract(masks, r_bg, invert=True)
    _equal((runid, S, E), rt.run_extract_reference(masks, r_bg, True)[:3])
    rng = np.random.RandomState(r_bg)
    for F in (torch.from_numpy(rng.randint(0, 2, (len(masks), h, r_bg))
                               .astype(np.int32)).to(card),
              rt.flood_fix(S, E, w)):
        _equal(rt.fill_extract(masks, runid, F, r_fg),
               rt.fill_extract_reference(masks, runid, F, r_fg))
    torch.cuda.synchronize()
