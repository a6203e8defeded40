"""The port's band-tiled hole fill, labeling and blob statistics against
heimdall_tpu's (JAX on the CPU, Pallas kernels in interpret mode).

The same seeded numpy masks and frames go through
heimdall_tpu.ops.ccl_tiled / stats_tiled and through the port's
ops/ccl_tiled.py / stats_tiled.py with CPU tensors, i.e. through the plain
PyTorch versions of the CUDA kernels (flood_fill, band_ccl, merge_bands,
banded_stats, bbox_sums).  Masks, labels, root tables, counts, slot lists,
integer and boolean table fields are equal exactly; float table fields
are within 1e-6 of jitted XLA, which rewrites x / 30 as x * (1/30).  These
modules have no parameters, so no weights are carried across.

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_tiled_cuda.py (marked ``cuda``, skipped without a
card; it imports no JAX, so it runs where JAX is not installed) and by
chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heimdall_tpu.ops import ccl as jccl
from heimdall_tpu.ops import ccl_tiled as jtiled
from heimdall_tpu.ops import stats_tiled as jstats

from heimdall_tpu_torch.ops import ccl_tiled, stats_tiled
from heimdall_tpu_torch.ops.ccl import connected_components


def _random(n, h, w, seed, density):
    return np.random.RandomState(seed).rand(n, h, w) < density


def _snake(h, w, pitch=6):
    """One serpentine component crossing every band many times."""
    m = np.zeros((h, w), bool)
    m[:, ::pitch] = True
    for i, y in enumerate(range(0, h, pitch)):
        m[y if i % 2 == 0 else min(y + pitch // 2, h - 1), :] = True
    return m


def _spiral(h, w):
    m = np.zeros((h, w), bool)
    top, bot, left, right = 0, h - 1, 0, w - 1
    while top <= bot and left <= right:
        m[top, left:right + 1] = True
        m[top:bot + 1, right] = True
        m[bot, left:right + 1] = True
        m[top:bot + 1, left] = True
        top, bot, left, right = top + 4, bot - 4, left + 4, right - 4
    return m


def _rings(n, h, w, seed):
    """Hollow discs (holes to fill) straddling band borders."""
    rng = np.random.RandomState(seed)
    m = np.zeros((n, h, w), bool)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        for _ in range(4):
            cy, cx = rng.randint(5, h - 5), rng.randint(5, w - 5)
            r = rng.randint(4, 14)
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            m[i] |= (d2 <= r * r) & (d2 >= (r - 2) ** 2)
    return m


def _c_cavity():
    """Background of band 0 that reaches the border only through band 2."""
    m = np.zeros((1, 48, 32), bool)
    m[0, 4, 4:28] = True
    m[0, 4:44, 4] = True
    m[0, 4:44, 27] = True
    return m


def _blobs(n, h, w, n_blobs, seed):
    """Disc scene: mask, gray and BGR frames."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((n, h, w), bool)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        for _ in range(n_blobs):
            cy, cx = rng.randint(3, h - 3), rng.randint(3, w - 3)
            r = rng.randint(2, 9)
            mask[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    color = rng.randint(0, 255, (n, h, w, 3)).astype(np.uint8)
    return mask, color.mean(axis=-1).astype(np.uint8), color


# name: (masks [B, H, W] bool, band)
FILL_CASES = {
    "random_64x96_b16": (_random(3, 64, 96, 1, 0.5), 16),
    "rings_50x48_b16": (_rings(3, 50, 48, 50), 16),
    "random_96x128_b32": (_random(2, 96, 128, 2, 0.45), 32),
    "rings_90x128_b32": (_rings(2, 90, 128, 90), 32),
    "c_cavity_48x32_b16": (_c_cavity(), 16),
}

# name: (masks, band); one shape per band keeps the JAX compiles few
CCL_CASES = {
    "random_64x96_b16": (_random(3, 64, 96, 3, 0.22), 16),
    "snake_spiral_percolating_64x96_b16": (np.stack(
        [_snake(64, 96), _spiral(64, 96), _random(1, 64, 96, 4, 0.55)[0]]),
        16),
    "random_50x48_b16": (_random(3, 50, 48, 5, 0.3), 16),
    "percolating_96x128_b32": (_random(2, 96, 128, 6, 0.55), 32),
    "random_90x128_b32": (_random(2, 90, 128, 7, 0.25), 32),
}
K = 64


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax_fill(case):
    masks, band = FILL_CASES[case]
    return np.asarray(jtiled.fill_holes_tiled(
        jnp.asarray(masks), band=band, adaptive=True, interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_ccl(case):
    masks, band = CCL_CASES[case]
    out = jtiled.connected_components_tiled(
        jnp.asarray(masks), band=band, adaptive=True, interpret=True,
        return_roots=K, band_slots=True)
    return tuple(np.asarray(x) for x in out)


def _assert_exact_incidence(out, band):
    """slot_list/slot_count of connected_components_tiled: per band, the
    slots with a pixel there ascending, then the others ascending."""
    lab, rl, _, sl, sc = (x.numpy() for x in out)
    B, H, W = lab.shape
    for b in range(B):
        for r in range(sl.shape[1]):
            rows = lab[b, band * r:band * (r + 1)]
            present = [k for k in range(rl.shape[1])
                       if rl[b, k] < H * W and (rows == rl[b, k]).any()]
            absent = [k for k in range(rl.shape[1]) if k not in present]
            assert sc[b, r] == len(present)
            np.testing.assert_array_equal(sl[b, r], present + absent)


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_fill_holes_tiled_matches_jax(case):
    masks, band = FILL_CASES[case]
    got = ccl_tiled.fill_holes_tiled(_t(masks), band=band)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), _jax_fill(case))
    if case.startswith("c_cavity"):
        np.testing.assert_array_equal(got.numpy(), masks)   # nothing filled


def test_fill_holes_tiled_padded_layout():
    """frame_h: a mask padded to whole bands comes back padded, the pad
    rows background, as in the JAX contract."""
    masks, band = FILL_CASES["rings_90x128_b32"]
    padded = np.zeros((2, 96, 128), bool)
    padded[:, :90] = masks
    got = ccl_tiled.fill_holes_tiled(_t(padded), band=band, frame_h=90)
    want = jtiled.fill_holes_tiled(jnp.asarray(padded), band=band,
                                   interpret=True, frame_h=90)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[:, 90:].any()


@pytest.mark.parametrize("case", sorted(CCL_CASES))
def test_connected_components_tiled_matches_jax(case):
    masks, band = CCL_CASES[case]
    lab, rl, n, sl, sc = _jax_ccl(case)
    got = ccl_tiled.connected_components_tiled(
        _t(masks), band=band, return_roots=K, band_slots=True)
    for name, a, b in zip(("labels", "root_table", "n_blobs"), (lab, rl, n),
                          got):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    # the whole-frame XLA labels are the contract
    np.testing.assert_array_equal(
        got[0].numpy(), np.asarray(jccl.connected_components(
            jnp.asarray(masks))))
    _assert_exact_incidence(got, band)
    # JAX keeps exact slot lists on its table path (<= 128 roots per band;
    # its top_k fallback lists every slot in every band)
    _, _, counts = ccl_tiled.band_ccl_reference(_t(masks), band, 8, 128)
    if int(counts.max()) <= 128:
        np.testing.assert_array_equal(got[3].numpy(), sl)
        np.testing.assert_array_equal(got[4].numpy(), sc)


def test_band_over_128_roots_matches_jax_topk_route():
    """A band with more roots than its table holds sends JAX to its top_k
    fallback; labels, root table and count stay equal."""
    masks = np.zeros((2, 64, 96), bool)
    masks[0, ::2, ::2] = True                     # 384 roots per band
    masks[1] = _random(1, 64, 96, 8, 0.3)[0]
    masks[1, 16:32, ::2] = True
    _, _, counts = ccl_tiled.band_ccl_reference(_t(masks), 16, 8, 128)
    assert int(counts.max()) > 128
    want = jtiled.connected_components_tiled(
        jnp.asarray(masks), band=16, adaptive=True, interpret=True,
        return_roots=K, band_slots=True)
    got = ccl_tiled.connected_components_tiled(
        _t(masks), band=16, return_roots=K, band_slots=True)
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    _assert_exact_incidence(got, 16)    # JAX's fallback lists every slot


@pytest.mark.parametrize("connectivity", [4, 8])
def test_connectivity_matches_whole_frame(connectivity):
    masks = _random(2, 50, 48, 9, 0.45)
    got = ccl_tiled.connected_components_tiled(
        _t(masks), connectivity=connectivity, band=16)
    want = connected_components(_t(masks), connectivity)
    assert torch.equal(got, want)


def test_labels_padded_layout_and_2d_input():
    masks, band = CCL_CASES["random_90x128_b32"]
    padded = np.zeros((2, 96, 128), bool)
    padded[:, :90] = masks
    lab = ccl_tiled.connected_components_tiled(_t(padded), band=band,
                                               frame_h=90)
    np.testing.assert_array_equal(lab[:, :90].numpy(),
                                  _jax_ccl("random_90x128_b32")[0])
    assert (lab[:, 90:] == 90 * 128).all()
    one = ccl_tiled.connected_components_tiled(_t(masks[0]), band=band,
                                               return_roots=K)
    np.testing.assert_array_equal(one[0].numpy(),
                                  _jax_ccl("random_90x128_b32")[0][0])
    with pytest.raises(ValueError, match="band_slots"):
        ccl_tiled.connected_components_tiled(_t(masks), band_slots=True)


def test_band_ccl_reference_is_band_local():
    """B5a's plain version: global indices of band-local minima, band root
    tables of roots_cap entries padded with H*W, exact counts."""
    masks = np.stack([_snake(40, 32)])
    lab, roots, counts = ccl_tiled.band_ccl_reference(_t(masks), 16, 8, 4)
    H, W = 40, 32
    assert roots.shape == (1, 3, 4) and counts.shape == (1, 3)
    for r in range(3):
        rows = slice(16 * r, min(16 * (r + 1), H))
        band_lab = connected_components(_t(masks[:, rows]), 8).numpy()
        fg = masks[0, rows]
        want = np.where(fg, band_lab[0] + 16 * r * W, H * W)
        np.testing.assert_array_equal(lab[0, rows].numpy(), want)
        lin = np.arange(16 * r * W, 16 * r * W + fg.size).reshape(fg.shape)
        band_roots = np.sort(lin[fg & (want == lin)])
        assert int(counts[0, r]) == band_roots.size
        pad = np.full(4, H * W)
        pad[:min(4, band_roots.size)] = band_roots[:4]
        np.testing.assert_array_equal(roots[0, r].numpy(), pad)


def test_cpu_wrappers_run_plain_versions():
    masks = _t(_random(2, 50, 48, 10, 0.4))
    before = (ccl_tiled.flood_fill.launches, ccl_tiled.band_ccl.launches,
              ccl_tiled.merge_bands.launches,
              stats_tiled.banded_stats.launches,
              stats_tiled.bbox_sums.launches)
    filled = ccl_tiled.fill_holes_tiled(masks, band=16)
    lab, rl, n, sl, sc = ccl_tiled.connected_components_tiled(
        filled, band=16, return_roots=8, band_slots=True)
    stats_tiled.blob_stats_tiled(lab, filled, masks.to(torch.uint8) * 9,
                                 band=16, max_blobs=8, root_table=rl,
                                 root_count=n, slot_list=sl, slot_count=sc)
    assert (ccl_tiled.flood_fill.launches, ccl_tiled.band_ccl.launches,
            ccl_tiled.merge_bands.launches,
            stats_tiled.banded_stats.launches,
            stats_tiled.bbox_sums.launches) == before


# ----------------------------------------------------------- blob statistics

# name: (n, h, w, blobs per frame, band, K, use_color)
STATS_CASES = {
    "k64_color_64x96_b16": (2, 64, 96, 6, 16, 64, True),
    "k64_mono_90x128_b32": (2, 90, 128, 8, 32, 64, False),
    "k4_overflow_color_64x96_b16": (1, 64, 96, 14, 16, 4, True),
    "k4_overflow_mono_50x48_b16": (2, 50, 48, 10, 16, 4, False),
}


@functools.lru_cache(maxsize=None)
def _stats_inputs(case):
    n, h, w, nb, band, k, use_color = STATS_CASES[case]
    mask, gray, color = _blobs(n, h, w, nb, seed=h + nb)
    mask = jccl.fill_holes(jnp.asarray(mask))
    lab, rl, cnt, sl, sc = jtiled.connected_components_tiled(
        mask, band=band, adaptive=True, interpret=True, return_roots=k,
        band_slots=True)
    table = jstats.blob_stats_tiled(
        lab, mask, jnp.asarray(gray), jnp.asarray(color), band=band,
        max_blobs=k, use_color=use_color, root_table=rl, root_count=cnt,
        slot_list=sl, slot_count=sc, interpret=True)
    ins = tuple(np.asarray(x) for x in (lab, mask, rl, cnt, sl, sc))
    return ins + (gray, color), table


def _assert_table(want, got):
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_blob_stats_tiled_matches_jax(case):
    _, _, _, _, band, k, use_color = STATS_CASES[case]
    (lab, mask, rl, cnt, sl, sc, gray, color), want = _stats_inputs(case)
    got = stats_tiled.blob_stats_tiled(
        _t(lab), _t(mask), _t(gray), _t(color), band=band, max_blobs=k,
        use_color=use_color, root_table=_t(rl), root_count=_t(cnt),
        slot_list=_t(sl), slot_count=_t(sc))
    _assert_table(want, got)
    if k == 4:
        assert int(got.n_blobs.max()) > k
    # without slot lists every slot is listed in every band: same table
    dense = stats_tiled.blob_stats_tiled(
        _t(lab), _t(mask), _t(gray), _t(color), band=band, max_blobs=k,
        use_color=use_color, root_table=_t(rl), root_count=_t(cnt))
    _assert_table(want, dense)


def test_blob_stats_tiled_channel_major_color():
    (lab, mask, rl, cnt, sl, sc, gray, color), want = _stats_inputs(
        "k64_color_64x96_b16")
    got = stats_tiled.blob_stats_tiled(
        _t(lab), _t(mask), _t(gray), _t(color.transpose(0, 3, 1, 2)),
        band=16, max_blobs=64, root_table=_t(rl), root_count=_t(cnt),
        slot_list=_t(sl), slot_count=_t(sc), channel_major=True)
    _assert_table(want, got)


def test_blob_stats_tiled_empty_frame():
    mask = torch.zeros((2, 48, 64), dtype=torch.bool)
    lab, rl, n, sl, sc = ccl_tiled.connected_components_tiled(
        mask, band=16, return_roots=8, band_slots=True)
    got = stats_tiled.blob_stats_tiled(
        lab, mask, torch.zeros((2, 48, 64), dtype=torch.uint8), band=16,
        max_blobs=8, root_table=rl, root_count=n, slot_list=sl,
        slot_count=sc)
    want = jstats.blob_stats_tiled(
        jnp.asarray(lab.numpy()), jnp.zeros((2, 48, 64), bool),
        jnp.zeros((2, 48, 64), jnp.uint8), None, band=16, max_blobs=8,
        root_table=jnp.asarray(rl.numpy()), root_count=jnp.asarray(n.numpy()),
        interpret=True)
    _assert_table(want, got)
    assert not got.valid.any() and (got.n_blobs == 0).all()
    assert (sc == 0).all()


def test_blob_stats_tiled_int32_bound():
    lab = torch.full((1, 4, 40000), 4 * 40000, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        stats_tiled.blob_stats_tiled(
            lab, lab < 0, torch.zeros((1, 4, 40000), dtype=torch.uint8),
            band=2, root_table=torch.zeros((1, 64), dtype=torch.int32),
            root_count=torch.zeros((1,), dtype=torch.int32))
    stats_tiled.check_sum_bound(1080, 1920)        # the 2 MP design point


def test_plain_versions_of_the_stats_kernels():
    """banded_stats_reference and bbox_sums_reference against the
    whole-frame integral-image sums of ops/blobs.py."""
    from heimdall_tpu_torch.ops import blobs

    mask, gray, color = _blobs(2, 50, 48, 6, seed=77)
    mask = ccl_tiled.flood_reference(_t(mask))
    lab, rl, n, sl, sc = ccl_tiled.connected_components_tiled(
        mask, band=16, return_roots=8, band_slots=True)
    planes = tuple(_t(color[..., c]) for c in range(3))
    sums, bbox, bgsum, nb = blobs.blob_sums(lab, mask, _t(gray), planes, 8)
    s2, b2 = stats_tiled.banded_stats_reference(lab, mask, _t(gray),
                                                _t(color), rl, n, 8)
    valid = sums[:, 0] > 0
    assert torch.equal(s2, sums)
    assert torch.equal(torch.where(valid[:, None], b2, 0), bbox)
    assert torch.equal(nb, n)
    box = stats_tiled.bbox_sums_reference(b2, sl, sc, 16, _t(gray),
                                          _t(color))
    assert torch.equal(box, bgsum)
