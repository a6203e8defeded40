"""The port's run-table route against heimdall_tpu's (JAX on the CPU, Pallas
kernels in interpret mode).

The same seeded numpy masks and frames go through the JAX package's
run-table extraction kernel (B3a), its banded preprocess with background
tables (B2) and its fill_label_runtable_tiled (B3b-B3e), and through
the port's ops/runtable_tiled.py / preprocess_tiled.py with CPU tensors,
i.e. through the plain PyTorch versions of the CUDA kernels.  Everything
compared is an integer, boolean or table value: tolerance 0.  Float table
fields of the whole program are within 1e-6 of jitted XLA (it rewrites
x / 30 as x * (1/30)).  These modules have no parameters, so no weights are
carried across.

The masks are those of tests/test_runtable_tiled.py (70x96 and 64x96, band
16), plus rows that trip each density guard, empty and full frames, and
mixed batches where one frame fits the tables and the other does not (the
port falls back per frame, JAX per batch: the outputs are equal).  The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_runtable_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from heimdall_tpu.detectors.contamination_detector import (
    contamination_program as jax_program)
from heimdall_tpu.ops.preprocess_tiled import (
    contamination_preprocess_tiled as jax_preprocess_tiled)
from heimdall_tpu.ops.runtable_tiled import (_make_extract_kernel,
                                             fill_label_runtable_tiled as
                                             jax_fill_label)

from heimdall_tpu_torch.detectors import contamination_detector as det_mod
from heimdall_tpu_torch.detectors.contamination_detector import (
    contamination_program)
from heimdall_tpu_torch.ops import runtable_tiled as rt
from heimdall_tpu_torch.ops.preprocess_tiled import (
    contamination_preprocess_tiled)

BAND = 16
K = 16


def _shapes(H=70, W=96):
    """The ring, blob and tall bar of tests/test_runtable_tiled.py."""
    yy, xx = np.mgrid[0:H, 0:W]
    d2 = (yy - 30) ** 2 + (xx - 30) ** 2
    ring = (d2 >= 64) & (d2 <= 144)
    blob = ((yy - 50) ** 2 + (xx - 70) ** 2) <= 36
    tall = np.zeros((H, W), bool)
    tall[5:65, 80:84] = True
    return ring, blob, tall


def _edges_and_u(H=70, W=96):
    ring, _, _ = _shapes(H, W)
    m = np.zeros((H, W), bool)
    m[0:8, 0:30] = True                 # touches top + left border
    m[-6:, 60:] = True                  # bottom-right corner
    m |= ring
    u = np.zeros((H, W), bool)          # U open to the border next to an O
    u[10:60, 4:7] = u[10:60, 30:33] = u[57:60, 4:33] = True
    u[10:60, 50:53] = u[10:60, 76:79] = True
    u[10:13, 50:79] = u[57:60, 50:79] = True
    return m, u


def _board(H=70, W=96, phase=0):
    """Checkerboard rows: more background and foreground runs than any
    table holds, so both guards trip."""
    m = np.zeros((H, W), bool)
    m[20:40, 10:90] = (np.indices((20, 80)).sum(0) + phase) % 2 == 1
    return m


def _stripes(H=70, W=96, n=8):
    """n full-height foreground stripes, the first at column 0 and the last
    at column W-1: n - 1 background runs per row (all reached from the
    border) but n foreground runs, so at (r_bg, r_fg) = (8, 7) only the
    foreground guard trips."""
    m = np.zeros((H, W), bool)
    for s in np.linspace(0, W - 4, n).astype(int):
        m[:, s:s + 4] = True
    return m


def _fuzz(n, H=64, W=96, seed=123):
    """The random discs, rings and bars of tests/test_runtable_tiled.py."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    masks = []
    for _ in range(n):
        m = np.zeros((H, W), bool)
        for _ in range(rng.randint(1, 12)):
            kind = rng.randint(3)
            y, x = rng.randint(0, H), rng.randint(0, W)
            if kind == 0:
                r = rng.randint(1, 10)
                m |= (yy - y) ** 2 + (xx - x) ** 2 <= r * r
            elif kind == 1:
                r = rng.randint(4, 12)
                d2 = (yy - y) ** 2 + (xx - x) ** 2
                m |= (d2 >= (r - 2) ** 2) & (d2 <= r * r)
            else:
                h2, w2 = rng.randint(1, 20), rng.randint(1, 30)
                m[max(0, y - h2):y + h2, max(0, x - w2):x + w2] = True
        masks.append(m)
    return masks


def _cases():
    ring, blob, tall = _shapes()
    m, u = _edges_and_u()
    H, W = 70, 96
    cases = {    # name: (masks [2, H, W], r_bg, r_fg)
        "basic": ([ring | blob, tall | blob], 8, 7),
        "edges_and_u": ([m, u], 8, 7),
        "board_trips_both_guards": ([_board(), _board(phase=1)], 8, 7),
        "empty_and_full": ([np.zeros((H, W), bool), np.ones((H, W), bool)],
                           8, 7),
        "stripes_trip_fg_guard": ([_stripes(), _stripes(n=9)], 8, 7),
        "mixed_fits_and_board": ([ring | blob, _board()], 8, 7),
        "mixed_fits_and_stripes": ([_stripes(), m], 8, 7),
    }
    fuzz = _fuzz(10)
    for i in range(0, 10, 2):
        cases[f"fuzz{i // 2}_r12_10"] = (fuzz[i:i + 2], 12, 10)
    return {k: (np.stack(v[0]), v[1], v[2]) for k, v in cases.items()}


CASES = _cases()


def _padded(masks):
    """JAX's fill_label_runtable_tiled input: u8 {0, 255}, whole bands."""
    B, H, W = masks.shape
    out = np.zeros((B, -(-H // BAND) * BAND, W), np.uint8)
    out[:, :H] = masks * np.uint8(255)
    return out


@functools.lru_cache(maxsize=None)
def _jax_route(case):
    masks, r_bg, r_fg = CASES[case]
    out = jax_fill_label(jnp.asarray(_padded(masks)), band=BAND,
                         frame_h=masks.shape[1], max_blobs=K, r_bg=r_bg,
                         r_fg=r_fg, interpret=True)
    return tuple(np.asarray(x) for x in out)


def _assert_route(want, got):
    names = ("filled", "labels", "root_table", "n_blobs", "slot_list",
             "slot_count")
    for name, a, b in zip(names, want, got):
        assert b.shape == a.shape, name
        if name != "slot_list":
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    sl_w, sl_g, sc = want[4], got[4].numpy(), want[5]
    for b in range(sc.shape[0]):
        for r in range(sc.shape[1]):
            n = sc[b, r]
            np.testing.assert_array_equal(sl_g[b, r, :n], sl_w[b, r, :n])


@pytest.mark.parametrize("pre_extracted", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fill_label_matches_jax(case, pre_extracted):
    masks, r_bg, r_fg = CASES[case]
    binary = torch.from_numpy(_padded(masks))
    tables = (rt.run_extract(binary, r_bg, invert=True) if pre_extracted
              else None)
    got = rt.fill_label_runtable_tiled(binary, BAND, frame_h=masks.shape[1],
                                       max_blobs=K, r_bg=r_bg, r_fg=r_fg,
                                       pre_extracted=tables)
    _assert_route(_jax_route(case), got)
    route = rt.fill_label_runtable_tiled.last_route.tolist()
    if case.startswith(("board", "stripes")):
        assert route == [False, False]
    elif case.startswith("mixed"):
        assert route == ([True, False] if "board" in case else
                         [False, True])
    elif case in ("basic", "edges_and_u"):
        assert route == [True, True]


def test_fill_label_unpadded_layout():
    """Without frame_h the planes are [B, H, W], the port's own layout."""
    masks, r_bg, r_fg = CASES["mixed_fits_and_board"]
    want = _jax_route("mixed_fits_and_board")
    got = rt.fill_label_runtable_tiled(torch.from_numpy(masks), BAND,
                                       max_blobs=K, r_bg=r_bg, r_fg=r_fg)
    H = masks.shape[1]
    _assert_route((want[0][:, :H], want[1][:, :H]) + want[2:], got)


# ------------------------------------------------------- run extraction

def _jax_extract(plane, R, invert):
    """JAX's B3a kernel on whole frames (one grid step per frame)."""
    B, H, W = plane.shape

    def spec(w):
        return pl.BlockSpec((1, H, w), lambda b: (b, 0, 0))

    call = pl.pallas_call(
        _make_extract_kernel(H, W, R, invert=invert), grid=(B,),
        in_specs=[spec(W)],
        out_specs=[spec(W), spec(R), spec(R), spec(1)],
        out_shape=[jax.ShapeDtypeStruct((B, H, W), jnp.uint8),
                   jax.ShapeDtypeStruct((B, H, R), jnp.int32),
                   jax.ShapeDtypeStruct((B, H, R), jnp.int32),
                   jax.ShapeDtypeStruct((B, H, 1), jnp.int32)],
        interpret=True)
    return tuple(np.asarray(x) for x in call(jnp.asarray(plane)))


def _alternating(H=4, W=600):
    """300 one-pixel runs per row: runid wraps past 255."""
    m = np.zeros((2, H, W), bool)
    m[0, :, ::2] = True
    m[1, :, 1::3] = True
    return m


EXTRACT_PLANES = {
    "basic": CASES["basic"][0],
    "board": CASES["board_trips_both_guards"][0],
    "stripes": CASES["stripes_trip_fg_guard"][0],
    "fuzz": CASES["fuzz0_r12_10"][0],
    "alternating_wraps_runid": _alternating(),
}


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("R", [7, 12])
@pytest.mark.parametrize("plane", sorted(EXTRACT_PLANES))
def test_run_extract_matches_jax(plane, R, invert):
    masks = EXTRACT_PLANES[plane].astype(np.uint8) * np.uint8(255)
    want = _jax_extract(masks, R, invert)
    got = rt.run_extract(torch.from_numpy(masks), R, invert)
    for name, a, b in zip(("runid", "S", "E", "nrun"), want, got):
        assert b.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    if plane.startswith("alternating"):
        assert int(got[3].max()) > 255


# ----------------------------------------------------- B2: the preprocess

def _frames(n, h, w, seed):
    """Light BGR frames with dark discs and, in the last frame, a band of
    dark 4x4 checker cells whose rows overflow the tables."""
    rng = np.random.RandomState(seed)
    frames = np.full((n, h, w, 3), 215, np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        for _ in range(5):
            cy, cx = rng.randint(8, h - 8), rng.randint(8, w - 8)
            r = rng.randint(2, 7)
            frames[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = (
                rng.randint(0, 90), rng.randint(0, 90), rng.randint(0, 90))
    cells = (np.indices((16, w - 16)) // 4).sum(0) % 2 == 0
    frames[-1, 30:46, 8:w - 8][cells] = 10
    return frames


BGR = _frames(2, 70, 96, seed=5)


@functools.lru_cache(maxsize=None)
def _jax_preprocess(channel_major):
    x = BGR.transpose(0, 3, 1, 2) if channel_major else BGR
    out = jax_preprocess_tiled(jnp.asarray(np.ascontiguousarray(x)), 15,
                               band=BAND, interpret=True,
                               channel_major=channel_major, padded_out=True,
                               bg_tables=8)
    return tuple(np.asarray(t)[:, :BGR.shape[1]] for t in out)


@pytest.mark.parametrize("channel_major", [False, True])
def test_preprocess_tiled_matches_jax(channel_major):
    x = BGR.transpose(0, 3, 1, 2) if channel_major else BGR
    got = contamination_preprocess_tiled(
        torch.from_numpy(np.ascontiguousarray(x)), 15, channel_major,
        bg_tables=8)
    want = _jax_preprocess(channel_major)
    np.testing.assert_array_equal(got[0].numpy() * 255, want[0])
    for name, a, b in zip(("gray", "runid", "S", "E", "nrun"), want[1:],
                          got[1:]):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert int(got[5].max()) > 8          # the checker rows overflow


# ------------------------------------------------- the detection program

GATES = (15, 3.0, 3000.0, 0.2)


@functools.lru_cache(maxsize=None)
def _jax_program():
    ct, lo, hi, conf = GATES
    out = jax_program(jnp.asarray(BGR), jnp.int32(ct), jnp.float32(lo),
                      jnp.float32(hi), jnp.float32(conf), return_labels=True,
                      tiled_band=32)
    table = type(out[0])(*(np.asarray(f) for f in out[0]))
    return (table,) + tuple(np.asarray(a) for a in out[1:])


def _assert_outputs(want, got):
    (wt, wc, wa, wl), (gt, gc, ga, gl) = want, got
    for f in wt._fields:
        a, b = getattr(wt, f), getattr(gt, f).numpy()
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_allclose(gc.numpy(), wc, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ga.numpy(), wa)
    np.testing.assert_array_equal(gl.numpy(), wl)


def _spy(monkeypatch, name, calls):
    real = getattr(det_mod, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(det_mod, name, spy)


@pytest.mark.parametrize("form", ["bgr", "bgr_planes"])
def test_program_takes_runtable_route_and_matches_jax(form, monkeypatch):
    calls = []
    for name in ("contamination_preprocess_tiled",
                 "fill_label_runtable_tiled", "fill_holes_tiled",
                 "connected_components_tiled"):
        _spy(monkeypatch, name, calls)
    wrappers = (rt.run_extract, rt.flood_fix, rt.fill_extract, rt.label_fix,
                rt.writeback, contamination_preprocess_tiled)
    before = [w.launches for w in wrappers]
    x = BGR if form == "bgr" else BGR.transpose(0, 3, 1, 2)
    got = contamination_program(torch.from_numpy(np.ascontiguousarray(x)),
                                *GATES, return_labels=True, tiled_band=32,
                                channel_major=form == "bgr_planes")
    assert calls == ["contamination_preprocess_tiled",
                     "fill_label_runtable_tiled"]
    assert [w.launches for w in wrappers] == before     # plain versions
    assert rt.fill_label_runtable_tiled.last_route.tolist() == [True, False]
    _assert_outputs(_jax_program(), got)
    assert got[2].any() and int(got[0].n_blobs.min()) > 0


@pytest.mark.parametrize("form", ["mono8", "bgr_without_runtable"])
def test_band_route_stays_for_mono8(form, monkeypatch):
    """Mono8 frames keep the band route; so does BGR with
    tiled_runtable=False, with the same outputs."""
    calls = []
    for name in ("fill_label_runtable_tiled", "fill_holes_tiled"):
        _spy(monkeypatch, name, calls)
    mono = form == "mono8"
    x = np.ascontiguousarray(BGR[..., 1]) if mono else BGR
    got = contamination_program(torch.from_numpy(x), *GATES,
                                return_labels=True, tiled_band=32,
                                tiled_runtable=mono)
    assert calls == ["fill_holes_tiled"]
    if not mono:
        _assert_outputs(_jax_program(), got)


# ---------------------------------------- plain versions, truncated tables

def _components(S, E, W, dilate):
    """Components of the valid runs of tables [H, R] by breadth-first
    search over overlapping runs of adjacent rows: {node: component id}."""
    H, R = S.shape
    nodes = [(y, k) for y in range(H) for k in range(R) if S[y, k] < rt.BIGC]
    comp = {}
    for start in nodes:
        if start in comp:
            continue
        comp[start] = start
        todo = [start]
        while todo:
            y, k = todo.pop()
            for yy in (y - 1, y + 1):
                if not 0 <= yy < H:
                    continue
                for kk in range(R):
                    if (S[yy, kk] < rt.BIGC and (yy, kk) not in comp
                            and S[y, k] - dilate <= E[yy, kk]
                            and E[y, k] + dilate >= S[yy, kk]):
                        comp[(yy, kk)] = start
                        todo.append((yy, kk))
    return comp


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_fix_versions_on_truncated_tables(seed):
    """flood_fix_reference and label_fix_reference over the valid runs of
    tables whose rows overflow (what the CUDA kernels compute there too)
    against a search over the runs themselves."""
    H, W, R = 24, 40, 5
    masks = torch.from_numpy(np.random.RandomState(seed).rand(2, H, W) < 0.4)
    _, S, E, nrun = rt.run_extract(masks, R, invert=True)
    assert int(nrun.max()) > R
    F = rt.flood_fix(S, E, W)
    L, rl, n, _, _ = rt.label_fix(S, E, W, BAND, K)
    for b in range(2):
        s, e = S[b].numpy(), E[b].numpy()
        for dilate, check in ((0, "flood"), (1, "label")):
            comp = _components(s, e, W, dilate)
            members = {}
            for node, c in comp.items():
                members.setdefault(c, []).append(node)
            for c, nodes in members.items():
                if check == "flood":
                    reached = any(y in (0, H - 1) or s[y, k] == 0
                                  or e[y, k] == W - 1 for y, k in nodes)
                    for y, k in nodes:
                        assert int(F[b, y, k]) == (0 if reached else 1)
                else:
                    low = min(y * W + s[y, k] for y, k in nodes)
                    for y, k in nodes:
                        assert int(L[b, y, k]) == low
        invalid = s >= rt.BIGC
        assert (F[b].numpy()[invalid] == 1).all()
        assert (L[b].numpy()[invalid] == H * W).all()
        roots = sorted({int(v) for v in L[b].numpy()[~invalid]})
        assert int(n[b]) == len(roots)
        want = (roots + [H * W] * K)[:K]
        np.testing.assert_array_equal(rl[b].numpy(), want)


def test_active_frames_only():
    """With active, a wrapper computes the frames it marks and leaves the
    others' outputs untouched (zeros on the CPU)."""
    masks = torch.from_numpy(CASES["basic"][0])
    active = torch.tensor([False, True])
    runid, S, E, nrun = rt.run_extract(masks, 8, active=active)
    full = rt.run_extract(masks, 8)
    for a, b in zip((runid, S, E, nrun), full):
        assert torch.equal(a[1], b[1]) and not a[0].any()
