"""The port's sweep hole fill probe (ops/fill_sweeps.py) against
heimdall_tpu's.

The Pallas kernel of scripts/profile_fill_variants.py is a closure inside
the script's main(), so this file rebuilds its bodies (fill_param and the
nine VARIANTS, with "new" = pallas_kernels._fill_holes_sweeps as it stands)
from heimdall_tpu's own helpers and runs them with tests/test_torch_split.py's
interpret-mode harness on its 16 frames of 64x128: bench cases, adversarial
masks (noise, spiral, rings, edges) and the check_joint_label geometry
(nested, spiral, borders_checker, u_beside_o, frame_edge, empty).

* The plain sweep fill equals the output of every one of the nine JAX
  variants exactly (the nine are one function), at contrast 15 and, for a
  full-foreground frame, at contrast -15.
* It equals the port's union-find ops/ccl.py::fill_holes at 64x128 and the
  label kernel's "fill" stage, and JAX's XLA heimdall_tpu.ops.ccl.fill_holes
  on 640x480 bench frames.
* run_ids_reference is _run_pack's run-id plane (big = 2) with and without
  guard rows.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_probes_cuda.py and chip_smoke.py.  JAX outputs are
computed once per file (cached).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from heimdall_tpu.ops import ccl as jccl
from heimdall_tpu.ops import pallas_kernels as pk

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import fill_sweeps as fs
from heimdall_tpu_torch.ops import split_kernels as sk
from heimdall_tpu_torch.ops.ccl import fill_holes

from test_torch_split import (CT, FRAMES, GEOMETRY, H, NAMES, W, _pallas,
                              _s2_planes)


def _mxu_cumsum(x):
    Hx, Wx = x.shape
    i = jax.lax.broadcasted_iota(jnp.int32, (Wx, Wx), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (Wx, Wx), 1)
    tri = (i <= j).astype(jnp.bfloat16)
    out = jax.lax.dot_general(x.astype(jnp.bfloat16), tri,
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return out.astype(jnp.int32)


def _pack(fg, big, mk, mode):
    if mode == "mxu":
        start = fg & (1 - pk._shift_const(fg, 1, 1, 0))
        return _mxu_cumsum(start) * big
    return pk._run_pack(fg, big, mk)


def _scan_max_iota(v, axis_size, reverse, fill, max_steps):
    steps = max(1, math.ceil(math.log2(axis_size)))
    if max_steps is not None:
        steps = min(steps, max_steps)
    d = 1
    sgn = 1 if not reverse else -1
    for _ in range(steps):
        v = jnp.maximum(v, pk._shift_const(v, sgn * d, 1, fill))
        d *= 2
    return v


def _run_or(f, rb, mk, mode, ms=None):
    if mode == "iota":
        n = f.shape[1]
        f = _scan_max_iota(f + rb, n, False, -(1 << 30), ms) - rb
        return _scan_max_iota(f - rb, n, True, -(1 << 30), ms) + rb
    return pk._run_or_packed(f, rb, mk, max_steps=ms)


def _fill_param(fg, border, pack_mode, scan_mode, grow_mode, guard):
    """profile_fill_variants.py's fill_param."""
    Hf, Wf = fg.shape
    G = 8 if guard else 0
    Hg = Hf + 2 * G
    if guard:
        zrow = jnp.zeros((G, Wf), fg.dtype)
        orow = jnp.ones((G, Wf), fg.dtype)
        fgx = jnp.concatenate([zrow, fg, zrow], axis=0)
        borderx = jnp.concatenate([orow, border, orow], axis=0)
    else:
        fgx, borderx = fg, border
    bg = 1 - fgx
    bg_t = jnp.transpose(bg)
    mk_r = pk._EdgeMasks(Wf)
    mk_t = pk._EdgeMasks(Hg)
    rb_r = _pack(bg, 2, mk_r, pack_mode)
    rb_t = _pack(bg_t, 2, mk_t, pack_mode)

    def grow4(e):
        if grow_mode == "old":
            g = e
            for s, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
                g = g | pk._shift_const(e, s, axis, 0)
            return g & bg
        row = jnp.maximum(
            jnp.maximum(e, pk._roll_lane(e, 1) - mk_r.pen_f[0]),
            pk._roll_lane(e, -1) - mk_r.pen_b[0])
        if guard:
            up = pltpu.roll(e, 1, 0)
            dn = pltpu.roll(e, Hg - 1, 0)
        else:
            up = pk._shift_const(e, 1, 0, 0)
            dn = pk._shift_const(e, -1, 0, 0)
        return jnp.maximum(row, jnp.maximum(up, dn)) & bg

    def phase_r(e):
        return _run_or(grow4(e), rb_r, mk_r, scan_mode) & bg

    def phase_c(e, ms):
        gt = jnp.transpose(grow4(e))
        et = _run_or(gt, rb_t, mk_t, scan_mode, ms=ms) & bg_t
        return jnp.transpose(et)

    def body(c):
        ext = phase_c(phase_r(c[0]), ms=5)
        return ext, jnp.max(grow4(ext) & (1 - ext))

    ext = jax.lax.while_loop(lambda c: c[1] > 0, body,
                             (bg * borderx, jnp.int32(1)))[0]
    filled = 1 - ext
    if guard:
        filled = jax.lax.slice_in_dim(filled, G, G + Hf, axis=0)
    return filled


# profile_fill_variants.py's VARIANTS ("new" is _fill_holes_sweeps)
JAX_VARIANTS = {
    "new": None,
    "mxu_pack": dict(pack_mode="mxu", scan_mode="masked", grow_mode="new",
                     guard=True),
    "iota_scan": dict(pack_mode="ladder", scan_mode="iota", grow_mode="new",
                      guard=True),
    "old_grow": dict(pack_mode="ladder", scan_mode="masked",
                     grow_mode="old", guard=True),
    "r3": dict(pack_mode="mxu", scan_mode="iota", grow_mode="old",
               guard=False),
    "masked_only": dict(pack_mode="mxu", scan_mode="masked",
                        grow_mode="old", guard=False),
    "guards_only": dict(pack_mode="mxu", scan_mode="iota", grow_mode="old",
                        guard=True),
    "ladder_only": dict(pack_mode="ladder", scan_mode="iota",
                        grow_mode="old", guard=False),
    "new2": dict(pack_mode="ladder", scan_mode="masked", grow_mode="new",
                 guard=True),
}


@functools.lru_cache(maxsize=None)
def _jax_fill(variant, ct=CT):
    cfg = JAX_VARIANTS[variant]

    def kernel(ct_ref, frame_ref, out_ref):
        row_idx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        col_idx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        fg0 = (_s2_planes(ct_ref, frame_ref, "full") > 0).astype(jnp.int32)
        border = ((row_idx == 0) | (row_idx == H - 1) | (col_idx == 0)
                  | (col_idx == W - 1)).astype(jnp.int32)
        if cfg is None:
            out_ref[0] = pk._fill_holes_sweeps(fg0, border, 2, adaptive=True)
        else:
            out_ref[0] = _fill_param(fg0, border, **cfg)

    ct_arr = jnp.asarray(ct, jnp.int32).reshape(1)
    return np.asarray(_pallas(kernel, 1, [(H, W)])(ct_arr,
                                                   jnp.asarray(FRAMES))[0])


@functools.lru_cache(maxsize=None)
def _port(ct=CT):
    return fs.fill_sweeps_reference(torch.from_numpy(FRAMES), ct).numpy()


def _assert_frames_equal(want, got):
    for i, name in enumerate(NAMES):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)


def test_variants_table_matches_profiler():
    """The port's (pack, scan, grow, guard) of every variant, and "new" is
    r3's tuple (_fill_holes_sweeps: _run_pack without masks, plain scans,
    the shifted-OR grow, no guard rows)."""
    for name, cfg in JAX_VARIANTS.items():
        cfg = cfg or JAX_VARIANTS["r3"]
        assert fs.VARIANTS[name] == (cfg["pack_mode"], cfg["scan_mode"],
                                     cfg["grow_mode"], cfg["guard"]), name


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_plain_sweep_fill_matches_profiler_variant(variant):
    got = _port()
    assert got.dtype == np.uint8
    _assert_frames_equal(_jax_fill(variant), got)


def test_full_foreground_frame():
    """A uniform frame at contrast -15 is all foreground: filled
    everywhere, as JAX's _fill_holes_sweeps gives it."""
    got = _port(-CT)
    i = NAMES.index("empty")
    assert got[i].all()
    _assert_frames_equal(_jax_fill("new", -CT), got)


def test_plain_sweep_fill_matches_union_find_and_fill_stage():
    x = torch.from_numpy(FRAMES)
    pre = sk.label_kernel_reference(x, CT, "pre")
    _assert_frames_equal(fill_holes(pre > 0).to(torch.uint8).numpy(),
                         _port())
    _assert_frames_equal(sk.label_kernel_reference(x, CT, "fill").numpy(),
                         _port())


@pytest.mark.parametrize("name", ["nested", "spiral", "borders_checker",
                                  "frame_edge", "empty"])
def test_sweep_fill_of_geometry_masks(name):
    """The masks themselves (not through the preprocess): the sweep fill
    is the union-find fill and JAX's XLA fill_holes."""
    mask = torch.from_numpy(GEOMETRY[name][None].astype(np.uint8))
    got = fs.sweep_fill_reference(mask)
    assert torch.equal(got, fill_holes(mask > 0).to(torch.uint8))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jccl.fill_holes(jnp.asarray(mask.numpy() > 0)))
        .astype(np.uint8))


def test_sweep_fill_matches_xla_fill_holes_640x480():
    frames = scene.make_frames(2)
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))
    pre = sk.label_kernel_reference(x, CT, "pre")
    want = np.asarray(jccl.fill_holes(jnp.asarray(pre.numpy() > 0)))
    got = fs.sweep_fill_reference(pre)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))
    assert torch.equal(got, fs.fill_sweeps(x, CT))


@pytest.mark.parametrize("guard", [False, True])
def test_run_ids_match_run_pack(guard):
    """run_ids_reference's planes are _run_pack(bg, 2) along the rows and
    along the columns of the (guarded) background of the "pre" plane."""
    Hg = H + (16 if guard else 0)

    def kernel(ct_ref, frame_ref, rows_ref, cols_ref):
        fg = (_s2_planes(ct_ref, frame_ref, "full") > 0).astype(jnp.int32)
        if guard:
            z = jnp.zeros((8, W), jnp.int32)
            fg = jnp.concatenate([z, fg, z], axis=0)
        bg = 1 - fg
        rows_ref[0] = pk._run_pack(bg, 2)
        cols_ref[0] = pk._run_pack(jnp.transpose(bg), 2)

    rows, cols = _pallas(kernel, 1, [(Hg, W), (W, Hg)])(
        jnp.asarray(CT, jnp.int32).reshape(1), jnp.asarray(FRAMES))
    pre = sk.label_kernel_reference(torch.from_numpy(FRAMES), CT, "pre")
    rb_r, rb_t = fs.run_ids_reference(pre, guard)
    _assert_frames_equal(np.asarray(rows), rb_r.numpy())
    _assert_frames_equal(np.asarray(cols), rb_t.numpy())


def test_cpu_wrappers_run_plain_versions():
    x = torch.from_numpy(FRAMES[:2])
    before = (fs.fill_sweeps.launches, fs.run_ids.launches)
    for variant in fs.VARIANTS:
        assert torch.equal(fs.fill_sweeps(x, CT, variant),
                           fs.fill_sweeps_reference(x, CT))
    mask = sk.label_kernel_reference(x, CT, "pre")
    for a, b in zip(fs.run_ids(mask, True, "ladder"),
                    fs.run_ids_reference(mask, True)):
        assert torch.equal(a, b)
    assert (fs.fill_sweeps.launches, fs.run_ids.launches) == before


@pytest.mark.parametrize("case", ["bad_variant", "too_wide", "bad_pack",
                                  "nhwc"])
def test_wrappers_reject_other_forms(case):
    x = torch.from_numpy(FRAMES[:2])
    wide = torch.zeros((1, 3, 8, 1100), dtype=torch.uint8)
    calls = {
        "bad_variant": lambda: fs.fill_sweeps(x, CT, "r4"),
        "too_wide": lambda: fs.fill_sweeps(wide, CT),
        "bad_pack": lambda: fs.run_ids(x[:, 0], False, "iota"),
        "nhwc": lambda: fs.fill_sweeps(x.permute(0, 2, 3, 1), CT),
    }
    with pytest.raises(ValueError):
        calls[case]()
