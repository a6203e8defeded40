"""The port's labeling probes (ops/ccl_sweeps.py: the sweep CCL and the
run-table CCL) against heimdall_tpu's.

The Pallas kernel of scripts/profile_ccl_variants.py is a closure inside
the script's main(), so this file rebuilds its bodies (ccl_param and
VARIANTS, with "cur" = pallas_kernels._ccl_sweeps(adaptive=True,
scan_steps=5)) from heimdall_tpu's own helpers, and takes the module-level
ccl_runtable from the script itself.  They run with tests/test_torch_split.py's
interpret-mode harness on its 16 frames of 64x128 (bench cases, adversarial
masks, the check_joint_label geometry): the script's front_body (preprocess
and _fill_holes_sweeps) once, then each variant on its filled mask.

* The plain version of every variant equals the JAX variant exactly, fixed2
  included; every variant but fixed2 equals the union-find labels.
* The run tables' per-frame fits flags are JAX's max(nrun) <= R.
* scripts/check_runtable.py's run_pair form on its seven masks at 96x128,
  R = 12 and 8: sweeps == run tables == the plain labels ==
  connected_components, the overflow mask not fitting; and the port's
  check_runtable script with the plain versions.
* ops/ccl.py's connected_components and fill_holes equal JAX's XLA ops on
  640x480 bench frames, and the plain sweep CCL equals them there.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_ccl_cuda.py and chip_smoke.py.  JAX outputs are computed
once per file (cached).
"""

import functools
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from heimdall_tpu.ops import ccl as jccl
from heimdall_tpu.ops import pallas_kernels as pk

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import ccl_sweeps as cs
from heimdall_tpu_torch.ops import split_kernels as sk
from heimdall_tpu_torch.ops.ccl import connected_components, fill_holes
from heimdall_tpu_torch.scripts import check_runtable

from test_torch_split import CT, FRAMES, GEOMETRY, H, NAMES, W, _pallas, \
    _s2_planes

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "scripts"))
from profile_ccl_variants import ccl_runtable  # noqa: E402

SENTINEL = H * W


def _ccl_param(lab, fg, sentinel, ss, cert, guard, fixed=None, unit=3,
               presweep=False, ss_r=None):
    """profile_ccl_variants.py's ccl_param."""
    Hc, Wc = lab.shape
    G = 8 if guard else 0
    Hg = Hc + 2 * G
    if guard:
        srow = jnp.full((G, Wc), sentinel, lab.dtype)
        zrow = jnp.zeros((G, Wc), fg.dtype)
        labx = jnp.concatenate([srow, lab, srow], axis=0)
        fgx = jnp.concatenate([zrow, fg, zrow], axis=0)
    else:
        labx, fgx = lab, fg
    big = 1 << max(1, math.ceil(math.log2(sentinel + 2)))
    mk_r = pk._EdgeMasks(Wc)
    mk_t = pk._EdgeMasks(Hg)
    rb_r = pk._run_pack(fgx, big, mk_r)
    fg_t = jnp.transpose(fgx)
    rb_t = pk._run_pack(fg_t, big, mk_t)

    def nb(l):
        row = jnp.minimum(l, jnp.minimum(
            pk._roll_lane(l, 1) + mk_r.pen_f[0],
            pk._roll_lane(l, -1) + mk_r.pen_b[0]))
        if guard:
            return jnp.minimum(row, jnp.minimum(
                pltpu.roll(row, 1, 0), pltpu.roll(row, Hg - 1, 0)))
        return jnp.minimum(row, jnp.minimum(
            pk._shift_const(row, 1, 0, sentinel),
            pk._shift_const(row, -1, 0, sentinel)))

    def phase_r(l, ms):
        l = jnp.where(fgx > 0, nb(l), sentinel)
        return jnp.where(fgx > 0, pk._run_min_packed(l, rb_r, mk_r,
                                                     max_steps=ms), sentinel)

    def phase_c(l, ms):
        l = jnp.where(fgx > 0, nb(l), sentinel)
        lt = jnp.transpose(l)
        lt = jnp.where(fg_t > 0, pk._run_min_packed(lt, rb_t, mk_t,
                                                    max_steps=ms), sentinel)
        return jnp.transpose(lt)

    sr = ss if ss_r is None else (None if ss_r == "full" else ss_r)

    def unit3(l):
        if unit == 2:
            return phase_c(phase_r(l, sr), ss)
        return phase_r(phase_c(phase_r(l, sr), ss), sr)

    def strip(l):
        if guard:
            return jax.lax.slice_in_dim(l, G, G + Hc, axis=0)
        return l

    if presweep:
        labx = phase_r(phase_c(phase_r(labx, None), None), None)

    if fixed is not None:
        l = labx
        for _ in range(fixed):
            l = unit3(l)
        return strip(l)

    if cert == "cheap":
        def body(c):
            old = c[0]
            new = unit3(old)
            return new, old, jnp.max(jnp.where(new < old, 1, 0))

        return strip(jax.lax.while_loop(lambda c: c[2] > 0, body,
                                        (labx, labx, jnp.int32(1)))[0])

    def body(c):
        l = unit3(c[0])
        nm = jnp.where(fgx > 0, nb(l), sentinel)
        return l, jnp.max(jnp.where(nm < l, 1, 0))

    return strip(jax.lax.while_loop(lambda c: c[1] > 0, body,
                                    (labx, jnp.int32(1)))[0])


# profile_ccl_variants.py's VARIANTS ("cur" is _ccl_sweeps)
JAX_VARIANTS = {
    "cur": None,
    "ss4": dict(ss=4, cert="nb", guard=True),
    "ss6": dict(ss=6, cert="nb", guard=True),
    "cheapcert": dict(ss=5, cert="cheap", guard=True),
    "noguard": dict(ss=5, cert="nb", guard=False),
    "fixed2": dict(ss=5, cert="nb", guard=True, fixed=2),
    "presweep": dict(ss=5, cert="nb", guard=True, presweep=True),
    "unit2": dict(ss=5, cert="nb", guard=True, unit=2),
    "pre_unit2": dict(ss=5, cert="nb", guard=True, unit=2, presweep=True),
    "asym_r10": dict(ss=5, cert="nb", guard=True, ss_r="full"),
    "pre_ss4": dict(ss=4, cert="nb", guard=True, presweep=True),
    "runtable": "runtable",
    "runtable8": "runtable8",
    "runtable6": "runtable6",
    "runtable10": "runtable10",
}


def _label_planes(h, w):
    row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return row, col


@functools.lru_cache(maxsize=None)
def _jax_filled():
    """The script's front_body's filled mask of FRAMES (int32 0/1)."""
    def kernel(ct_ref, frame_ref, out_ref):
        row, col = _label_planes(H, W)
        fg0 = (_s2_planes(ct_ref, frame_ref, "full") > 0).astype(jnp.int32)
        border = ((row == 0) | (row == H - 1) | (col == 0)
                  | (col == W - 1)).astype(jnp.int32)
        out_ref[0] = pk._fill_holes_sweeps(fg0, border, 2, adaptive=True)

    ct = jnp.asarray(CT, jnp.int32).reshape(1)
    return np.asarray(_pallas(kernel, 1, [(H, W)])(ct,
                                                   jnp.asarray(FRAMES))[0])


@functools.lru_cache(maxsize=None)
def _jax_ccl(variant):
    """The script's make_run(variant) body on _jax_filled's mask."""
    cfg = JAX_VARIANTS[variant]

    def kernel(ct_ref, frame_ref, fg_ref, out_ref):
        row, col = _label_planes(H, W)
        fg = fg_ref[0]
        lab0 = jnp.where(fg > 0, row * W + col, SENTINEL)
        if cfg is None:
            lab = pk._ccl_sweeps(lab0, fg, SENTINEL, 2, adaptive=True,
                                 scan_steps=5)
        elif isinstance(cfg, str):
            rmax = int(cfg[len("runtable"):] or 12)
            lab = ccl_runtable(pk, jnp, jax, pltpu, lab0, fg, SENTINEL,
                               Rmax=rmax)
        else:
            lab = _ccl_param(lab0, fg, SENTINEL, **cfg)
        out_ref[0] = lab

    ct = jnp.asarray(CT, jnp.int32).reshape(1)
    return np.asarray(_pallas(kernel, 2, [(H, W)])(
        ct, jnp.asarray(FRAMES), jnp.asarray(_jax_filled()))[0])


@functools.lru_cache(maxsize=None)
def _jax_row_runs():
    """JAX's runs per row of the filled mask (ccl_runtable's nrun)."""
    def kernel(ct_ref, frame_ref, fg_ref, out_ref):
        fg = fg_ref[0]
        start = fg & (1 - pk._shift_const(fg, 1, 1, 0))
        out_ref[0] = pk._lane_cumsum_mxu(start)

    ct = jnp.asarray(CT, jnp.int32).reshape(1)
    runid = np.asarray(_pallas(kernel, 2, [(H, W)])(
        ct, jnp.asarray(FRAMES), jnp.asarray(_jax_filled()))[0])
    return runid[..., -1]


def _filled():
    return torch.from_numpy(_jax_filled().astype(np.uint8))



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions run thousands of small ops: with one intra-op
    thread each, none waits on threads that the other test workers keep
    off the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _assert_frames_equal(want, got):
    for i, name in enumerate(NAMES):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)


def test_variants_table_matches_profiler():
    """The port's Sweep of every sweep variant is the script's dict, and the
    run-table variants' R is the name's."""
    assert cs.VARIANTS == tuple(JAX_VARIANTS)
    for name, cfg in JAX_VARIANTS.items():
        if isinstance(cfg, str):
            assert cs.RUNTABLE_VARIANTS[name] == int(cfg[8:] or 12)
            continue
        cfg = cfg or dict(ss=5, cert="nb", guard=True)
        assert cs.SWEEP_VARIANTS[name] == cs.Sweep(**cfg), name


def test_front_body_filled_mask_is_fill_stage():
    _assert_frames_equal(
        sk.label_kernel_reference(torch.from_numpy(FRAMES), CT,
                                  "fill").numpy(), _jax_filled())


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_plain_ccl_matches_profiler_variant(variant):
    got = cs.ccl_mask_reference(_filled(), variant)
    assert got.dtype == torch.int32
    _assert_frames_equal(_jax_ccl(variant), got.numpy())


def test_fixpoint_variants_equal_union_find_labels():
    """Every variant but fixed2 is a fixpoint: the label kernel's "ccl"
    stage and connected_components of the filled mask."""
    want = sk.label_kernel_reference(torch.from_numpy(FRAMES), CT)
    assert torch.equal(want, connected_components(_filled() > 0, 8))
    for variant in cs.VARIANTS:
        if variant != "fixed2":
            assert np.array_equal(_jax_ccl(variant), want.numpy()), variant


@pytest.mark.parametrize("rmax", [12, 10, 8, 6])
def test_runtable_fits_flags_are_jax_run_counts(rmax):
    """fits[b] is JAX's max(nrun) <= R over the frame, and the labels are
    "cur"'s."""
    labels, fits = cs.runtable_reference(_filled(), rmax)
    want = (_jax_row_runs().max(-1) <= rmax).astype(np.int32)
    np.testing.assert_array_equal(fits.numpy(), want)
    _assert_frames_equal(_jax_ccl("cur"), labels.numpy())


@pytest.mark.parametrize("rmax", [12, 6])
def test_runtable_falls_back_per_frame(rmax):
    """A batch of the raw noise mask (dozens of runs a row) and the nested
    geometry: the noise frame falls back to "cur", the other takes the
    tables; both give connected_components."""
    masks = torch.from_numpy(np.stack([
        scene.adversarial_masks(H, W, seed=1)["noise"],
        GEOMETRY["nested"]]).astype(np.uint8))
    labels, fits = cs.runtable_reference(masks, rmax)
    assert fits.tolist() == [0, 1]
    assert torch.equal(labels, connected_components(masks > 0, 8))


MASKS = scene.check_runtable_masks()


def _pallas_masks(kernel, masks, n_out):
    """pallas_call of kernel(mask_ref, *out_refs) over int32 masks [n, h,
    w], one grid step per mask, in interpret mode, as
    scripts/check_runtable.py's run_pair launches its kernel: n_out int32
    planes [n, h, w] as numpy arrays."""
    n, h, w = masks.shape
    outs = pl.pallas_call(
        kernel, grid=(n,),
        in_specs=[pl.BlockSpec((1, h, w), lambda i: (i, 0, 0))],
        out_specs=[pl.BlockSpec((1, h, w), lambda i: (i, 0, 0))] * n_out,
        out_shape=[jax.ShapeDtypeStruct((n, h, w), jnp.int32)] * n_out,
        interpret=True)(jnp.asarray(masks))
    return tuple(np.asarray(o) for o in outs)


@functools.lru_cache(maxsize=None)
def _jax_run_pair():
    """scripts/check_runtable.py's run_pair kernel over its seven masks, at
    R = 12 and 8 in one kernel: (a: _ccl_sweeps, {R: b, ccl_runtable})."""
    masks = np.stack(list(MASKS.values())).astype(np.int32)
    _, h, w = masks.shape
    sentinel = h * w

    def kernel(fg_ref, a_ref, b12_ref, b8_ref):
        f = fg_ref[0]
        row, col = _label_planes(h, w)
        lab0 = jnp.where(f > 0, row * w + col, sentinel)
        a_ref[0] = pk._ccl_sweeps(lab0, f, sentinel, 2, adaptive=True,
                                  scan_steps=5)
        for rmax, ref in ((12, b12_ref), (8, b8_ref)):
            ref[0] = ccl_runtable(pk, jnp, jax, pltpu, lab0, f, sentinel,
                                  Rmax=rmax)

    a, b12, b8 = _pallas_masks(kernel, masks, 3)
    return a, {12: b12, 8: b8}


@pytest.mark.parametrize("rmax", [12, 8])
def test_check_runtable_masks_match_run_pair(rmax):
    masks = torch.from_numpy(np.stack(list(MASKS.values())))
    a, b = _jax_run_pair()
    b = b[rmax]
    want = connected_components(masks > 0, 8).numpy()
    labels, fits = cs.runtable_reference(masks, rmax)
    for i, name in enumerate(MASKS):
        np.testing.assert_array_equal(a[i], want[i], err_msg=name)
        np.testing.assert_array_equal(b[i], want[i], err_msg=name)
        assert bool(fits[i]) == (name != "overflow->fallback"), name
    np.testing.assert_array_equal(
        cs.ccl_mask_reference(masks, "cur").numpy(), a)
    np.testing.assert_array_equal(labels.numpy(), b)


@functools.lru_cache(maxsize=None)
def _jax_run_cases(h, w, rmax):
    """The script's ccl_runtable on scene.run_case_masks(h, w)."""
    masks = np.stack(list(scene.run_case_masks(h, w).values())).astype(
        np.int32)
    sentinel = h * w

    def kernel(fg_ref, out_ref):
        f = fg_ref[0]
        row, col = _label_planes(h, w)
        lab0 = jnp.where(f > 0, row * w + col, sentinel)
        out_ref[0] = ccl_runtable(pk, jnp, jax, pltpu, lab0, f, sentinel,
                                  Rmax=rmax)

    return _pallas_masks(kernel, masks, 1)[0]


@pytest.mark.parametrize("h,w,rmax", [(6, 48, 12), (6, 48, 6),
                                      (4, 531, 8)])
def test_runtable_on_run_case_masks(h, w, rmax):
    """Rows of exactly 6 to 13 runs (R and R + 1), runs that start, end
    and cross the 16-column lanes and the 512-column step, one-pixel runs
    on every other column: the plain run tables equal JAX's ccl_runtable,
    and fits is JAX's max(nrun) <= R (some frames fit, some do not)."""
    masks = np.stack(list(scene.run_case_masks(h, w).values()))
    labels, fits = cs.runtable_reference(
        torch.from_numpy(masks.astype(np.uint8)), rmax)
    np.testing.assert_array_equal(labels.numpy(), _jax_run_cases(h, w, rmax))
    starts = masks & ~np.pad(masks, ((0, 0), (0, 0), (1, 0)))[..., :-1]
    want = (starts.sum(-1).max(-1) <= rmax).astype(np.int32)
    np.testing.assert_array_equal(fits.numpy(), want)
    assert 0 < want.sum() < len(want)


def test_check_runtable_script_with_plain_versions(capsys):
    assert check_runtable.main(["cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK  ") == 14 and "ALL OK" in out
    assert "overflow->fallback (Rmax=8, tables fell back)" in out


@pytest.mark.parametrize("name", ["nested", "spiral", "borders_checker",
                                  "u_beside_o", "frame_edge", "empty"])
def test_sweep_and_runtable_ccl_of_geometry_masks(name):
    mask = torch.from_numpy(GEOMETRY[name][None].astype(np.uint8))
    want = connected_components(mask > 0, 8)
    for variant in cs.VARIANTS:
        if variant != "fixed2":
            assert torch.equal(cs.ccl_mask_reference(mask, variant), want), \
                variant


def test_ccl_and_fill_match_xla_ops_640x480():
    frames = scene.make_frames(2)
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))
    pre = sk.label_kernel_reference(x, CT, "pre")
    filled = fill_holes(pre > 0)
    np.testing.assert_array_equal(
        filled.numpy(), np.asarray(jccl.fill_holes(jnp.asarray(
            pre.numpy() > 0))))
    want = np.asarray(jccl.connected_components(jnp.asarray(filled.numpy()),
                                                connectivity=8))
    np.testing.assert_array_equal(
        connected_components(filled, 8).numpy(), want)
    for variant in ("cur", "runtable6"):
        np.testing.assert_array_equal(
            cs.ccl_variant_reference(x, CT, variant).numpy(), want)


def test_cpu_wrappers_run_plain_versions():
    x = torch.from_numpy(FRAMES[:2])
    filled = _filled()[:2]
    before = cs.ccl_mask.launches
    for variant in ("cur", "fixed2", "runtable8"):
        assert torch.equal(cs.ccl_variant(x, CT, variant),
                           cs.ccl_variant_reference(x, CT, variant))
        assert torch.equal(cs.ccl_mask(filled, variant),
                           cs.ccl_mask_reference(filled, variant))
    for a, b in zip(cs.ccl_runtable(filled, 6),
                    cs.runtable_reference(filled, 6)):
        assert torch.equal(a, b)
    assert cs.ccl_mask.launches == before


@pytest.mark.parametrize("case", ["bad_variant", "too_wide", "bad_rmax",
                                  "frames_for_mask"])
def test_wrappers_reject_other_forms(case):
    x = torch.from_numpy(FRAMES[:2])
    calls = {
        "bad_variant": lambda: cs.ccl_variant(x, CT, "runtable12"),
        "too_wide": lambda: cs.ccl_mask(torch.zeros((1, 8, 1100),
                                                    dtype=torch.uint8)),
        "bad_rmax": lambda: cs.ccl_runtable(_filled()[:1], 17),
        "frames_for_mask": lambda: cs.ccl_mask(x),
    }
    with pytest.raises(ValueError):
        calls[case]()
