"""The port's joint probe (ops/joint_label.py) against heimdall_tpu's.

scripts/profile_joint_variants.py builds its kernels inside main(), so this
file rebuilds them from heimdall_tpu's own helpers and runs them in
interpret mode: the script's preprocess_body once on
tests/test_torch_split.py's 16 frames of 64x128 (bench cases, adversarial
masks, and the check_joint_label geometry: nested islands in holes, a
spiral, border-touching blobs, a U beside an O, a dark frame edge, an empty
frame), then make_labels' labeling on those masks and on a full mask (the
uniform frame at contrast -15):

* "joint": pallas_kernels._label_flood_joint with each of the script's four
  (ss_row, ss_col); its labels and filled mask equal the plain
  joint_mask_reference exactly, and so do "classic"'s
  (_fill_holes_sweeps, then _ccl_sweeps);
* both equal the label kernel's "fill" and "ccl" stages;
* on the geometry and adversarial masks themselves, the plain joint
  fixpoint equals fill_holes + connected_components (which
  tests/test_torch_ops.py holds against JAX's XLA ops);
* the full detect with the joint labels (joint_detect) gives the fused
  detect's table and gates.

The CUDA kernel is held against this plain version on the card by
tests/test_torch_ccl_cuda.py and chip_smoke.py.  JAX outputs are computed
once per file (cached).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heimdall_tpu.ops import pallas_kernels as pk

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import ccl_sweeps as cs
from heimdall_tpu_torch.ops import fill_sweeps as fs
from heimdall_tpu_torch.ops import joint_label as jl
from heimdall_tpu_torch.ops import split_kernels as sk
from heimdall_tpu_torch.ops.ccl import connected_components, fill_holes
from heimdall_tpu_torch.ops.fused_kernels import fused_detect

from test_torch_ccl_variants import _pallas_masks
from test_torch_split import CT, FRAMES, GEOMETRY, H, NAMES, W, _pallas, \
    _s2_planes

# profile_joint_variants.py:134-139, by the port's names
JAX_VARIANTS = {
    "rowFull_col5": dict(ss_row=None, ss_col=5),
    "rowFull_col4": dict(ss_row=None, ss_col=4),
    "rowFull_col6": dict(ss_row=None, ss_col=6),
    "row7_col5": dict(ss_row=7, ss_col=5),
}
MASK_NAMES = NAMES + ["full"]


@functools.lru_cache(maxsize=None)
def _jax_masks():
    """preprocess_body's mask of FRAMES, then a full mask: int32 [17, H, W]."""
    def kernel(ct_ref, frame_ref, out_ref):
        out_ref[0] = (_s2_planes(ct_ref, frame_ref, "full") > 0).astype(
            jnp.int32)

    pre = _pallas(kernel, 1, [(H, W)])(jnp.asarray(CT, jnp.int32).reshape(1),
                                       jnp.asarray(FRAMES))[0]
    return np.concatenate([np.asarray(pre), np.ones((1, H, W), np.int32)])


@functools.lru_cache(maxsize=None)
def _jax_labels(mode):
    """make_labels(mode)'s labeling on _jax_masks: (labels, filled u8)."""
    def kernel(fg_ref, lab_ref, fill_ref):
        fg0 = fg_ref[0]
        row = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        border = ((row == 0) | (row == H - 1) | (col == 0)
                  | (col == W - 1)).astype(jnp.int32)
        if mode == "classic":
            fg = pk._fill_holes_sweeps(fg0, border, 2, adaptive=True)
            lab = pk._ccl_sweeps(jnp.where(fg > 0, row * W + col, H * W), fg,
                                 H * W, 2, adaptive=True, scan_steps=5)
        else:
            lab, fg = pk._label_flood_joint(fg0, border, H * W,
                                            **JAX_VARIANTS[mode])
        lab_ref[0] = lab
        fill_ref[0] = fg

    lab, fg = _pallas_masks(kernel, _jax_masks(), 2)
    return lab, fg.astype(np.uint8)


def _masks():
    return torch.from_numpy(_jax_masks().astype(np.uint8))



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
    for i, name in enumerate(MASK_NAMES):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)


def test_variants_table_matches_profiler():
    assert {n: dict(ss_row=r, ss_col=c)
            for n, (r, c) in jl.VARIANTS.items()} == JAX_VARIANTS


def test_preprocess_masks_are_pre_stage():
    """preprocess_body's masks are the label kernel's "pre" stage; at
    contrast -15 the uniform frame's is the full mask."""
    x = torch.from_numpy(FRAMES)
    np.testing.assert_array_equal(
        sk.label_kernel_reference(x, CT, "pre").numpy(), _jax_masks()[:-1])
    assert sk.label_kernel_reference(x, -CT, "pre")[NAMES.index(
        "empty")].all()


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_plain_joint_matches_profiler_variant(variant):
    got = jl.joint_mask_reference(_masks(), variant)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.uint8
    for want, g in zip(_jax_labels(variant), got):
        _assert_frames_equal(want, g.numpy())
    assert (got[0][-1] == 0).all() and got[1][-1].all()      # full mask


def test_classic_and_joint_equal_label_kernel_stages():
    x = torch.from_numpy(FRAMES)
    want = (sk.label_kernel_reference(x, CT).numpy(),
            sk.label_kernel_reference(x, CT, "fill").numpy())
    for mode in ("classic", *JAX_VARIANTS):
        for w, g in zip(want, _jax_labels(mode)):
            for i, name in enumerate(NAMES):
                np.testing.assert_array_equal(g[i], w[i], err_msg=name)
    filled = fs.fill_sweeps_reference(x, CT)
    assert np.array_equal(cs.ccl_mask_reference(filled, "cur").numpy(),
                          want[0])
    assert np.array_equal(filled.numpy(), want[1])
    for a, b in zip(jl.joint_label_reference(x, CT), want):
        assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_joint_of_geometry_and_adversarial_masks(variant):
    """The masks themselves (not through the preprocess): nested islands
    merge with their enclosing ring, the spiral's corridor stays exterior;
    the fixpoint is fill_holes + connected_components."""
    masks = np.stack(list(GEOMETRY.values())
                     + list(scene.adversarial_masks(H, W, seed=3).values()))
    m = torch.from_numpy(masks.astype(np.uint8))
    labels, filled = jl.joint_mask_reference(m, variant)
    want_fill = fill_holes(m > 0)
    assert torch.equal(filled, want_fill.to(torch.uint8))
    assert torch.equal(labels, connected_components(want_fill, 8))


def test_joint_detect_equals_fused_detect():
    x = torch.from_numpy(FRAMES)
    want = fused_detect(x, CT, 10.0, 3000.0, 0.25, 64, channel_major=True)
    got = jl.joint_detect(x, CT, 10.0, 3000.0, 0.25, 64)
    assert int(want[2].sum()) > 0
    assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
    for f in want[0]._fields:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f


def test_classic_label_on_the_cpu():
    x = torch.from_numpy(FRAMES[:4])
    got = jl.classic_label(x, CT)
    assert torch.equal(got[0], sk.label_kernel_reference(x, CT))
    assert torch.equal(got[1], sk.label_kernel_reference(x, CT, "fill"))


def test_cpu_wrappers_run_plain_versions():
    x = torch.from_numpy(FRAMES[:2])
    before = jl.joint_mask.launches
    for variant in jl.VARIANTS:
        for a, b in zip(jl.joint_label(x, CT, variant),
                        jl.joint_label_reference(x, CT, variant)):
            assert torch.equal(a, b)
    assert jl.joint_mask.launches == before


@pytest.mark.parametrize("case", ["bad_variant", "too_large", "frames"])
def test_wrappers_reject_other_forms(case):
    x = torch.from_numpy(FRAMES[:2])
    calls = {
        "bad_variant": lambda: jl.joint_label(x, CT, "row6_col5"),
        "too_large": lambda: jl.joint_mask(torch.zeros((1, 1000, 600),
                                                       dtype=torch.uint8)),
        "frames": lambda: jl.joint_mask(x),
    }
    with pytest.raises(ValueError):
        calls[case]()
