"""The labeling probes' CUDA kernels (csrc/ccl_sweeps.cu: the sweep CCL and
the run-table CCL with its per-frame fallback; csrc/joint_label.cu: the
joint fixpoint) against their plain PyTorch versions, on the card (marked
``cuda``; each test skips where torch.cuda.is_available() is false).  This
file imports no JAX; on a machine with a card:

    python -m pytest tests/test_torch_ccl_cuda.py -q -m cuda --noconftest

Equality is exact: every output is a label plane, a 0/1 plane or a flag.
The sweep kernels run on the cluster path or the global path by shape
(ops/ccl_sweeps.py::choose_path); the tests below the first ones hold both
paths on shapes on each side of the cut, at the wrappers' limits and at the
run-table check's 96 x 128.
The frames are bench frames, adversarial frames (dense noise, a spiral,
nested rings with a blob in the innermost hole, blobs cut by the edges) and
a uniform frame; the masks are the run-table check's (a row of 20 runs
overflows every R) and the adversarial masks, whose noise overflows R = 6:
a batch of them takes the tables on some frames and falls back on others.
The plain versions run on the card too.
"""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import ccl_sweeps as cs
from heimdall_tpu_torch.ops import joint_label as jl
from heimdall_tpu_torch.ops import split_kernels as sk
from heimdall_tpu_torch.ops.ccl import connected_components, fill_holes
from heimdall_tpu_torch.scripts import check_runtable

CT = 15


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _frames(h, w):
    """Bench frames, adversarial frames and a uniform frame, as BGR planes
    [7, 3, h, w]."""
    frames = np.concatenate([
        scene.make_frames(2, h, w, seed=4),
        scene.mask_frames(list(scene.adversarial_masks(h, w, seed=1)
                               .values())),
        np.full((1, h, w, 3), 128, np.uint8)])
    return torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))


def _masks(h=96, w=128):
    """The run-table check's masks, then the adversarial masks, u8
    [11, h, w]."""
    return torch.from_numpy(np.stack(
        list(scene.check_runtable_masks(h, w).values())
        + [m.astype(np.uint8)
           for m in scene.adversarial_masks(h, w, seed=2).values()]))


SIZES = [(480, 640), (477, 631), (64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ct", [CT, -CT])
def test_ccl_variants_match_plain_version_and_union_find(card, size, ct):
    x = _frames(*size).to(card)
    labels = sk.label_kernel(x, ct)
    filled = sk.label_kernel(x, ct, "fill")
    for variant in cs.VARIANTS:
        before = cs.ccl_mask.variant_launches[variant]
        got = cs.ccl_variant(x, ct, variant)
        torch.cuda.synchronize()
        assert cs.ccl_mask.variant_launches[variant] == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, cs.ccl_mask_reference(filled, variant)), \
            variant
        if variant != "fixed2":
            assert torch.equal(got, labels), variant


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(96, 128), (480, 640)])
@pytest.mark.parametrize("rmax", [12, 10, 8, 6])
def test_runtable_fits_and_fallback(card, size, rmax):
    masks = _masks(*size).to(card)
    got, fits = cs.ccl_runtable(masks, rmax)
    torch.cuda.synchronize()
    want, want_fits = cs.runtable_reference(masks, rmax)
    assert torch.equal(fits, want_fits)
    assert torch.equal(got, want)
    assert torch.equal(want, connected_components(masks > 0, 8))
    want_fits = want_fits.cpu()
    # the overflow mask and the noise never fit; the empty mask always does
    names = list(scene.check_runtable_masks(*size)) + ["noise", "spiral",
                                                       "rings", "edges"]
    assert want_fits[names.index("overflow->fallback")] == 0
    assert want_fits[names.index("noise")] == 0
    assert want_fits[names.index("empty")] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(cs.SWEEP_VARIANTS))
def test_sweep_ccl_on_masks(card, variant):
    masks = _masks(480, 640).to(card)
    got = cs.ccl_mask(masks, variant)
    torch.cuda.synchronize()
    want = cs.sweep_ccl_reference(masks, variant)
    assert torch.equal(got, want)
    if variant != "fixed2":
        assert torch.equal(want, connected_components(masks > 0, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ct", [CT, -CT])
def test_joint_variants_match_plain_version_and_union_find(card, size, ct):
    x = _frames(*size).to(card)
    want = (sk.label_kernel(x, ct), sk.label_kernel(x, ct, "fill"))
    for variant in jl.VARIANTS:
        before = jl.joint_mask.variant_launches[variant]
        got = jl.joint_label(x, ct, variant)
        torch.cuda.synchronize()
        assert jl.joint_mask.variant_launches[variant] == before + 1
        plain = jl.joint_label_reference(x, ct, variant)
        for a, b, c in zip(got, plain, want):
            assert a.dtype == b.dtype == c.dtype
            assert torch.equal(a, b) and torch.equal(a, c), variant


@pytest.mark.cuda
def test_joint_on_masks(card):
    """Nested islands (the rings' innermost blob), spirals and the run-table
    check's masks: labels and filled mask of the fill-then-label order."""
    masks = _masks(480, 640).to(card)
    filled = fill_holes(masks > 0)
    labels = connected_components(filled, 8)
    for variant in jl.VARIANTS:
        got = jl.joint_mask(masks, variant)
        torch.cuda.synchronize()
        assert torch.equal(got[1], filled.to(torch.uint8))
        assert torch.equal(got[0], labels)
        for a, b in zip(got, jl.joint_mask_reference(masks, variant)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_classic_label_and_joint_detect(card):
    x = _frames(480, 640).to(card)
    for a, b in zip(jl.classic_label(x, CT),
                    (sk.label_kernel(x, CT), sk.label_kernel(x, CT, "fill"))):
        assert torch.equal(a, b)
    from heimdall_tpu_torch.ops.fused_kernels import fused_detect
    want = fused_detect(x, CT, 10.0, 3000.0, 0.25, 64, channel_major=True)
    got = jl.joint_detect(x, CT, 10.0, 3000.0, 0.25, 64)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    for f in want[0]._fields:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f


@pytest.mark.cuda
def test_check_runtable_script(card):
    assert check_runtable.main([]) == 0


# Each side of the cluster path's cut (16 blocks hold the sweep CCL's planes
# up to 608 rows of 640, the joint fixpoint's with its mask rows up to 544),
# the wrappers' limits (the sweep CCL's 1008 x 1024; the joint fixpoint's
# frames have fewer than 2^19 px) and the run-table check's masks.
SWEEP_CUT = [(96, 128), (608, 640), (609, 640), (1008, 1024)]
JOINT_CUT = [(96, 128), (544, 640), (545, 640), (724, 724)]


def _paths(h, w, joint=False):
    """The path the shape picks, then the other one where it runs."""
    own = cs.choose_path(h, w, mask=joint)[0]
    return [own] + (["global"] if own == "cluster" else [])


@pytest.mark.cuda
@pytest.mark.parametrize("size", SWEEP_CUT)
@pytest.mark.parametrize("variant", list(cs.SWEEP_VARIANTS))
def test_sweep_ccl_on_both_paths_at_the_cut(card, size, variant):
    masks = _masks(*size).to(card)
    want = cs.sweep_ccl_reference(masks, variant)
    for path in _paths(*size):
        got = cs.ccl_mask(masks, variant, path=path)
        torch.cuda.synchronize()
        assert cs.ccl_mask.last_path == path
        assert torch.equal(got, want), (variant, path)


@pytest.mark.cuda
@pytest.mark.parametrize("size", JOINT_CUT)
@pytest.mark.parametrize("variant", list(jl.VARIANTS))
def test_joint_on_both_paths_at_the_cut(card, size, variant):
    masks = _masks(*size).to(card)
    want = jl.joint_mask_reference(masks, variant)
    for path in _paths(*size, joint=True):
        got = jl.joint_mask(masks, variant, path=path)
        torch.cuda.synchronize()
        assert jl.joint_mask.last_path == path
        for a, b in zip(got, want):
            assert torch.equal(a, b), (variant, path)


@pytest.mark.cuda
def test_paths_at_the_cut_are_the_shapes(card):
    for h, w in SWEEP_CUT:
        cs.ccl_mask(_masks(h, w).to(card))
        assert cs.ccl_mask.last_path == ("cluster" if h <= 608 and w <= 640
                                         else "global"), (h, w)
    for h, w in JOINT_CUT:
        jl.joint_mask(_masks(h, w).to(card))
        assert jl.joint_mask.last_path == ("cluster" if h <= 544 and w <= 640
                                           else "global"), (h, w)
    with pytest.raises(ValueError):
        cs.ccl_mask(_masks(609, 640).to(card), path="cluster")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["cluster", "global"])
@pytest.mark.parametrize("variant", ["cur", "cheapcert", "fixed2"])
def test_done_frames_are_left_untouched(card, path, variant):
    masks = _masks(480, 640).to(card)
    B = masks.shape[0]
    done = torch.tensor([i % 3 == 1 for i in range(B)], dtype=torch.int32,
                        device=card)
    out = torch.full(masks.shape, -7, dtype=torch.int32, device=card)
    got = cs.ccl_mask(masks, variant, path=path, done=done, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    skip = done.bool()
    assert bool((out[skip] == -7).all())
    assert torch.equal(out[~skip],
                       cs.sweep_ccl_reference(masks[~skip], variant))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["cluster", "global"])
@pytest.mark.parametrize("base", ["cur", "asym_r10", "unit2", "noguard"])
def test_fixed_units_match_plain_unit_for_unit(card, path, base):
    """Labels after 1, 2, 3 and 4 units (no certificate) equal the plain
    version's after as many: the kernels' phases read one plane and write
    the other, so a unit lowers labels exactly as far as the plain one."""
    x = _frames(480, 640).to(card)
    masks = torch.cat([sk.label_kernel(x, CT, "fill"),
                       _masks(480, 640).to(card)])
    for n in (1, 2, 3, 4):
        cfg = cs.SWEEP_VARIANTS[base]._replace(fixed=n)
        got = cs.ccl_mask(masks, cfg, path=path)
        torch.cuda.synchronize()
        assert torch.equal(got, cs.sweep_ccl_reference(masks, cfg)), n


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["cluster", "global"])
def test_runtable_fallback_on_both_paths(card, path):
    masks = _masks(480, 640).to(card)
    got, fits = cs.ccl_runtable(masks, 6, path=path)
    torch.cuda.synchronize()
    assert cs.ccl_mask.last_path == path
    want, want_fits = cs.runtable_reference(masks, 6)
    assert torch.equal(fits, want_fits) and torch.equal(got, want)
    assert 0 < int(fits.sum()) < masks.shape[0]


# The run tables' cases (scene.run_case_masks: rows of exactly 6 to 13 runs,
# runs that start, end and cross the 16-column lanes and the 512-column
# steps, one-pixel runs, full rows) at the bench width, an odd width (the
# byte-load path), two steps of a row, and narrow frames.
RUN_CASE_SIZES = [(24, 640), (24, 531), (40, 1024), (9, 17), (33, 48)]



@pytest.mark.cuda
@pytest.mark.parametrize("size", RUN_CASE_SIZES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("rmax", [12, 10, 8, 6])
@pytest.mark.parametrize("path", ["cluster", "global"])
def test_runtable_on_run_cases(card, size, rmax, path):
    """A batch mixing frames that fit with frames that overflow: labels and
    fits equal the plain version's, and the run-id product numbers only
    the frames that do not fit."""
    masks = torch.from_numpy(np.stack(list(
        scene.run_case_masks(*size).values())).astype(np.uint8))
    want, want_fits = cs.runtable_reference(masks, rmax)
    assert int(want_fits.sum()) > 0
    if size[1] > 2 * rmax:          # every other column a run: overflows
        assert int(want_fits.sum()) < masks.shape[0]
    if path == "cluster" and cs.band_layout(*size) is None:
        path = "global"
    got, fits = cs.ccl_runtable(masks.to(card), rmax, path=path)
    ran = int(cs.ccl_runtable.runid_frames)
    assert torch.equal(fits.cpu(), want_fits)
    assert torch.equal(got.cpu(), want)
    assert ran == masks.shape[0] - int(want_fits.sum())


@pytest.mark.cuda
def test_runtable_numbers_no_run_ids_when_every_frame_fits(card):
    masks = _masks(96, 128)
    keep = cs.runtable_reference(masks, 12)[1].bool()
    masks = masks[keep].to(card)
    got, fits = cs.ccl_runtable(masks, 12)
    assert int(fits.sum()) == masks.shape[0]
    assert int(cs.ccl_runtable.runid_frames) == 0
    assert torch.equal(got.cpu(), cs.runtable_reference(masks.cpu(), 12)[0])


@pytest.mark.cuda
def test_active_clusters_at_640x480(card):
    for joint in (False, True):
        n = cs.active_clusters(480, 640, joint)
        print(f"{'joint' if joint else 'sweep'}: "
              f"{cs.band_layout(480, 640, joint)} (blocks, pass) -> {n} "
              f"clusters at once")
        assert n >= 1
