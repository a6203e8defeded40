"""The preprocess and hole-fill probes' CUDA kernels (csrc/pre_variants.cu,
csrc/fill_sweeps.cu) and the repaired stats kernel against their plain
PyTorch versions, on the card (marked ``cuda``; each test skips where
torch.cuda.is_available() is false).  This file imports no JAX; on a
machine with a card:

    python -m pytest tests/test_torch_probes_cuda.py -q -m cuda --noconftest

Equality is exact for every integer plane: the roll stages, the four exact
preprocess variants (also equal to the label kernel's "pre"), the run ids,
all nine sweep fills (also equal to the label kernel's "fill"; and on the
masks of the cases that attack the fill's tiles, the union-finds' row
blocks and the bit words, equal to the plain sweep fill and to the tile
union-find fill, at 480x640, 477x631, 13x17, 3x3, the bit cases' sizes
and the largest planes the fill takes) and the stats tables.  mxu_conv's
mean is a tensor-core product of TF32 splits: within 1e-3 of the float32
product, its threshold flips counted.  The roll stages and the variants
also on scene.tile_case_frames at sizes where every tile is a border tile
(the wrap halo wrapping more than once at 6x6), each one launch of the
tile preprocess (mxu_conv two).
"""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import ccl_tiled
from heimdall_tpu_torch.ops import fill_sweeps as fs
from heimdall_tpu_torch.ops import pre_variants as pv
from heimdall_tpu_torch.ops import split_kernels as sk

CT = 15
MEAN_TOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
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


SIZES = [(480, 640), (477, 631), (64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ct", [CT, -CT])
def test_roll_stages_match_plain_version(card, size, ct):
    x = _frames(*size).to(card)
    for stage in pv.ROLL_STAGES:
        before = pv.roll_stage.stage_launches[stage]
        got = pv.roll_stage(x, ct, stage)
        torch.cuda.synchronize()
        assert pv.roll_stage.stage_launches[stage] == before + 1
        want = pv.roll_stage_reference(x, ct, stage)
        assert got.dtype == want.dtype and torch.equal(got, want), stage


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ct", [CT, -CT])
def test_exact_pre_variants_match_plain_version_and_pre(card, size, ct):
    x = _frames(*size).to(card)
    pre = sk.label_kernel(x, ct, "pre")
    for name in ("cur", "roll_conv", "pair_sym", "roll_pair"):
        before = pv.pre_variant.variant_launches[name]
        got = pv.pre_variant(x, ct, name)
        torch.cuda.synchronize()
        assert pv.pre_variant.variant_launches[name] == before + 1
        assert torch.equal(got, pv.pre_variant_reference(x, ct, name)), name
        assert torch.equal(got, pre), name


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
def test_mxu_conv_mean_within_tolerance(card, size):
    """mxu_conv's mean against the float32 product: within 1e-3; the
    threshold differs only where the mean lies within 1e-3 of a
    half-integer, and the pre plane only within the morphology's reach of
    such a pixel."""
    x = _frames(*size).to(card)
    blurred = sk.label_kernel(x, CT, "blur5")
    got = pv.mxu_mean(blurred)
    want = pv.mxu_mean_reference(blurred)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= MEAN_TOL
    near_half = ((want - want.floor() - 0.5).abs() <= MEAN_TOL)
    flips = torch.round(got) != torch.round(want)
    assert not bool((flips & ~near_half).any())
    differ = (pv.pre_variant(x, CT, "mxu_conv")
              != pv.pre_variant_reference(x, CT, "mxu_conv"))
    print(f"mxu_conv {size}: {int(flips.sum())} mean roundings and "
          f"{int(differ.sum())} pre pixels differ from the float32 product")
    assert not bool((differ & ~pv.flip_reach(want, MEAN_TOL)).any())


# Frames below one tile and its 11-pixel halo (every tile a border tile; the
# wrap halo wraps more than once at 6x6), odd sizes, and a frame of
# interior and border tiles with partial tiles at its right and bottom.
PROBE_CASE_SIZES = [(6, 6), (7, 13), (13, 17), (70, 131), (200, 397)]


def _case_frames(h, w):
    frames = np.stack(list(scene.tile_case_frames(h, w, seed=2).values()))
    return torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("size", PROBE_CASE_SIZES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("ct", [CT, -CT])
def test_probes_on_border_tile_cases(card, size, ct):
    x = _case_frames(*size).to(card)
    for stage in pv.ROLL_STAGES:
        got = pv.roll_stage(x, ct, stage)
        torch.cuda.synchronize()
        assert torch.equal(got, pv.roll_stage_reference(x, ct, stage)), stage
    pre = sk.label_kernel(x, ct, "pre")
    for name in ("cur", "roll_conv", "pair_sym", "roll_pair"):
        got = pv.pre_variant(x, ct, name)
        torch.cuda.synchronize()
        assert torch.equal(got, pv.pre_variant_reference(x, ct, name)), name
        assert torch.equal(got, pre), name
    want = pv.mxu_mean_reference(sk.label_kernel(x, ct, "blur5"))
    differ = (pv.pre_variant(x, ct, "mxu_conv")
              != pv.pre_variant_reference(x, ct, "mxu_conv"))
    assert not bool((differ & ~pv.flip_reach(want, MEAN_TOL)).any())


@pytest.mark.cuda
def test_probe_launches_per_call(card):
    """One CUDA kernel a roll stage or variant call, two for mxu_conv, as
    launches_per_call says (a torch.profiler trace of each call, opened
    with ProfilingSession.trace's lead of fill kernels, which the profiler
    may drop)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from heimdall_tpu_torch.perf import profiling
    x = _frames(64, 128).to(card)
    calls = {s: (lambda s=s: pv.roll_stage(x, CT, s)) for s in pv.ROLL_STAGES}
    calls.update({v: (lambda v=v: pv.pre_variant(x, CT, v))
                  for v in pv.VARIANTS})
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiling.lead(card)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and ("k_pre_variant" in e.name or "k_band_table" in e.name)]
        assert len(names) == pv.launches_per_call(name), (name, names)
        assert any("k_pre_variant" in n for n in names), (name, names)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 480, 640), (2, 37, 53), (1, 6, 1024),
                                   (2, 129, 7)])
def test_mxu_mean_product_on_random_planes(card, shape):
    rng = np.random.RandomState(sum(shape))
    blurred = torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))
    before = pv.mxu_mean.launches
    got = pv.mxu_mean(blurred.to(card))
    torch.cuda.synchronize()
    assert pv.mxu_mean.launches == before + 1
    want = pv.mxu_mean_reference(blurred.to(card))
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= MEAN_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 480, 640), (2, 61, 77), (1, 3, 1024),
                                   (2, 1008, 9)])
@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("pack", ["mxu", "ladder"])
def test_run_ids_product_on_random_planes(card, shape, guard, pack):
    rng = np.random.RandomState(sum(shape))
    mask = torch.from_numpy((rng.rand(*shape) < 0.5).astype(np.uint8))
    mask[0, : shape[1] // 2] = 0            # long background runs too
    got = fs.run_ids(mask.to(card), guard, pack)
    torch.cuda.synchronize()
    for a, b in zip(got, fs.run_ids_reference(mask, guard)):
        assert a.dtype == torch.int16 and torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ct", [CT, -CT])
def test_fill_sweeps_match_union_find_fill(card, size, ct):
    x = _frames(*size).to(card)
    want = sk.label_kernel(x, ct, "fill")
    assert torch.equal(want, fs.fill_sweeps_reference(x, ct))
    for variant in fs.VARIANTS:
        before = fs.fill_sweeps.variant_launches[variant]
        got = fs.fill_sweeps(x, ct, variant)
        torch.cuda.synchronize()
        assert fs.fill_sweeps.variant_launches[variant] == before + 1
        assert torch.equal(got, want), variant


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 4])
def test_stats_kernel_on_non_root_labels(card, k):
    x = _frames(480, 640).to(card)
    labels = scene.non_root_labels(sk.label_kernel(x, CT))
    got = sk.stats_kernel(x, labels, k)
    torch.cuda.synchronize()
    for a, b in zip(got, sk.stats_kernel_reference(x, labels, k)):
        assert torch.equal(a, b)


# (kind, h, w) of the fill's mask cases; 1008x640 and 636x1024 are the
# largest planes of their widths that the fill takes
FILL_CASES = [("tile", 480, 640), ("tile", 477, 631), ("tile", 13, 17),
              ("tile", 3, 3), ("fix", 301, 517), ("fix", 7, 517),
              *(("bit", h, w) for h, w in scene.BIT_CASE_SIZES),
              ("bit", 480, 640), ("bit", 1008, 640), ("bit", 636, 1024)]


def _case_masks(kind, h, w):
    masks = {"tile": scene.tile_case_masks, "fix": scene.fix_case_masks,
             "bit": scene.bit_case_masks}[kind](h, w)
    return torch.from_numpy(np.stack(list(masks.values())).astype(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FILL_CASES, ids=lambda c: "%s_%dx%d" % c)
def test_fill_mask_variants_on_case_masks(card, case):
    mask = _case_masks(*case).to(card)
    want = fs.sweep_fill_reference(mask)
    assert torch.equal(want, ccl_tiled.flood_fill(mask))
    for variant in fs.VARIANTS:
        before = fs.fill_mask.variant_launches[variant]
        got = fs.fill_mask(mask, variant)
        torch.cuda.synchronize()
        assert fs.fill_mask.variant_launches[variant] == before + 1
        assert fs.fill_mask.instance == fs.INSTANCES[variant]
        assert torch.equal(got, want), variant
