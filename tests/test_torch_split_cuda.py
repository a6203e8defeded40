"""The split CUDA kernels (hd_label at every stage, hd_stats_from_labels)
against their plain PyTorch versions, on the card (marked ``cuda``; each
test skips where torch.cuda.is_available() is false).  This file imports no
JAX; on a machine with a card:

    python -m pytest tests/test_torch_split_cuda.py -q -m cuda --noconftest

Equality is exact: every stage is an integer plane and the stats are
integer tables.  The stats kernel on the label kernel's labels must also
equal the fused kernel's outputs.  Besides the bench, adversarial and
uniform frames, every stage runs on the cases that attack the kernels it
is made of (heimdall_tpu_torch/scene.py): the preprocess's tiles
(tile_case_frames), the labels' tiles (label_case_masks drawn as frames),
the union-finds' row blocks (fix_case_masks drawn) and the bit cases
(bit_case_frames), at contrast 15 and -15.  The stats kernel also runs on
label planes that attack its two passes over the labels
(scene.stats_case_labels at scene.STATS_CASE_SIZES, K 1, 64 and 1024: the
K-th root mid-row, roots past K, every pixel a root, labels naming
non-roots and roots ranked K or later, a root in the last row, empty and
full planes), into memory that held other values.
"""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import split_kernels as sk
from heimdall_tpu_torch.ops.fused_kernels import contamination_fused

CT = 15
# (kind, h, w) of the case frames
CASES = [("tile", 480, 640), ("tile", 477, 631), ("tile", 13, 17),
         ("tile", 3, 3), ("label", 480, 640), ("label", 13, 17),
         ("fix", 301, 517), *(("bit", h, w) for h, w in scene.BIT_CASE_SIZES)]


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


def _case_frames(kind, h, w):
    """The frames of one case set as BGR planes [n, 3, h, w]."""
    if kind == "tile":
        frames = np.stack(list(scene.tile_case_frames(h, w).values()))
    elif kind == "bit":
        frames = scene.bit_case_frames(h, w)
    else:
        masks = (scene.label_case_masks if kind == "label"
                 else scene.fix_case_masks)(h, w)
        frames = scene.mask_frames(list(masks.values()))
    return torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(480, 640), (237, 301)])
@pytest.mark.parametrize("stage", sk.STAGES)
def test_label_kernel_matches_plain_version(card, size, stage):
    x = _frames(*size).to(card)
    before = sk.label_kernel.stage_launches[stage]
    got = sk.label_kernel(x, CT, stage)
    torch.cuda.synchronize()
    assert sk.label_kernel.stage_launches[stage] == before + 1
    want = sk.label_kernel_reference(x, CT, stage)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 4])
def test_stats_kernel_matches_plain_version_and_fused(card, k):
    x = _frames(480, 640).to(card)
    labels = sk.label_kernel(x, CT)
    before = sk.stats_kernel.launches
    got = sk.stats_kernel(x, labels, k)
    torch.cuda.synchronize()
    assert sk.stats_kernel.launches == before + 1
    for a, b, c in zip(got, sk.stats_kernel_reference(x, labels, k),
                       contamination_fused(x, CT, k, channel_major=True)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_full_foreground(card):
    """A uniform frame at contrast -15 is all foreground: one blob."""
    x = torch.full((2, 3, 64, 96), 77, dtype=torch.uint8, device=card)
    labels = sk.label_kernel(x, -CT)
    assert not labels.any()
    got = sk.stats_kernel(x, labels)
    for a, b in zip(got, sk.stats_kernel_reference(x, labels)):
        assert torch.equal(a, b)
    assert got[3].tolist() == [1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "%s_%dx%d" % c)
@pytest.mark.parametrize("ct", [CT, -CT])
def test_label_kernel_on_case_frames(card, case, ct):
    """Every stage equals its plain version, and B6a(B6b) the fused
    kernel, on the frames that attack the preprocess's tiles, the fill's
    and the labels' tiles, the union-finds' blocks and the bit words."""
    x = _case_frames(*case).to(card)
    for stage in sk.STAGES:
        got = sk.label_kernel(x, ct, stage)
        torch.cuda.synchronize()
        want = sk.label_kernel_reference(x, ct, stage)
        assert got.dtype == want.dtype and torch.equal(got, want), stage
    labels = sk.label_kernel(x, ct)
    for a, b in zip(sk.stats_kernel(x, labels, 64),
                    contamination_fused(x, ct, 64, channel_major=True)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("size", scene.STATS_CASE_SIZES,
                         ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("k", [1, 64, 1024])
def test_stats_kernel_on_stats_cases(card, size, k):
    labels = torch.from_numpy(np.stack(list(
        scene.stats_case_labels(*size, k, seed=1).values()))).to(card)
    x = torch.from_numpy(scene.stats_case_frames(len(labels), *size,
                                                 seed=2)).to(card)
    junk = torch.full((1 << 22,), -7, dtype=torch.int32, device=card)
    del junk                    # the outputs' memory held other values
    got = sk.stats_kernel(x, labels, k)
    torch.cuda.synchronize()
    want = sk.stats_kernel_reference(x, labels, k)
    for name, a, b in zip(("sums", "bbox", "bgsum", "n"), got, want):
        assert torch.equal(a, b), name
    # more roots than K, or every pixel a root
    assert int(want[3].max()) > min(k, size[0] * size[1] - 1)
