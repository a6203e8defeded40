"""The multi-device path on the card (marked ``cuda``; each test skips
where torch.cuda.is_available() is false): the three shard entries
(flood_fill_sp, band_ccl_sp, banded_stats_sp) against their plain versions
on scene.tile_case_masks and label_case_masks cut into shards (the fill
also on the first, a middle and the last of 3 shards of 1, 14 and 270
rows, with and without halos, on a maze whose corridor crosses a cut row
twice, and past its cluster's width), the
spatially-sharded step over a 4-rank world on one card (gloo, collectives
staged through pinned host buffers) and a 1-rank NCCL world through the
data-parallel and line steps, each held equal to the single-card
detector; and the sharded train step in both worlds, every rank's
parameters bitwise equal and within the bf16 rule of
tests/test_torch_training_cuda.py of one ClassifierTrainer step on the
whole batch from the same parameters.  This file imports no JAX:

    python -m pytest tests/test_torch_parallel_cuda.py -q -m cuda --noconftest
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.ops import ccl_tiled as ct
from heimdall_tpu_torch.ops import stats_tiled as st
from heimdall_tpu_torch.ops.ccl import connected_components
from heimdall_tpu_torch.parallel.launch import launch

TESTS = str(Path(__file__).resolve().parent)
K = 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _cases(h, w):
    masks = list(scene.tile_case_masks(h, w).values())
    masks += list(scene.label_case_masks(h, w).values())
    return np.stack(masks)


def _shards(x, n):
    hl = x.shape[1] // n
    return [x[:, i * hl:(i + 1) * hl].contiguous() for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,n", [(270, 320, 3), (96, 160, 4), (64, 33, 2)])
def test_shard_entries_equal_plain_versions(card, h, w, n):
    rng = np.random.RandomState(h + w)
    masks = torch.from_numpy(_cases(h, w)).to(card)
    B = masks.shape[0]
    filled = ct.flood_reference(masks)
    labels = connected_components(filled, 8)
    rl, nb = ct._root_table(labels, K)
    gray = torch.from_numpy(rng.randint(0, 256, (B, h, w),
                                        dtype=np.uint8)).to(card)
    color = torch.from_numpy(rng.randint(0, 256, (B, h, w, 3),
                                         dtype=np.uint8)).to(card)
    hl = h // n
    parts = [_shards(t, n) for t in (masks, filled, labels, gray, color)]
    for i, (m, f, lab, g, c) in enumerate(zip(*parts)):
        halos = [torch.from_numpy(rng.rand(B, w) < 0.5).to(card)
                 .to(torch.uint8) if cut else None
                 for cut in (i > 0, i < n - 1)]
        assert torch.equal(ct.flood_fill_sp(m, i * hl, h, *halos),
                           ct.flood_sp_reference(m, i * hl, h, *halos))
        for band in {hl, 8} if hl % 8 == 0 else {hl}:
            got = ct.band_ccl_sp(f, band, i * hl * w, h * w)
            want = ct.band_ccl_sp_reference(f, band, i * hl * w, h * w)
            for a, b in zip(got, want + (ct.edge_rows(want[0], band),)):
                assert torch.equal(a, b)
        fm = f.to(torch.uint8)
        rows = [parts[1][i - 1][:, -1].to(torch.uint8) if i > 0 else None,
                parts[1][i + 1][:, 0].to(torch.uint8) if i < n - 1
                else None]
        args = (lab, fm, g, c, rl, nb)
        for a, b in zip(st.banded_stats_sp(*args, h * w, K, *rows),
                        st.banded_stats_sp_reference(*args, K, *rows)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hl", [1, 14, 270])
@pytest.mark.parametrize("w", [1920, 517])
def test_flood_fill_sp_on_its_cluster(card, hl, w):
    """B5b-sp on its cluster path against its plain version: the first,
    a middle and the last shard of frames of 3 hl rows, with random reached
    halos, with all-reached ones and with none on the cut rows; on the tile
    and label cases and a maze whose corridor crosses a cut row twice."""
    h = 3 * hl
    rng = np.random.RandomState(hl + w)
    masks = _cases(h, w)
    if hl > 1:
        masks = np.concatenate([masks, scene.cut_maze_mask(h, w, hl)[None],
                                scene.cut_maze_mask(h, w, 2 * hl)[None]])
    masks = torch.from_numpy(masks).to(card)
    B = masks.shape[0]
    for i, m in enumerate(_shards(masks, 3)):
        for halo in ("random", "all", None):
            halos = [(torch.from_numpy(rng.rand(B, w) < 0.5) if halo ==
                      "random" else torch.ones(B, w, dtype=torch.bool))
                     .to(torch.uint8).to(card)
                     if cut and halo else None for cut in (i > 0, i < 2)]
            got = ct.flood_fill_sp(m, i * hl, h, *halos)
            torch.cuda.synchronize()
            assert ct.flood_fill_sp.last_path == "cluster"
            assert torch.equal(got, ct.flood_sp_reference(m, i * hl, h,
                                                          *halos)), (i, halo)


@pytest.mark.cuda
def test_flood_fill_sp_past_a_cluster(card):
    """A shard wider than 4096 columns takes the tile union-find."""
    masks = torch.from_numpy(_cases(42, 4100)).to(card)
    m = _shards(masks, 3)[1]
    halos = [torch.ones(m.shape[0], 4100, dtype=torch.uint8, device=card),
             None]
    got = ct.flood_fill_sp(m, 14, 42, *halos)
    assert ct.flood_fill_sp.last_path == "tiles"
    assert torch.equal(got, ct.flood_sp_reference(m, 14, 42, *halos))


def _same(got, want):
    table, conf, accepted = got[:3]
    for f in want[0]._fields:
        np.testing.assert_array_equal(table[f], getattr(want[0], f).cpu()
                                      .numpy(), err_msg=f)
    np.testing.assert_array_equal(conf, want[1].cpu().numpy())
    np.testing.assert_array_equal(accepted, want[2].cpu().numpy())


def _frames(n, h, w):
    rng = np.random.RandomState(1)
    frames = np.full((n, h, w, 3), 215, np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for i in range(n):
        for _ in range(5):
            y, x = rng.randint(8, h - 8), rng.randint(8, w - 8)
            r, v = rng.randint(3, 14), rng.randint(0, 60)
            frames[i][(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = (v, v, v)
    return frames


@pytest.mark.cuda
def test_spatial_step_on_one_card_equals_detector(card):
    frames = _frames(4, 128, 192)
    ranks = launch("_torch_parallel_worker:card_world", 4,
                   args=(frames, K, 16), device="cuda", timeout=300,
                   sys_path=(TESTS,))
    det = ContaminationDetector(config={"max_blobs": K})
    want = det.run_device(frames)
    for r in ranks:
        assert r["device"].startswith("cuda")
        assert all(r["launches"])
        _same(r["out"], want)


@pytest.mark.cuda
def test_one_rank_nccl_world_equals_detector(card):
    frames = _frames(4, 128, 192)
    (res,) = launch("_torch_parallel_worker:nccl_world", 1,
                    args=(frames, K), device="cuda", timeout=300,
                    sys_path=(TESTS,))
    assert res["backend"] == "nccl"
    want = ContaminationDetector(config={"max_blobs": K}).run_device(frames)
    for key in ("pallas_dp", "tiled_dp", "line"):
        _same(res[key], want)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [4, 1])
def test_sharded_train_step_on_the_card(card, ranks):
    from heimdall_tpu_torch.models import defect_classifier
    import _torch_step_rule as rule
    from test_torch_training_cuda import LR, step

    rng = np.random.RandomState(3)
    patches = rng.randint(0, 256, (64, 32, 32, 1)).astype(np.uint8)
    labels = rng.randint(0, 2, 64)
    out = launch("_torch_parallel_worker:card_train_world", ranks,
                 args=(patches, labels), device="cuda", timeout=300,
                 sys_path=(TESTS,))
    assert {r["backend"] for r in out} == {"gloo" if ranks > 1 else "nccl"}
    for r in out:
        assert r["device"].startswith("cuda") and r["loss"] == out[0]["loss"]
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, out[0]["params"][k], err_msg=k)
    clf = defect_classifier.DefectClassifier(seed=0, device=card)
    ref = step(defect_classifier.ClassifierTrainer(clf).train_step(
        patches, labels), clf.model)
    got = {"loss": out[0]["loss"], "grads": None,
           "params": out[0]["params"]}
    rule.hold_step(f"sharded, {ranks} ranks", ref, got,
                   rule.bf16_tols(ref["grads"], "Dense_1"),
                   rule.BF16_LOSS_TOL, LR)
