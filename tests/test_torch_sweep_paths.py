"""The host's choice of path for the sweep kernels (ops/ccl_sweeps.py::
choose_path; csrc/sweep_cluster.cuh): the cluster path wherever a block's
band of the label planes (and for the joint fixpoint its mask rows) fits
one block's 232,448 bytes of shared memory, the global path elsewhere, held
against the byte arithmetic at the cut and at the wrappers' limits; and the
wrappers' CPU side of it: ``last_path``, a named path that cannot run,
``done`` / ``out``, a Sweep as the variant.  No JAX, no card."""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch.ops import ccl_sweeps as cs
from heimdall_tpu_torch.ops import joint_label as jl

SMEM = 232448


def bytes_of(H, W, C, P, mask):
    """A block's shared memory, written out: ceil(H / C) rows + 2 halo rows
    of two int32 planes, an H x (P + 1) int32 tile, 2 x 16 int32
    certificate flags and 32 column flags, an int16 a row of the row map
    (rounded up to an int32), and with the mask its rows + 2 halo rows of
    bytes."""
    rows = -(-H // C)
    planes = 2 * (rows + 2) * W * 4
    return (planes + H * (P + 1) * 4 + 64 * 4 + 4 * ((H + 1) // 2)
            + (rows + 2) * W * mask)


@pytest.mark.parametrize("H, W, mask, layout", [
    (480, 640, False, (16, 32)),      # the bench frames: 228,416 bytes
    (480, 640, True, (16, 16)),       # with the mask rows: 218,176
    (608, 640, False, (16, 8)),       # the sweep CCL's last row of 640
    (609, 640, False, None),
    (544, 640, True, (16, 8)),        # the joint fixpoint's
    (545, 640, True, None),
    (96, 128, False, (1, 32)),        # the run-table check's masks
    (1008, 1024, False, None),        # the sweep CCL's largest frame
    (724, 724, True, None),           # the joint's: fewer than 2^19 px
    (1, 1024, False, (1, 32)),
    (1008, 1, False, (1, 32)),
    (3, 3, True, (1, 32)),
])
def test_layout_against_the_byte_arithmetic(H, W, mask, layout):
    assert cs.band_layout(H, W, mask) == layout
    for C, P in ((c, p) for c in cs.CLUSTER_SIZES for p in cs.PASS_COLS):
        assert cs.band_bytes(H, W, C, P, mask) == bytes_of(H, W, C, P, mask)
    if layout is None:
        assert bytes_of(H, W, 16, 8, mask) > SMEM
        assert cs.choose_path(H, W, mask) == ("global", None)
    else:
        C, P = layout
        assert bytes_of(H, W, C, P, mask) <= SMEM
        # fewer blocks, or a wider pass at as many, would not fit
        assert all(bytes_of(H, W, c, 8, mask) > SMEM
                   for c in cs.CLUSTER_SIZES if c < C)
        assert all(bytes_of(H, W, C, p, mask) > SMEM
                   for p in cs.PASS_COLS if p > P)
        assert cs.choose_path(H, W, mask) == ("cluster", layout)
        assert cs.choose_path(H, W, mask, "global") == ("global", None)


def test_cut_is_one_row():
    assert bytes_of(608, 640, 16, 8, False) <= SMEM < bytes_of(
        609, 640, 16, 8, False)
    assert bytes_of(544, 640, 16, 8, True) <= SMEM < bytes_of(
        545, 640, 16, 8, True)


def test_named_path_that_cannot_run_raises():
    with pytest.raises(ValueError, match="cannot hold 609x640"):
        cs.choose_path(609, 640, path="cluster")
    with pytest.raises(ValueError, match="path must be"):
        cs.choose_path(480, 640, path="shared")
    mask = torch.zeros((1, 609, 640), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cs.ccl_mask(mask, path="cluster")
    with pytest.raises(ValueError):
        jl.joint_mask(torch.zeros((1, 545, 640), dtype=torch.uint8),
                      path="cluster")


def _masks(B=4, H=24, W=40, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.rand(B, H, W) < 0.45).astype(np.uint8))


def test_cpu_calls_name_the_plain_path():
    m = _masks()
    cs.ccl_mask(m)
    assert cs.ccl_mask.last_path == "plain"
    cs.ccl_runtable(m, 8)
    assert cs.ccl_mask.last_path == "plain"
    jl.joint_mask(m)
    assert jl.joint_mask.last_path == "plain"


def test_done_frames_keep_their_out_on_the_cpu():
    m = _masks()
    done = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    out = torch.full(m.shape, -7, dtype=torch.int32)
    got = cs.ccl_mask(m, "cur", done=done, out=out)
    assert got is out
    assert bool((out[1::2] == -7).all())
    assert torch.equal(out[0::2], cs.sweep_ccl_reference(m[0::2], "cur"))
    with pytest.raises(ValueError):
        cs.ccl_mask(m, "runtable", done=done, out=out)
    with pytest.raises(ValueError):
        cs.ccl_mask(m, "cur", done=done)


def test_a_sweep_as_the_variant():
    m = _masks()
    one = cs.SWEEP_VARIANTS["cur"]._replace(fixed=1)
    got = cs.ccl_mask(m, one)
    assert torch.equal(got, cs.sweep_ccl_reference(m, one))
    # one unit is not yet the labels of the noise masks; the fixpoint is
    assert not torch.equal(got, cs.ccl_mask(m, "cur"))
