"""The primitive microbench's CUDA kernel (csrc/primitives.cu) against its
plain PyTorch version, on the card (marked ``cuda``; each test skips where
torch.cuda.is_available() is false).  This file imports no JAX; on a
machine with a card:

    python -m pytest tests/test_torch_primitives_cuda.py -q -m cuda --noconftest

Equality is exact (every output is an integer plane).  The planes are the
script's own (RandomState(0), values in [0, 60)) at a batch of 4, and a
second seed with values in [-60, 60), at the script's shape and at shapes
at the edges of the kernels' layouts: rows and columns that are not
multiples of 32, of 20 (a lane's values in the blocked layout) or of a
warp's band of 4 rows (9 rows leave bands and blocks of a cluster empty;
33 columns are narrower than the ladders' longest shifts; 639 columns
take the rolls' line buffer), and the cross-row steps at 1, 2, 8, 17 and
479 rows, at 700 (a cluster of 16 blocks) and on frames of more than 1024
rows (a block's rows in shared memory).  N is 0, 1, 4, 36 and 37.  The narrow types' add, select and
scans also run on planes at their types' extremes.
"""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch.ops import _cuda, _launch
from heimdall_tpu_torch.ops import primitives as pr

IDS = [f"{n}-{d}" for n, d, _, _ in pr.VARIANTS]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _planes(name, dtype, sub, w):
    """The script's planes of this variant at a batch of 4 (cut to [sub,
    w], repeated down the rows where sub is taller), then 4 planes of a
    second seed in [-60, 60)."""
    first = next(x for n, d, x in pr.inputs(only={name}, batch=4)
                 if d == dtype)
    first = np.tile(first, (1, -(-sub // first.shape[1]), 1))
    second = np.random.RandomState(1).randint(-60, 60, (4, sub, w))
    return torch.from_numpy(np.concatenate(
        [first[:, :sub, :w], second.astype(dtype)]))


def _check_equal(x, name):
    for iters in ITERS:
        for out_rows in (1, x.shape[1]):
            got = pr.primitive_steps(x, name, iters, out_rows)
            want = pr.primitive_steps_reference(x, name, iters, out_rows)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, x.dtype, tuple(x.shape),
                                            iters, out_rows)


ITERS = (0, 1, 4, 36, 37)
CROSS = [v for v in pr.VARIANTS if v[0] in pr.CROSS_ROW]
NARROW = [v for v in pr.VARIANTS if v[1] != "int32" and v[0] in (
    "add", "select", "min_scan_step", "max_scan_step")]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", pr.VARIANTS, ids=IDS)
@pytest.mark.parametrize("shape", [(480, 640), (77, 600), (9, 33), (3, 1),
                                   (5, 20), (5, 21), (4, 31), (4, 32),
                                   (7, 63), (17, 639)])
def test_kernel_equals_plain(card, variant, shape):
    name, dtype, _, _ = variant
    rows, w = shape
    _check_equal(_planes(name, dtype,
                         2 * rows if name == "seg_min_step" else rows,
                         w).to(card), name)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", CROSS,
                         ids=[f"{n}-{d}" for n, d, _, _ in CROSS])
@pytest.mark.parametrize("shape", [(1, 640), (2, 640), (8, 640), (17, 640),
                                   (479, 640), (479, 639), (700, 640),
                                   (1100, 64)])
def test_cross_rows_equal_plain(card, variant, shape):
    name, dtype, _, _ = variant
    _check_equal(_planes(name, dtype, *shape).to(card), name)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", NARROW,
                         ids=[f"{n}-{d}" for n, d, _, _ in NARROW])
def test_narrow_types_at_their_extremes(card, variant):
    name, dtype, _, _ = variant
    info = np.iinfo(dtype)
    edges = np.array([info.min, info.min + 1, -1, 0, 1, info.max - 1,
                      info.max], dtype)
    x = np.random.RandomState(2).choice(edges, (4, 33, 640))
    _check_equal(torch.from_numpy(x).to(card), name)


@pytest.mark.cuda
def test_refused_launch_raises(card):
    x = torch.zeros((2, 8, 641), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="640 columns"):
        pr.primitive_steps(x, "add", 1)
    out = torch.empty((2, 1, 641), dtype=torch.int32, device=card)
    err = _cuda.library("primitives").hd_primitive_steps(
        x.data_ptr(), 2, 8, 641, pr.STEPS.index("add"), 0, 1, 1,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _launch.raise_on(err, "primitive_steps")


@pytest.mark.cuda
def test_launches_counted(card):
    x = torch.zeros((2, 480, 640), dtype=torch.int32, device=card)
    pr.primitive_steps.launches = 0
    pr.primitive_steps.variant_launches.clear()
    pr.primitive_steps(x, "nbmin8", 2)
    pr.primitive_steps(x, "add", 0)
    pr.primitive_steps(x.cpu(), "add", 1)        # the plain version
    torch.cuda.synchronize()
    assert pr.primitive_steps.launches == 2
    assert dict(pr.primitive_steps.variant_launches) == {
        "nbmin8/int32": 1, "add/int32": 1}
