"""The fused detect's CUDA kernels (B1: the one-pass preprocess, the tile
fill, the tile labeling, the stats) against their plain PyTorch version on
the card, on the cases that attack the tiles (marked ``cuda``; each test
skips where torch.cuda.is_available() is false).  This file imports no
JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_fused_cuda.py -q -m cuda --noconftest

Equality is exact: sums, bbox, bgsum, n_blobs and the label plane are
integers.  tests/test_torch_label_cases.py holds the plain version against
the JAX package on the same cases.
"""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops.fused_kernels import (
    contamination_fused, contamination_fused_reference)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _frames(h, w):
    """tile_case_frames and the label cases drawn dark on light, BGR
    [n, h, w, 3] uint8."""
    tiles = np.stack(list(scene.tile_case_frames(h, w).values()))
    drawn = scene.mask_frames(list(scene.label_case_masks(h, w).values()))
    return np.concatenate([tiles, drawn])


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(480, 640), (477, 631), (13, 17), (3, 3)])
@pytest.mark.parametrize("k", [64, 4])
def test_fused_detect_tile_and_label_cases(card, size, k):
    frames = _frames(*size)
    for x, cm in ((frames, False),
                  (frames.transpose(0, 3, 1, 2), True),
                  (frames[..., 1], False)):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(card)
        for ct in (15, -15):
            got = contamination_fused(x, ct, k, cm, return_labels=True)
            want = contamination_fused_reference(x, ct, k, cm,
                                                 return_labels=True)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert a.shape == b.shape and torch.equal(a, b)
