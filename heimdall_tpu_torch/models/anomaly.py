"""Unsupervised anomaly detection: a convolutional autoencoder over frames,
on PyTorch/CUDA (port of heimdall_tpu/models/anomaly.py).

Frames are scored in 64x64 tiles by reconstruction error; a frame whose
worst tile's error passes ``threshold`` is anomalous.  The encoder's
stride-2 convolutions and the first two transposed convolutions run in
bfloat16 as flax's ``dtype=bf16`` layers do, the last one in float32.
flax's stride-2 "SAME" convolution pads 0 before and 1 after a 64-wide
tile (``Conv2d(padding=1)`` would pad 1 and 1), and its 3x3 stride-2
"SAME" transposed convolution is torch's with the last row and column
dropped (models/layers.py).

``threshold`` is a settable attribute; ``fit`` (training and calibration)
belongs to the training slice and raises NotImplementedError.
"""

import logging
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from heimdall_tpu_torch.detectors.contamination_detector import (
    resolve_device)
from heimdall_tpu_torch.models.layers import (TRAINING_MISSING, bf16,
                                              bf16_conv, conv_transpose_same,
                                              init_flax_defaults)

logger = logging.getLogger("heimdall.models.anomaly")

PATCH = 64   # frames are scored in 64x64 tiles


class ConvAutoencoder(nn.Module):
    """Small conv AE for 64x64 grayscale tiles.  x: uint8 [N, 64, 64, 1]
    (flax's NHWC input); returns the float32 reconstruction [N, 1, 64, 64]
    in [0, 1]."""

    def __init__(self, width: int = 16):
        super().__init__()
        w = width
        self.Conv_0 = nn.Conv2d(1, w, 3, stride=2)
        self.Conv_1 = nn.Conv2d(w, 2 * w, 3, stride=2)
        self.Conv_2 = nn.Conv2d(2 * w, 4 * w, 3, stride=2)
        self.ConvTranspose_0 = nn.ConvTranspose2d(4 * w, 2 * w, 3, stride=2)
        self.ConvTranspose_1 = nn.ConvTranspose2d(2 * w, w, 3, stride=2)
        self.ConvTranspose_2 = nn.ConvTranspose2d(w, 1, 3, stride=2)

    def forward(self, x):
        x = bf16(x.permute(0, 3, 1, 2)) / torch.tensor(
            255.0, dtype=torch.bfloat16, device=x.device)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            # "SAME" at stride 2 on an even side: 0 before, 1 after
            x = F.relu(bf16_conv(conv, x, pad=(0, 1, 0, 1)))
        for up in (self.ConvTranspose_0, self.ConvTranspose_1):
            x = F.relu(conv_transpose_same(up, x, torch.bfloat16))
        x = conv_transpose_same(self.ConvTranspose_2, x, torch.float32)
        return torch.sigmoid(x)


def _tile_frames(frames: np.ndarray) -> np.ndarray:
    """[N, H, W] uint8 -> [N*tiles, PATCH, PATCH, 1] (crop to multiples)."""
    frames = np.asarray(frames)
    if frames.ndim == 4:
        frames = frames.mean(axis=-1).astype(np.uint8)
    n, h, w = frames.shape
    th, tw = h // PATCH, w // PATCH
    cropped = frames[:, :th * PATCH, :tw * PATCH]
    tiles = cropped.reshape(n, th, PATCH, tw, PATCH)
    tiles = tiles.transpose(0, 1, 3, 2, 4).reshape(-1, PATCH, PATCH)
    return tiles[..., None]


class AnomalyDetector:
    """Score frames by reconstruction error, on ``device`` (CUDA unless
    "cpu" is named; raises when there is no card)."""

    def __init__(self, seed: int = 0, learning_rate: float = 1e-3,
                 device=None):
        self.device = resolve_device(device)
        self.learning_rate = learning_rate
        self.model = init_flax_defaults(ConvAutoencoder(), seed).to(
            self.device).eval()
        self.threshold: Optional[float] = None

    def fit(self, good_frames: np.ndarray, epochs: int = 20,
            batch_size: int = 64, calibration_sigma: float = 4.0) -> float:
        raise NotImplementedError(TRAINING_MISSING)

    @torch.no_grad()
    def _tile_errors(self, tiles: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(tiles)).to(self.device)
        recon = self.model(x)
        target = x.permute(0, 3, 1, 2).to(torch.float32) / torch.tensor(
            255.0, device=self.device)
        return ((recon - target) ** 2).mean(dim=(1, 2, 3)).cpu().numpy()

    def score(self, frames: np.ndarray) -> np.ndarray:
        """Max tile reconstruction error per frame (higher = more
        anomalous)."""
        frames = np.asarray(frames)
        if frames.ndim == 2:
            frames = frames[None]
        n = len(frames)
        errors = self._tile_errors(_tile_frames(frames))
        return errors.reshape(n, -1).max(axis=1)

    def is_anomalous(self, frames: np.ndarray) -> np.ndarray:
        if self.threshold is None:
            raise RuntimeError("call fit() first")
        return self.score(frames) > self.threshold
