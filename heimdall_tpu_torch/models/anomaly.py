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

``fit`` trains on good frames with the port's optax.adam
(models/optim.py), the MSE against the tiles / 255 as the loss, batches in
the order of ``np.random.RandomState(0)`` permutations, and calibrates
``threshold`` (also settable) as the mean + sigma * std of the training
tiles' errors.  The float32 last layer runs without TF32 on the card
(models/layers.py::float32_convs), in training through the backward too.
"""

import logging
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from heimdall_tpu_torch.detectors.contamination_detector import (
    resolve_device)
from heimdall_tpu_torch.models.layers import (bf16, bf16_conv,
                                              conv_transpose_same,
                                              float32_convs,
                                              init_flax_defaults)
from heimdall_tpu_torch.models.optim import Adam, train_step

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
        dev = x.device
        x = bf16(x.permute(0, 3, 1, 2)) / torch.tensor(
            255.0, dtype=torch.bfloat16, device=dev)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            # "SAME" at stride 2 on an even side: 0 before, 1 after
            x = F.relu(bf16_conv(conv, x, pad=(0, 1, 0, 1)))
        for up in (self.ConvTranspose_0, self.ConvTranspose_1):
            x = F.relu(conv_transpose_same(up, x, torch.bfloat16))
        with float32_convs(dev):
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


def _target(x: torch.Tensor) -> torch.Tensor:
    """uint8 tiles [N, 64, 64, 1] -> float32 [N, 1, 64, 64] / 255."""
    return x.permute(0, 3, 1, 2).to(torch.float32) / torch.tensor(
        255.0, device=x.device)


class AnomalyDetector:
    """Train on good frames and score frames by reconstruction error, on
    ``device`` (CUDA unless "cpu" is named; raises when there is no card).
    ``tx`` is the optimizer and ``opt_state`` its state."""

    def __init__(self, seed: int = 0, learning_rate: float = 1e-3,
                 device=None):
        self.device = resolve_device(device)
        self.learning_rate = learning_rate
        self.model = init_flax_defaults(ConvAutoencoder(), seed).to(
            self.device).eval()
        self.tx = Adam(self.model.parameters(), learning_rate)
        self.threshold: Optional[float] = None

    @property
    def opt_state(self):
        return self.tx.state

    def _train_step(self, tiles: np.ndarray) -> torch.Tensor:
        """One optimizer step on uint8 tiles [n, 64, 64, 1]; the loss."""
        x = torch.from_numpy(np.ascontiguousarray(tiles)).to(self.device)
        return train_step(
            self.tx, lambda: ((self.model(x) - _target(x)) ** 2).mean(),
            self.device)

    # ------------------------------------------------------------------
    def fit(self, good_frames: np.ndarray, epochs: int = 20,
            batch_size: int = 64, calibration_sigma: float = 4.0) -> float:
        """Train on known-good frames and calibrate the anomaly threshold
        (mean + sigma * std of training-tile errors)."""
        tiles = _tile_frames(good_frames)
        rng = np.random.RandomState(0)
        last_loss = 0.0
        for _ in range(epochs):
            order = rng.permutation(len(tiles))
            for start in range(0, len(tiles), batch_size):
                batch = tiles[order[start:start + batch_size]]
                if len(batch) < 2:
                    continue
                last_loss = float(self._train_step(batch))
        errors = self._tile_errors(tiles)
        self.threshold = float(errors.mean()
                               + calibration_sigma * errors.std())
        logger.info("anomaly AE trained: loss=%.5f threshold=%.5f",
                    last_loss, self.threshold)
        return last_loss

    @torch.no_grad()
    def _tile_errors(self, tiles: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(tiles)).to(self.device)
        return ((self.model(x) - _target(x)) ** 2).mean(
            dim=(1, 2, 3)).cpu().numpy()

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
