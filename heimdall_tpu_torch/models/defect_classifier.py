"""Learned defect classification: a compact CNN over blob patches, on
PyTorch/CUDA (port of heimdall_tpu/models/defect_classifier.py).

A small CNN scores defect-candidate patches cut around blob-table bboxes.
The convolutions and the first dense layer run in bfloat16 as flax's
``dtype=bf16`` layers do (models/layers.py), the last layer in float32.

Checkpoints: ``save`` writes the model's ``state_dict`` (torch.save) as
``params.pt`` in the checkpoint directory, where JAX writes an orbax
``params`` directory or ``params.msgpack``, which cannot be read without
jax; ``load`` raises FileNotFoundError as JAX's does.  Training
(``ClassifierTrainer``, ``make_sharded_train_step``) belongs to later
slices and raises NotImplementedError.
"""

import logging
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from heimdall_tpu_torch.detectors.contamination_detector import (
    resolve_device)
from heimdall_tpu_torch.models.layers import (SHARDED_MISSING,
                                              TRAINING_MISSING, bf16,
                                              bf16_conv, bf16_linear,
                                              init_flax_defaults)

logger = logging.getLogger("heimdall.models")

PATCH_SIZE = 32


class DefectClassifierCNN(nn.Module):
    """3-block CNN for 32x32 grayscale blob patches -> defect classes.
    x: uint8 [N, 32, 32, 1] (flax's NHWC input); returns float32 logits."""

    def __init__(self, n_classes: int = 2, width: int = 32):
        super().__init__()
        self.n_classes = n_classes
        self.width = width
        self.Conv_0 = nn.Conv2d(1, width, 3, padding=1)
        self.Conv_1 = nn.Conv2d(width, 2 * width, 3, padding=1)
        self.Conv_2 = nn.Conv2d(2 * width, 4 * width, 3, padding=1)
        side = PATCH_SIZE // 8
        self.Dense_0 = nn.Linear(side * side * 4 * width, 128)
        self.Dense_1 = nn.Linear(128, n_classes)

    def flatten_shape(self):
        """(H, W, C) of the map flattened into Dense_0 (convert.py)."""
        side = PATCH_SIZE // 8
        return (side, side, 4 * self.width)

    def forward(self, x):
        x = bf16(x.permute(0, 3, 1, 2)) / torch.tensor(
            255.0, dtype=torch.bfloat16, device=x.device)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.max_pool2d(F.relu(bf16_conv(conv, x)), 2)
        x = F.relu(bf16_linear(self.Dense_0, x.flatten(1)))
        return F.linear(x.float(), self.Dense_1.weight) + self.Dense_1.bias


def extract_blob_patches(frames: np.ndarray, table,
                         patch: int = PATCH_SIZE) -> np.ndarray:
    """Cut per-blob patches around blob-table bboxes (host side).

    frames: [N, H, W] grayscale (or [N, H, W, C] — averaged).
    table: BlobTable from the detector (numpy fields).
    Returns [N*K_valid, patch, patch, 1] uint8.
    """
    frames = np.asarray(frames)
    if frames.ndim == 4:
        frames = frames.mean(axis=-1).astype(np.uint8)
    N, H, W = frames.shape
    valid = np.asarray(table.valid)
    xs, ys = np.asarray(table.x), np.asarray(table.y)
    ws, hs = np.asarray(table.w), np.asarray(table.h)
    patches = []
    for i in range(N):
        for k in np.nonzero(valid[i])[0]:
            cx = xs[i][k] + ws[i][k] // 2
            cy = ys[i][k] + hs[i][k] // 2
            x0 = int(np.clip(cx - patch // 2, 0, W - patch))
            y0 = int(np.clip(cy - patch // 2, 0, H - patch))
            patches.append(frames[i, y0:y0 + patch, x0:x0 + patch])
    if not patches:
        return np.zeros((0, patch, patch, 1), np.uint8)
    return np.stack(patches)[..., None]


class DefectClassifier:
    """Inference wrapper: score patches -> per-patch class probabilities,
    on ``device`` (CUDA unless "cpu" is named; raises when there is no
    card)."""

    def __init__(self, n_classes: int = 2, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model = init_flax_defaults(
            DefectClassifierCNN(n_classes=n_classes), seed).to(
                self.device).eval()

    @torch.no_grad()
    def predict(self, patches: np.ndarray) -> np.ndarray:
        if len(patches) == 0:
            return np.zeros((0, self.model.n_classes), np.float32)
        x = torch.from_numpy(np.ascontiguousarray(patches)).to(self.device)
        return torch.softmax(self.model(x), -1).cpu().numpy()

    # -- checkpoint/resume -------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        torch.save(self.model.state_dict(), os.path.join(path, "params.pt"))

    def load(self, path: str) -> None:
        params = os.path.join(path, "params.pt")
        if not os.path.exists(params):
            raise FileNotFoundError(path)
        self.model.load_state_dict(torch.load(params,
                                              map_location=self.device))


class ClassifierTrainer:
    """Training loop of the JAX package; not ported yet."""

    def __init__(self, classifier: DefectClassifier,
                 learning_rate: float = 1e-3):
        raise NotImplementedError(TRAINING_MISSING)


def make_sharded_train_step(mesh, n_classes: int = 2,
                            learning_rate: float = 1e-3):
    """Data-parallel train step of the JAX package; not ported yet."""
    raise NotImplementedError(SHARDED_MISSING)
