"""Learned defect classification: a compact CNN over blob patches, on
PyTorch/CUDA (port of heimdall_tpu/models/defect_classifier.py).

A small CNN scores defect-candidate patches cut around blob-table bboxes.
The convolutions and the first dense layer run in bfloat16 as flax's
``dtype=bf16`` layers do (models/layers.py), the last layer in float32.

Training takes steps of the port's optax.adam (models/optim.py) on the
softmax cross-entropy of integer labels, through the same bf16 forward:
the products and their gradients are bf16, and the casts of the float32
parameters are the gradients' way back, as in flax.
``make_sharded_train_step`` runs the step data-parallel over a mesh of
heimdall_tpu_torch/parallel, one process per rank.

Checkpoints: ``save`` writes the model's ``state_dict`` (torch.save) as
``params.pt`` in the checkpoint directory, where JAX writes an orbax
``params`` directory or ``params.msgpack``, which cannot be read without
jax; ``load`` raises FileNotFoundError as JAX's does.
"""

import logging
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from heimdall_tpu_torch.detectors.contamination_detector import (
    resolve_device)
from heimdall_tpu_torch.models.layers import (bf16, bf16_conv, bf16_linear,
                                              init_flax_defaults)
from heimdall_tpu_torch.models.optim import Adam, train_step

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


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels: logsumexp minus the
    labelled logit, per row."""
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0])


class ClassifierTrainer:
    """Single-process training loop on the classifier's device; ``tx`` is
    the optimizer and ``opt_state`` its state."""

    def __init__(self, classifier: DefectClassifier,
                 learning_rate: float = 1e-3):
        self.classifier = classifier
        self.tx = Adam(classifier.model.parameters(), learning_rate)

    @property
    def opt_state(self):
        return self.tx.state

    def train_step(self, patches: np.ndarray, labels: np.ndarray) -> float:
        model, dev = self.classifier.model, self.classifier.device
        x = torch.from_numpy(np.ascontiguousarray(patches)).to(dev)
        y = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
        return float(train_step(
            self.tx, lambda: softmax_cross_entropy(model(x), y).mean(), dev))


def make_sharded_train_step(mesh, n_classes: int = 2,
                            learning_rate: float = 1e-3):
    """Build this rank's data-parallel train step over the inspection mesh.

    Every rank of the mesh calls ``train(patches_u8 [N, 32, 32, 1],
    labels [N])`` with the same global batch and steps on its block of N
    over ("data", "spatial") flattened (JAX's ``P(("data", "spatial"))``,
    the flat-block order of parallel/inspect_step.py); N must divide over
    the mesh's ranks.  Parameters are replicated: each rank initialises
    from seed 0, and the gradients are summed over the mesh
    (parallel/collectives.py: NCCL, or gloo staged through pinned host
    buffers) and divided by its size, so every rank applies the same
    update.  Returns the loss, the global mean, as a 0-d tensor on the
    rank's device; ``train.state`` holds ``params`` (the model) and
    ``opt`` (its optimizer)."""
    from heimdall_tpu_torch.parallel import collectives
    from heimdall_tpu_torch.parallel.inspect_step import _flat_block
    from heimdall_tpu_torch.parallel.mesh import mesh_group, rank_device
    from heimdall_tpu_torch.parallel.sharding import shard_batch

    dev = rank_device()
    model = init_flax_defaults(DefectClassifierCNN(n_classes=n_classes),
                               0).to(dev)
    tx = Adam(model.parameters(), learning_rate)
    group = mesh_group(mesh, ("data", "spatial"))
    n_ranks = int(mesh.mesh.numel())
    size = torch.tensor(float(n_ranks), device=dev)
    params = list(model.parameters())

    def reduce_grads():
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        flat = collectives.all_reduce(flat, "sum", group) / size
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def train(patches, labels):
        n = len(patches)
        if n % n_ranks or len(labels) != n:
            raise ValueError(
                f"a batch of {n} patches ({len(labels)} labels) does not "
                f"divide over the mesh's {n_ranks} devices")
        x = _flat_block(mesh, shard_batch(mesh, np.asarray(patches)))
        y = _flat_block(mesh, shard_batch(mesh, np.asarray(labels,
                                                           np.int64)))
        loss = train_step(
            tx, lambda: softmax_cross_entropy(model(x), y).mean(), dev,
            reduce_grads)
        return collectives.all_reduce(loss, "sum", group) / size

    train.state = {"params": model, "opt": tx}
    return train
