"""Per-pixel defect segmentation (U-Net) and its detector on PyTorch/CUDA
(port of heimdall_tpu/models/segmentation.py).

A compact encoder-decoder CNN predicts a per-pixel defect probability map;
the detector thresholds it, labels the mask with 6 of JAX's sweeps and no
fixpoint check (ops/ccl.py::connected_components(sweeps=6), as
heimdall_tpu/models/segmentation.py:172 labels) and builds the table from
those labels as JAX's blobs.blob_stats does (ops/blobs.py), so a learned
model gives JAX's ``Defect`` records, components that 6 sweeps leave split
included.  JAX's detector reaches no Pallas kernel there (XLA ops), so on
the card these are PyTorch ops too.

The UNet computes in float32: TF32 is off for its convolutions on the card
(models/layers.py::float32_convs), in a train step through its backward
too (models/optim.py::train_step).  ``train_step`` takes one step of the
port's optax.adam (models/optim.py) on optax's sigmoid binary
cross-entropy, positives weighted.  Parameters are a ``state_dict``
(flax's come across through models/convert.py); ``save``/``load`` write
and read one with torch.save, where JAX writes flax msgpack, which cannot
be read without flax.
"""

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from heimdall_tpu_torch.detectors.base import Defect
from heimdall_tpu_torch.detectors.contamination_detector import (
    download_table, resolve_device)
from heimdall_tpu_torch.models.layers import (conv_transpose_same,
                                              float32_convs,
                                              init_flax_defaults)
from heimdall_tpu_torch.models.optim import Adam, train_step
from heimdall_tpu_torch.ops.blobs import blob_stats
from heimdall_tpu_torch.ops.ccl import connected_components
from heimdall_tpu_torch.ops.color import bgr_to_gray


def unet_forward(conv, up, x):
    """SegmentationUNet's data flow over layer callables (shared by the
    float model and the int8 one, so the two stay in lockstep):
    conv(name, v, relu=True) and up(name, v); skips concatenated after
    the upsampled map, [up, skip], as in flax."""
    c1 = conv("Conv_1", conv("Conv_0", x))
    p1 = F.max_pool2d(c1, 2)
    c2 = conv("Conv_3", conv("Conv_2", p1))
    p2 = F.max_pool2d(c2, 2)
    b = conv("Conv_4", p2)
    u2 = conv("Conv_5", torch.cat([up("ConvTranspose_0", b), c2], 1))
    u1 = conv("Conv_6", torch.cat([up("ConvTranspose_1", u2), c1], 1))
    return conv("Conv_7", u1, relu=False)


class SegmentationUNet(nn.Module):
    """Small U-Net: 2 downsampling stages, skip connections, 1-channel
    logit map at input resolution.  x: float32 [B, 1, H, W] in [0, 1], H
    and W multiples of 4; returns logits [B, 1, H, W]."""

    def __init__(self, base: int = 16):
        super().__init__()
        self.base = base
        b = base
        for name, cin, cout in (("Conv_0", 1, b), ("Conv_1", b, b),
                                ("Conv_2", b, 2 * b),
                                ("Conv_3", 2 * b, 2 * b),
                                ("Conv_4", 2 * b, 4 * b),
                                ("Conv_5", 4 * b, 2 * b),
                                ("Conv_6", 2 * b, b)):
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.ConvTranspose_0 = nn.ConvTranspose2d(4 * b, 2 * b, 2, stride=2)
        self.ConvTranspose_1 = nn.ConvTranspose2d(2 * b, b, 2, stride=2)
        self.Conv_7 = nn.Conv2d(b, 1, 1)

    def forward(self, x, taps: Dict[str, torch.Tensor] = None):
        """taps: a dict that receives each layer's input (calibration)."""
        def conv(name, v, relu=True):
            if taps is not None:
                taps[name] = v
            y = getattr(self, name)(v)
            return F.relu(y) if relu else y

        def up(name, v):
            if taps is not None:
                taps[name] = v
            return conv_transpose_same(getattr(self, name), v, v.dtype)

        with float32_convs(x.device):
            return unet_forward(conv, up, x)


def _to_model_input(images, device):
    """uint8 [N, H, W(, 3)] -> float32 gray [N, 1, Hp, Wp] in [0, 1] on
    device, H and W padded to multiples of 4 (two pool stages) with edge
    values; returns (x, (H, W))."""
    x = images if isinstance(images, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(images))
    x = x.to(device)
    if x.dim() == 4 and x.shape[-1] == 3:
        x = bgr_to_gray(x)
    # a float32 tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal
    x = x.to(torch.float32) / torch.tensor(255.0, device=device)
    H, W = x.shape[-2:]
    ph, pw = (-H) % 4, (-W) % 4
    x = x[:, None]
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return x, (H, W)


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, elementwise, written as optax
    writes it."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


class DefectSegmenter:
    """Train/predict wrapper around SegmentationUNet, on ``device`` (CUDA
    unless "cpu" is named; raises when there is no card).  ``tx`` is the
    optimizer and ``opt_state`` its state."""

    def __init__(self, base: int = 16, seed: int = 0,
                 learning_rate: float = 1e-3, device=None):
        self.device = resolve_device(device)
        self.learning_rate = learning_rate
        self.model = init_flax_defaults(SegmentationUNet(base), seed).to(
            self.device).eval()
        self.tx = Adam(self.model.parameters(), learning_rate)

    @property
    def opt_state(self):
        return self.tx.state

    # -- training ------------------------------------------------------------
    def train_step(self, images: np.ndarray, masks: np.ndarray,
                   pos_weight: float = 8.0) -> float:
        """One optimizer step.  masks: bool/0-1 [N, H, W] ground truth.
        Defect pixels are rare, so positives are up-weighted; the rows and
        columns padded to a multiple of 4 carry no weight.  The step
        computes in the model's dtype (float32; a copy of the model made
        float64 with ``model.double()`` gives a reference step)."""
        return float(train_step(self.tx, self._loss_fn(images, masks,
                                                       pos_weight),
                                self.device))

    def _loss_fn(self, images, masks, pos_weight):
        """train_step's loss as a closure over the batch on the device."""
        dtype = self.model.Conv_0.weight.dtype
        x, (H, W) = _to_model_input(images, self.device)
        x = x.to(dtype)
        y = torch.from_numpy(np.asarray(masks, np.float32)).to(self.device,
                                                               dtype)
        ph, pw = x.shape[2] - H, x.shape[3] - W
        if ph or pw:
            y = F.pad(y, (0, pw, 0, ph))
        w = torch.where(y > 0, pos_weight, 1.0).to(dtype)
        if ph or pw:
            valid = torch.zeros(x.shape[2:], dtype=dtype, device=self.device)
            valid[:H, :W] = 1.0
            w = w * valid

        def loss_fn():
            bce = sigmoid_binary_cross_entropy(self.model(x)[:, 0], y)
            return (bce * w).sum() / torch.clamp_min(w.sum(), 1.0)

        return loss_fn

    @torch.no_grad()
    def predict(self, images) -> np.ndarray:
        """Per-pixel defect probability [N, H, W] float32."""
        x, (H, W) = _to_model_input(images, self.device)
        prob = torch.sigmoid(self.model(x)[:, 0])
        return prob[:, :H, :W].cpu().numpy()

    # -- persistence (a state_dict through torch.save) ------------------------
    def save(self, path: str) -> None:
        torch.save(self.model.state_dict(), path)

    def load(self, path: str) -> None:
        self.model.load_state_dict(torch.load(path,
                                              map_location=self.device))


class SegmentationDetector:
    """DefectDetector-compatible adapter: model mask -> labels -> blob
    table -> Defect records (same contract as ContaminationDetector.detect).
    The labeling runs on ``device`` (CUDA unless "cpu" is named)."""

    def __init__(self, segmenter, name: str = "segmentation_detector",
                 config: Dict[str, Any] = None, device=None):
        self.segmenter = segmenter
        self.name = name
        self.config = config or {}
        self.device = resolve_device(device)
        self.threshold = float(self.config.get("threshold", 0.5))
        self.min_size = float(self.config.get("min_contaminant_size", 3))
        self.max_size = float(self.config.get("max_contaminant_size", 3000))
        self.max_blobs = int(self.config.get("max_blobs", 64))

    def detect(self, image: np.ndarray,
               context: Dict[str, Any] = None) -> List[Any]:
        return self.detect_batch(np.asarray(image)[None], context)[0]

    def detect_batch(self, images: np.ndarray,
                     context: Dict[str, Any] = None) -> List[List[Any]]:
        images = np.asarray(images)
        prob = self.segmenter.predict(images)
        dev = self.device
        mask = torch.from_numpy(np.ascontiguousarray(
            prob >= self.threshold)).to(dev)
        gray = bgr_to_gray(torch.from_numpy(
            np.ascontiguousarray(images)).to(dev)).contiguous()
        labels = connected_components(mask, connectivity=8, sweeps=6)
        table = blob_stats(labels, mask, gray, None,
                           max_blobs=self.max_blobs, use_color=False)
        # one download; the table's own fields fill the confidence and gate
        # slots, which this detector does not use
        table = download_table(table, table.intensity_diff, table.valid)[0]
        out: List[List[Any]] = []
        for i in range(images.shape[0]):
            defects = []
            for k in np.nonzero(np.asarray(table.valid[i]))[0]:
                area = float(table.area[i][k])
                if not (self.min_size <= area <= self.max_size):
                    continue
                # confidence = mean predicted probability over the blob bbox
                x0, y0 = int(table.x[i][k]), int(table.y[i][k])
                w, h = int(table.w[i][k]), int(table.h[i][k])
                conf = float(prob[i, y0:y0 + h, x0:x0 + w].mean())
                defects.append(Defect(
                    defect_type="segmented_defect",
                    position=(int(table.cx[i][k]), int(table.cy[i][k])),
                    size=area, confidence=conf,
                    metadata={"bounding_box": (x0, y0, w, h),
                              "model": "unet"}))
            out.append(defects)
        return out
