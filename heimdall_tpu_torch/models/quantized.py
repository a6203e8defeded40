"""Int8 post-training quantization for the segmentation U-Net on
PyTorch/CUDA (port of heimdall_tpu/models/quantized.py).

Weights are quantized symmetrically per output channel to int8,
activations per tensor with scales calibrated on representative frames
(a high percentile of |x| at each layer's input).  Each convolution
accumulates the int8 x int8 products exactly, as JAX's s8 x s8 -> s32
``lax.conv_general_dilated`` does: torch has no exact int8 convolution
(``F.conv2d`` on int8 tensors returns int8 and wraps; cuDNN's float
algorithms may use Winograd or FFT), so the products are explicit float64
matrix products of integer values (a 3x3 convolution as 9 products, one
per tap; the 2x2 stride-2 transposed convolution as one product per input
pixel), exact while |sum| < 2^53 (127^2 x K for K products), then int32.
Between layers activations stay float32.

``qparams`` keep JAX's layout and names ({layer: {"kernel_q" (HWIO int8),
"w_scale", "bias", "act_scale"}}), so ``save``/``load`` read and write
JAX's ``.npz`` files both ways.

Usage::

    seg = DefectSegmenter(device="cuda")
    qseg = QuantizedSegmenter.from_segmenter(seg, calib_images)
    prob = qseg.predict(frames)           # same contract as DefectSegmenter
    SegmentationDetector(qseg)            # drops into the detector stack
"""

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from heimdall_tpu_torch.detectors.contamination_detector import (
    resolve_device)
from heimdall_tpu_torch.models.convert import (conv_transpose_weight,
                                               conv_weight,
                                               flax_from_state_dict)
from heimdall_tpu_torch.models.segmentation import (_to_model_input,
                                                    unet_forward)

# layer order of SegmentationUNet's forward pass; (name, kind)
_LAYERS: List[Tuple[str, str]] = [
    ("Conv_0", "conv"), ("Conv_1", "conv"),        # enc 1
    ("Conv_2", "conv"), ("Conv_3", "conv"),        # enc 2
    ("Conv_4", "conv"),                            # bottleneck
    ("ConvTranspose_0", "up"), ("Conv_5", "conv"),  # dec 2
    ("ConvTranspose_1", "up"), ("Conv_6", "conv"),  # dec 1
    ("Conv_7", "conv"),                            # head (1x1, no relu)
]


def _float_forward_taps(model, x):
    """The float UNet's logits and each quantized layer's input tensor
    (for activation-scale calibration)."""
    taps: Dict[str, torch.Tensor] = {}
    return model(x, taps), taps


def quantize_params(params, act_scales: Dict[str, float]):
    """Symmetric per-output-channel int8 weights + float biases/scales
    (params in flax's layout, as numpy)."""
    q = {}
    for name, _ in _LAYERS:
        k = np.asarray(params[name]["kernel"], np.float32)
        amax = np.abs(k).max(axis=(0, 1, 2))          # per out-channel
        w_scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        wq = np.clip(np.rint(k / w_scale), -127, 127).astype(np.int8)
        q[name] = {
            "kernel_q": wq,
            "w_scale": w_scale,
            "bias": np.asarray(params[name]["bias"], np.float32),
            "act_scale": np.float32(act_scales[name]),
        }
    return q


def _int_conv_same(qx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 "SAME" convolution of integer-valued float64 qx [N, C, H, W]
    by w [O, C, kh, kw] (odd kh, kw), exactly: one product per tap."""
    kh, kw = w.shape[-2:]
    H, W = qx.shape[-2:]
    xp = F.pad(qx, (kw // 2, kw // 2, kh // 2, kh // 2))
    acc = None
    for i in range(kh):
        for j in range(kw):
            t = torch.einsum("oc,nchw->nohw", w[:, :, i, j],
                             xp[:, :, i:i + H, j:j + W])
            acc = t if acc is None else acc + t
    return acc


def _int_conv_transpose2(qx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose((2, 2), strides 2, "SAME") of integer-valued
    float64 qx [N, C, H, W] by w in conv_transpose2d's layout [C, O, 2, 2]:
    output pixel (2i + a, 2j + b) is sum_c qx[c, i, j] * w[c, o, a, b]."""
    N, _, H, W = qx.shape
    y = torch.einsum("nchw,coab->nohawb", qx, w)
    return y.reshape(N, w.shape[1], 2 * H, 2 * W)


class QuantizedSegmenter:
    """Int8 drop-in for DefectSegmenter inference (predict/save/load), on
    ``device`` (CUDA unless "cpu" is named; raises when there is no card)."""

    def __init__(self, qparams, device=None):
        self.device = resolve_device(device)
        self.qparams = {name: {k: np.asarray(v) for k, v in p.items()}
                        for name, p in qparams.items()}
        dev = self.device
        self._layers = {}
        for name, p in self.qparams.items():
            to_torch = (conv_transpose_weight if name.startswith(
                "ConvTranspose") else conv_weight)
            w = to_torch(p["kernel_q"]).astype(np.float64)
            s = np.float32(p["act_scale"])
            self._layers[name] = (
                torch.from_numpy(w).to(dev),
                torch.tensor(s, device=dev),
                # the epilogue's scale, s * w_scale, formed in float32 as
                # JAX forms it
                torch.from_numpy(s * p["w_scale"].astype(np.float32))
                .to(dev)[:, None, None],
                torch.from_numpy(p["bias"].astype(np.float32)).to(dev)
                [:, None, None])

    def _qconv(self, name, v, relu=True, transpose=False):
        w, s, scale, bias = self._layers[name]
        qx = torch.clamp(torch.round(v / s), -127, 127).to(torch.float64)
        acc = (_int_conv_transpose2(qx, w) if transpose
               else _int_conv_same(qx, w))
        y = acc.to(torch.int32).to(torch.float32) * scale + bias
        return F.relu(y) if relu else y

    @torch.no_grad()
    def _forward(self, x):
        logits = unet_forward(
            self._qconv,
            lambda name, v: self._qconv(name, v, relu=False, transpose=True),
            x)
        return torch.sigmoid(logits[:, 0])

    # -- construction --------------------------------------------------------
    @classmethod
    def from_segmenter(cls, segmenter, calib_images: np.ndarray,
                       percentile: float = 99.9,
                       device=None) -> "QuantizedSegmenter":
        """Post-training quantization: calibrate activation scales on
        representative frames (high percentile of |x| is robust to outlier
        pixels), then quantize weights per-channel.  Runs on the
        segmenter's device unless another is named."""
        x, _ = _to_model_input(np.asarray(calib_images), segmenter.device)
        with torch.no_grad():
            _, taps = _float_forward_taps(segmenter.model, x)
        scales = {}
        for name, _ in _LAYERS:
            a = np.abs(taps[name].cpu().numpy().astype(np.float32))
            amax = float(np.percentile(a, percentile)) if a.size else 1.0
            scales[name] = max(amax, 1e-6) / 127.0
        return cls(quantize_params(
            flax_from_state_dict(segmenter.model.state_dict()), scales),
            device=segmenter.device if device is None else device)

    # -- inference (same contract as DefectSegmenter.predict) ---------------
    def predict(self, images) -> np.ndarray:
        x, (H, W) = _to_model_input(images, self.device)
        return self._forward(x)[:, :H, :W].cpu().numpy()

    # -- persistence (JAX's .npz keys and dtypes) ------------------------------
    def save(self, path: str) -> None:
        flat = {}
        for name, p in self.qparams.items():
            for k, v in p.items():
                flat[f"{name}/{k}"] = np.asarray(v)
        np.savez(path, **flat)

    @classmethod
    def load(cls, path: str, device=None) -> "QuantizedSegmenter":
        data = np.load(path)
        q: Dict[str, Dict[str, np.ndarray]] = {}
        for key in data.files:
            name, k = key.split("/")
            q.setdefault(name, {})[k] = data[key]
        return cls(q, device=device)
