"""What the port's models share: flax's default initialisation from an
explicit torch.Generator, float32 convolutions on the card (no TF32) and
the bf16 layers of the flax models with ``dtype=bf16``.

A flax ``Conv``/``ConvTranspose``/``Dense`` with ``dtype=bf16`` casts its
input, kernel and bias to bf16, rounds the product to bf16 and then adds
the bias in bf16; ``bf16_conv`` and friends do the same steps (the
parameters stay float32, as flax's ``param_dtype``).
"""

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal draws a normal truncated to 2 standard deviations
# and divides by the truncated distribution's standard deviation
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn(shape, generator=gen)
    while True:
        bad = x.abs() > 2
        n = int(bad.sum())
        if not n:
            break
        x[bad] = torch.randn(n, generator=gen)
    return x * ((1.0 / fan_in) ** 0.5 / _TRUNC_STD)


def init_flax_defaults(module: nn.Module, seed: int) -> nn.Module:
    """flax's defaults, seeded by a torch.Generator on the CPU (the same
    weights on every device): lecun_normal kernels (fan_in = kh * kw * in),
    zero biases, layers in the order they were created."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in module.modules():
            if isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = layer.weight
                if isinstance(layer, nn.ConvTranspose2d):
                    fan_in = w.shape[0] * w.shape[2] * w.shape[3]
                else:
                    fan_in = w[0].numel()
                w.copy_(_lecun_normal(w.shape, fan_in, gen))
                layer.bias.zero_()
    return module


# cuDNN's TF32 flag is process-wide, not per thread: the forwards that turn
# it off hold this lock, so that one forward's exit cannot turn TF32 back on
# in the middle of another's
_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def float32_convs(device: torch.device):
    """cuDNN convolutions in float32 (TF32 off) for the calls inside, the
    setting restored after; nothing on the CPU.  The flag is global, so the
    calls inside hold a lock: concurrent forwards run one at a time, and
    other threads' convolutions run without TF32 while one is inside."""
    if device.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    with _TF32_LOCK, cudnn.flags(enabled=cudnn.enabled,
                                 benchmark=cudnn.benchmark,
                                 deterministic=cudnn.deterministic,
                                 allow_tf32=False):
        yield


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16)


def bf16_conv(layer: nn.Conv2d, x: torch.Tensor, pad=None) -> torch.Tensor:
    """flax Conv(dtype=bf16): the product in bf16, then the bias in bf16.
    pad: explicit (left, right, top, bottom) padding (flax "SAME" with
    stride 2 pads 0 before and 1 after)."""
    if pad is not None:
        x = F.pad(x, pad)
    y = F.conv2d(bf16(x), bf16(layer.weight), None, layer.stride,
                 layer.padding)
    return y + bf16(layer.bias)[:, None, None]


def conv_transpose_same(layer: nn.ConvTranspose2d, x: torch.Tensor,
                        dtype) -> torch.Tensor:
    """flax ConvTranspose(kernel k, strides 2, "SAME") in ``dtype``: the
    stride-2 transposed convolution of the flipped kernel (convert.py),
    cropped to 2H x 2W (for k = 3 flax pads the dilated input 2 before and 1
    after, so the last row and column of torch's output go; for k = 2
    nothing is cropped), then the bias in ``dtype``."""
    H, W = x.shape[-2:]
    y = F.conv_transpose2d(x.to(dtype), layer.weight.to(dtype), None,
                           layer.stride)
    return y[..., :2 * H, :2 * W] + layer.bias.to(dtype)[:, None, None]


def bf16_linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(bf16(x), bf16(layer.weight)) + bf16(layer.bias)

