"""Bayer demosaicing and YUV conversion on the device (port of
heimdall_tpu/ops/demosaic.py).

The raw mosaic goes to the device and demosaics there: bilinear
interpolation is a pair of small stencils, and the host never touches the
3x-expanded color data.  Every float32 operation is JAX's, in JAX's order
(no fused multiply-add, divisions by tensors: CUDA divides by a Python
scalar through its reciprocal), and ``torch.round`` rounds half to even as
``jnp.rint`` does, so the results equal JAX's run eagerly.

Patterns follow the OpenCV naming convention (which denotes the 2x2 cell
such that "BayerRG" has B at (0,0)): rg -> R at (1,1), bg -> R at (0,0),
gr -> R at (1,0), gb -> R at (0,1).

Both functions take a uint8 tensor (used on its device) or a numpy array
(uploaded to ``device``: CUDA unless "cpu" is named) and return a tensor.
"""

import numpy as np
import torch
import torch.nn.functional as F

_PATTERNS = {
    # (row offset, col offset) of the R sample within each 2x2 cell,
    # keyed by the OpenCV constant name (COLOR_Bayer<XY>2BGR)
    "rg": (1, 1),
    "gr": (1, 0),
    "gb": (0, 1),
    "bg": (0, 0),
}


def _on_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    # imported here: the detector's module imports ops, whose package
    # exports this module
    from heimdall_tpu_torch.detectors.contamination_detector import (
        resolve_device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        resolve_device(device))


def _pad_edge(x, rows: int, cols: int) -> torch.Tensor:
    """Edge padding of the last two axes of any-rank x (jnp.pad "edge")."""
    lead = x.shape[:-2]
    y = F.pad(x.reshape(-1, 1, *x.shape[-2:]), (cols, cols, rows, rows),
              mode="replicate")
    return y.reshape(*lead, *y.shape[-2:])


def _avg_cross(x):
    """Mean of the 4-neighbours (replicate border)."""
    p = _pad_edge(x, 1, 1)
    s = (p[..., :-2, 1:-1] + p[..., 2:, 1:-1]
         + p[..., 1:-1, :-2] + p[..., 1:-1, 2:])
    return s * 0.25


def _avg_diag(x):
    p = _pad_edge(x, 1, 1)
    s = (p[..., :-2, :-2] + p[..., :-2, 2:]
         + p[..., 2:, :-2] + p[..., 2:, 2:])
    return s * 0.25


def _avg_h(x):
    p = _pad_edge(x, 0, 1)
    return (p[..., :, :-2] + p[..., :, 2:]) * 0.5


def _avg_v(x):
    p = _pad_edge(x, 1, 0)
    return (p[..., :-2, :] + p[..., 2:, :]) * 0.5


def _avg_hv(v):
    return _avg_h(v) + _avg_v(v)


def _to_u8(bgr):
    return torch.clamp(torch.round(bgr), 0, 255).to(torch.uint8)


def demosaic_bilinear(raw, pattern: str = "rg", device=None) -> torch.Tensor:
    """Bilinear demosaic: [..., H, W] uint8 mosaic -> [..., H, W, 3] BGR."""
    if pattern not in _PATTERNS:
        raise ValueError(f"unknown Bayer pattern: {pattern}")
    raw = _on_device(raw, device)
    ry, rx = _PATTERNS[pattern]
    H, W = raw.shape[-2], raw.shape[-1]
    x = raw.to(torch.float32)

    yy = torch.arange(H, device=x.device)[:, None]
    xx = torch.arange(W, device=x.device)[None, :]
    r_mask = ((yy % 2) == ry) & ((xx % 2) == rx)
    b_mask = ((yy % 2) == 1 - ry) & ((xx % 2) == 1 - rx)
    g_mask = ~(r_mask | b_mask)

    zero = torch.zeros((), device=x.device)
    r_s = torch.where(r_mask, x, zero)
    g_s = torch.where(g_mask, x, zero)
    b_s = torch.where(b_mask, x, zero)
    floor = torch.tensor(1e-6, device=x.device)

    # sparse-aware averages: sum of neighbours / count of contributing
    # sites — implemented by averaging the indicator alongside the values.
    def sparse(avg, vals, mask):
        num = avg(vals)
        den = avg(mask.to(torch.float32))
        return num / torch.maximum(den, floor)

    red = torch.where(
        r_mask, x,
        torch.where(g_mask, sparse(_avg_hv, r_s, r_mask),
                    sparse(_avg_diag, r_s, r_mask)))
    blue = torch.where(
        b_mask, x,
        torch.where(g_mask, sparse(_avg_hv, b_s, b_mask),
                    sparse(_avg_diag, b_s, b_mask)))
    green = torch.where(g_mask, x, sparse(_avg_cross, g_s, g_mask))
    return _to_u8(torch.stack([blue, green, red], dim=-1))


def yuv422_to_bgr(yuv, device=None) -> torch.Tensor:
    """YUV422 (YUYV interleaved) [..., H, W*2] uint8 -> [..., H, W, 3] BGR.

    BT.601 full-range conversion, matching OpenCV's COLOR_YUV2BGR_YUYV
    within rounding.
    """
    yuv = _on_device(yuv, device)
    y = yuv[..., 0::2].to(torch.float32)
    u = yuv[..., 1::4].to(torch.float32) - 128.0
    v = yuv[..., 3::4].to(torch.float32) - 128.0
    # upsample chroma horizontally (each U/V covers 2 Y samples)
    u = torch.repeat_interleave(u, 2, dim=-1)[..., :y.shape[-1]]
    v = torch.repeat_interleave(v, 2, dim=-1)[..., :y.shape[-1]]
    r = y + 1.403 * v
    g = y - 0.344 * u - 0.714 * v
    b = y + 1.773 * u
    return _to_u8(torch.stack([b, g, r], dim=-1))
