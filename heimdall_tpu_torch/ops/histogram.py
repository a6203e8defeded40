"""Histogram equalization and CLAHE with OpenCV parity (port of
heimdall_tpu/ops/histogram.py).

Both are built on batched 256-bin integer histograms
(ops/threshold.py::histogram256).  equalizeHist replicates OpenCV's LUT
construction (skip-first-nonzero-bin scaling, round half to even).  CLAHE
replicates OpenCV's tiling (reflect-101 extension to a multiple of the
grid), histogram clipping with uniform and stepped residual
redistribution, and bilinear LUT interpolation.  Prefix sums of counts are
integer cumsums (exact), cast to float32 where the JAX package sums in
float32: every partial sum there is an integer below 2^24, so exact too.
"""

import numpy as np
import torch

from heimdall_tpu_torch.ops.threshold import histogram256


def _apply_lut(image: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Apply per-image LUTs: image [..., H, W] uint8, lut [..., 256]."""
    flat = image.reshape(image.shape[:-2] + (-1,)).to(torch.int64)
    out = torch.gather(lut, -1, flat)
    return out.reshape(image.shape).to(torch.uint8)


def equalize_hist(image: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist parity (batched over leading dims)."""
    hist = histogram256(image).to(torch.int64)
    total = image.shape[-1] * image.shape[-2]
    idx = torch.arange(256, device=image.device)
    present = (hist > 0).to(torch.int32)
    first = present.argmax(dim=-1, keepdim=True)      # first non-zero bin
    h_first = torch.gather(hist, -1, first)
    scale = 255.0 / (total - h_first).clamp(min=1).to(torch.float32)
    csum = hist.cumsum(-1)
    c_first = torch.gather(csum, -1, first)
    part = (csum - c_first).to(torch.float32)
    lut = torch.round(part * scale).clamp(0, 255).to(torch.int64)
    lut = torch.where(idx <= first, 0, lut)
    # Degenerate constant image: cv2 returns the image unchanged.
    lut = torch.where(h_first == total, idx, lut)
    return _apply_lut(image, lut)


def _reflect101_extend(image: torch.Tensor, pad_bottom: int,
                       pad_right: int) -> torch.Tensor:
    """Extend bottom/right with BORDER_REFLECT_101, allowing pads that
    exceed the source size (cv2's copyMakeBorder keeps bouncing)."""
    def tri(n, padded):
        j = torch.arange(padded, device=image.device)
        if n == 1:
            return torch.zeros_like(j)
        period = 2 * (n - 1)
        j = j % period
        return torch.where(j >= n, period - j, j)

    H, W = image.shape[-2], image.shape[-1]
    out = image
    if pad_bottom:
        out = out.index_select(-2, tri(H, H + pad_bottom))
    if pad_right:
        out = out.index_select(-1, tri(W, W + pad_right))
    return out


def clahe(image: torch.Tensor, clip_limit: float = 2.0,
          tile_grid: int = 8) -> torch.Tensor:
    """cv2.createCLAHE(clipLimit, (tile_grid, tile_grid)).apply parity.

    OpenCV's padding quirk is kept: when either dimension is not a multiple
    of the grid, both are reflect-101 extended by G - (dim % G).  Per-tile
    clipped histograms build per-tile LUTs, and each output pixel
    bilinearly interpolates the 4 surrounding tile LUTs with OpenCV's
    ``x * (1/tileW) - 0.5`` convention (a float32 reciprocal multiply).
    """
    H, W = image.shape[-2], image.shape[-1]
    G = tile_grid
    if H % G == 0 and W % G == 0:
        img = image
    else:
        img = _reflect101_extend(image, G - (H % G), G - (W % G))
    Hp, Wp = img.shape[-2], img.shape[-1]
    th, tw = Hp // G, Wp // G
    dev = image.device

    batch = tuple(img.shape[:-2])
    tiles = img.reshape(batch + (G, th, G, tw)).transpose(-3, -2)
    hist = histogram256(tiles).to(torch.float32)       # [..., G, G, 256]

    tile_area = th * tw
    if clip_limit > 0:
        limit = max(int(clip_limit * tile_area / 256), 1)
        clipped = hist.clamp(max=limit)
        excess = (hist - clipped).sum(dim=-1, keepdim=True)
        redist = torch.floor(excess / 256.0)
        residual = excess - redist * 256.0
        # OpenCV distributes the residual to every step-th bin.
        step = torch.floor(256.0 / residual.clamp(min=1.0)).clamp(min=1.0)
        idx = torch.arange(256, device=dev, dtype=torch.float32)
        gets_one = ((torch.div(idx, step, rounding_mode="floor") * step
                     == idx) & (idx < residual * step))
        hist = clipped + redist + gets_one.to(torch.float32)

    scale = float(np.float32(255.0 / tile_area))
    csum = hist.to(torch.int64).cumsum(-1).to(torch.float32)
    luts = torch.round(csum * scale).clamp(0, 255)

    ys = torch.arange(Hp, device=dev, dtype=torch.float32)
    xs = torch.arange(Wp, device=dev, dtype=torch.float32)
    ty = ys * float(np.float32(1.0 / th)) - 0.5
    tx = xs * float(np.float32(1.0 / tw)) - 0.5
    yf = torch.floor(ty)
    xf = torch.floor(tx)
    fy = (ty - yf)[:, None]                               # [Hp, 1]
    fx = (tx - xf)[None, :]                               # [1, Wp]
    y0 = yf.clamp(0, G - 1).to(torch.int64)
    x0 = xf.clamp(0, G - 1).to(torch.int64)
    y1 = (yf + 1).clamp(0, G - 1).to(torch.int64)
    x1 = (xf + 1).clamp(0, G - 1).to(torch.int64)

    pix = img.to(torch.int64)                             # [..., Hp, Wp]
    n = int(np.prod(batch)) if batch else 1
    src = luts.reshape(n, G * G * 256)
    pix_flat = pix.reshape(n, Hp * Wp)

    def sample(gy, gx):
        tile_idx = (gy[:, None] * G + gx[None, :]).reshape(1, -1)
        got = torch.gather(src, 1, tile_idx * 256 + pix_flat)
        return got.reshape(pix.shape)

    v00 = sample(y0, x0)
    v01 = sample(y0, x1)
    v10 = sample(y1, x0)
    v11 = sample(y1, x1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    out = torch.round(out).clamp(0, 255).to(torch.uint8)
    return out[..., :H, :W]
