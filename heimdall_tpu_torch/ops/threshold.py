"""Global and adaptive thresholding with OpenCV parity (port of
heimdall_tpu/ops/threshold.py).

Fixed thresholds compare ``src > round(thresh)`` as cv2 does on uint8.
Otsu and Triangle pick cv2's threshold from a 256-bin histogram per image.
The adaptive means are cv2 5.x's: the Gaussian-C mean a float separable
convolution with BORDER_REPLICATE rounded half to even, the mean-C one a
box sum rounded half up (ops/filters.py).  OpenCV rounds the offset C with
cvFloor for THRESH_BINARY_INV and cvCeil for THRESH_BINARY.

Histograms are integer counts (``index_add_``); their prefix sums are
exact integer cumsums cast to float32, the same on every device.
"""

import math

import numpy as np
import torch

from heimdall_tpu_torch.ops.filters import box_mean_u8, gaussian_mean_u8

# cv2 threshold type names (the string API of the reference's config).
THRESH_BINARY = "binary"
THRESH_BINARY_INV = "binary_inv"
THRESH_TRUNC = "trunc"
THRESH_TOZERO = "tozero"
THRESH_TOZERO_INV = "tozero_inv"


def threshold(image: torch.Tensor, thresh: float, max_value: float = 255,
              method: str = THRESH_BINARY) -> torch.Tensor:
    """cv2.threshold parity on uint8 input (fixed threshold types).

    cv2 rounds the threshold with cvRound and compares ``src > thresh``."""
    x = image.to(torch.int32)
    ti = int(np.rint(np.float32(thresh)))
    mv = int(np.clip(np.rint(np.float32(max_value)), 0, 255))
    above = x > ti
    if method == THRESH_BINARY:
        out = torch.where(above, mv, 0)
    elif method == THRESH_BINARY_INV:
        out = torch.where(above, 0, mv)
    elif method == THRESH_TRUNC:
        out = torch.where(above, ti, x)
    elif method == THRESH_TOZERO:
        out = torch.where(above, x, 0)
    elif method == THRESH_TOZERO_INV:
        out = torch.where(above, 0, x)
    else:
        raise ValueError(f"unknown threshold method: {method}")
    return out.to(torch.uint8)


def histogram256(image: torch.Tensor) -> torch.Tensor:
    """256-bin histogram over the last two dims -> [..., 256] int32."""
    lead = image.shape[:-2]
    n = math.prod(lead)
    flat = image.reshape(n, -1).to(torch.int64)
    idx = (torch.arange(n, device=image.device)[:, None] * 256 + flat)
    hist = torch.zeros(n * 256, dtype=torch.int32, device=image.device)
    hist.index_add_(0, idx.reshape(-1),
                    torch.ones(idx.numel(), dtype=torch.int32,
                               device=image.device))
    return hist.reshape(lead + (256,))


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last dim (int64)."""
    top = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(x == top, idx, x.shape[-1]).min(dim=-1).values


def otsu_threshold(image: torch.Tensor) -> torch.Tensor:
    """Otsu threshold (per image) following cv2: the first t in [0, 256)
    maximizing q1*q2*(mu1-mu2)^2; int32 [...]."""
    hist_i = histogram256(image).to(torch.int64)
    hist = hist_i.to(torch.float32)
    total = hist.sum(dim=-1, keepdim=True)
    i = torch.arange(256, device=image.device)
    omega = hist_i.cumsum(-1).to(torch.float32) / total
    mu_t = (hist_i * i).cumsum(-1).to(torch.float32) / total
    mu = mu_t[..., -1:]
    denom = omega * (1.0 - omega)
    num = (mu * omega - mu_t) ** 2
    eps = torch.finfo(torch.float32).eps
    sigma = torch.where(denom > eps, num / denom, -1.0)
    return _argmax_first(sigma).to(torch.int32)


def triangle_threshold(image: torch.Tensor) -> torch.Tensor:
    """Triangle method threshold following cv2 (thresh.cpp): widen the
    occupied range by a bin each side, flip when the short tail is on the
    left, take the first maximum of max_val*i + (left_bound - max_ind)*h[i]
    from left_bound+1 to the peak, minus one (un-flipped); int32 [...]."""
    hist = histogram256(image)
    idx = torch.arange(256, device=image.device, dtype=torch.int32)
    present = hist > 0
    first = _argmax_first(present.to(torch.int32)).to(torch.int32)
    last = 255 - _argmax_first(present.flip(-1).to(torch.int32)).to(
        torch.int32)
    left_bound = (first - 1).clamp(min=0)
    right_bound = (last + 1).clamp(max=255)
    max_val = hist.max(dim=-1).values
    max_ind = _argmax_first(hist).to(torch.int32)

    flip = (max_ind - left_bound) < (right_bound - max_ind)
    h_used = torch.where(flip[..., None], hist.flip(-1), hist)
    lb = torch.where(flip, 255 - right_bound, left_bound)
    mi = torch.where(flip, 255 - max_ind, max_ind)

    a = max_val[..., None].to(torch.float32)
    b = (lb - mi)[..., None].to(torch.float32)
    tempdist = a * idx.to(torch.float32) + b * h_used.to(torch.float32)
    in_range = (idx > lb[..., None]) & (idx <= mi[..., None])
    masked = torch.where(in_range & (tempdist > 0), tempdist, -1.0)
    best = _argmax_first(masked).to(torch.int32)
    any_pos = masked.max(dim=-1).values > 0
    thresh = torch.where(any_pos, best, lb) - 1
    thresh = torch.where(flip, 255 - thresh, thresh)
    return thresh.to(torch.int32)


def threshold_auto(image: torch.Tensor, max_value: float = 255,
                   method: str = THRESH_BINARY, auto: str = "otsu"):
    """cv2.threshold with THRESH_OTSU / THRESH_TRIANGLE: (t, image)."""
    if auto == "otsu":
        t = otsu_threshold(image)
    elif auto == "triangle":
        t = triangle_threshold(image)
    else:
        raise ValueError(auto)
    x = image.to(torch.int32)
    mv = int(max_value)
    above = x > t[..., None, None]
    if method == THRESH_BINARY:
        out = torch.where(above, mv, 0)
    elif method == THRESH_BINARY_INV:
        out = torch.where(above, 0, mv)
    else:
        raise ValueError(
            f"auto threshold supports binary/binary_inv, got {method}")
    return t, out.to(torch.uint8)


def adaptive_threshold(image: torch.Tensor, max_value: float = 255,
                       adaptive_method: str = "gaussian",
                       threshold_type: str = THRESH_BINARY,
                       block_size: int = 11, c=2.0) -> torch.Tensor:
    """cv2.adaptiveThreshold parity on uint8 [..., H, W]: the Gaussian-C
    ("gaussian") or mean-C ("mean") local mean.

    ``c`` is rounded as cv2 does: ceil for BINARY, floor for BINARY_INV.
    """
    if adaptive_method == "gaussian":
        mean = gaussian_mean_u8(image, block_size, 0.0, border="replicate")
    elif adaptive_method == "mean":
        mean = box_mean_u8(image, block_size, border="replicate")
    else:
        raise ValueError(f"unknown adaptive method: {adaptive_method}")
    ci = math.ceil(c) if threshold_type == THRESH_BINARY else math.floor(c)
    x = image.to(torch.int32)
    if threshold_type == THRESH_BINARY:
        hit = x > mean - ci
    elif threshold_type == THRESH_BINARY_INV:
        hit = x <= mean - ci
    else:
        raise ValueError("adaptiveThreshold supports binary/binary_inv")
    mv = int(max_value)
    return torch.where(hit, mv, 0).to(torch.uint8)
