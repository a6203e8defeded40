"""Smoothing and gradient filters with OpenCV numeric parity (port of
heimdall_tpu/ops/filters.py).

OpenCV's uint8 Gaussian path quantizes the float64 kernel to Q8 fixed point
by cumulative (error-diffusion) rounding (``_q8_taps_bitexact``), runs the
separable convolution in int32 and descales with ``(acc + 2**15) >> 16``.
The inner mean of cv2.adaptiveThreshold is instead a float separable
convolution rounded half to even (``gaussian_mean_u8``).

All ops take [..., H, W] (or [..., H, W, C] for the blur, filtered per
channel) tensors with any leading batch dims.  Borders are built from
clamped or reflected index tensors, which work for every dtype.
"""

import math

import numpy as np
import torch

# cv2's hard-coded "bit-exact" small Gaussian kernels for sigma <= 0.
_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """Replicates cv2.getGaussianKernel (float64, host-side)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].copy()
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    scale2x = -0.5 / (sigma * sigma)
    c = (ksize - 1) * 0.5
    k = np.array([math.exp((i - c) * (i - c) * scale2x) for i in range(ksize)],
                 dtype=np.float64)
    return k / k.sum()


def _q8_taps(kernel: np.ndarray) -> list:
    """Quantize a normalized kernel to Q8 with centre-tap sum correction
    (equal to ``_q8_taps_bitexact`` for ksize <= 11)."""
    ik = np.round(kernel * 256).astype(np.int64)
    ik[len(ik) // 2] += 256 - ik.sum()
    return [int(t) for t in ik]


def _q8_taps_bitexact(kernel: np.ndarray) -> list:
    """Quantize a normalized kernel to Q8 by cumulative rounding.

    cv2 5.x quantizes computed Gaussian kernels by error diffusion:
    tap i = rint(cumsum(k*256))[i] - rint(cumsum(k*256))[i-1]; the taps
    sum to exactly 256 and need not be monotone."""
    cs = np.rint(np.cumsum(kernel * 256.0))
    return [int(t) for t in np.diff(np.concatenate([[0.0], cs]))]


def f32_taps(ksize: int, sigma: float = 0.0) -> list:
    """The float taps of the adaptive mean: float32(float64 tap), as Python
    floats (exactly representable in float32)."""
    return [float(np.float32(t)) for t in gaussian_kernel_1d(ksize, sigma)]


def border_index(n: int, r: int, border: str, device) -> torch.Tensor:
    """Source indices of a length-n axis padded by r on both sides."""
    idx = torch.arange(-r, n + r, device=device)
    if border == "reflect101":
        idx = idx.abs()
        return torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    if border == "replicate":
        return idx.clamp(0, n - 1)
    raise ValueError(f"unknown border: {border}")


def _pad2d(x: torch.Tensor, r_h: int, r_w: int, border: str,
           value=0) -> torch.Tensor:
    """Pad the last two dims by (r_h, r_w): cv2's BORDER_REFLECT_101
    ("reflect101"), BORDER_REPLICATE ("replicate") or a constant."""
    H, W = x.shape[-2], x.shape[-1]
    if border == "constant":
        out = torch.full(x.shape[:-2] + (H + 2 * r_h, W + 2 * r_w), value,
                         dtype=x.dtype, device=x.device)
        out[..., r_h:r_h + H, r_w:r_w + W] = x
        return out
    x = x.index_select(-2, border_index(H, r_h, border, x.device))
    return x.index_select(-1, border_index(W, r_w, border, x.device))


def _sep_conv_i32(x: torch.Tensor, taps_h, taps_w, border: str) -> torch.Tensor:
    """Separable integer correlation over the last two dims.

    x must be int32 [..., H, W]; returns the raw int32 accumulator
    (scaled by sum(taps_h) * sum(taps_w))."""
    rh, rw = len(taps_h) // 2, len(taps_w) // 2
    H, W = x.shape[-2], x.shape[-1]
    xp = _pad2d(x, rh, rw, border)
    tmp = taps_w[0] * xp[..., 0:W]
    for i in range(1, len(taps_w)):
        tmp = tmp + taps_w[i] * xp[..., i:i + W]
    out = taps_h[0] * tmp[..., 0:H, :]
    for i in range(1, len(taps_h)):
        out = out + taps_h[i] * tmp[..., i:i + H, :]
    return out


def _sep_conv_f32(x: torch.Tensor, taps, border: str) -> torch.Tensor:
    """Separable float32 correlation, columns (W) first, then rows (H).

    Each output is k0*x0 + k1*x1 + ... summed strictly in sequence over the
    un-rounded float32 intermediate, one multiply and one add per tap as
    separate operations (never a fused multiply-add, never a convolution
    library call): the order of heimdall_tpu's mean and of the CUDA kernel,
    where any other rounding can flip a threshold decision."""
    r = len(taps) // 2
    H, W = x.shape[-2], x.shape[-1]
    xp = _pad2d(x, r, r, border)
    tmp = taps[0] * xp[..., 0:W]
    for i in range(1, len(taps)):
        tmp = tmp + taps[i] * xp[..., i:i + W]
    out = taps[0] * tmp[..., 0:H, :]
    for i in range(1, len(taps)):
        out = out + taps[i] * tmp[..., i:i + H, :]
    return out


def _filter_channels(image: torch.Tensor, fn):
    """Apply a [..., H, W] filter to gray or channel-last color input."""
    if image.dim() >= 3 and image.shape[-1] in (1, 3, 4):
        return torch.movedim(fn(torch.movedim(image, -1, 0)), 0, -1)
    return fn(image)


def gaussian_blur(image: torch.Tensor, ksize: int, sigma: float = 0.0,
                  border: str = "reflect101") -> torch.Tensor:
    """cv2.GaussianBlur parity for uint8 input (square kernel): cv2's Q8
    fixed-point path."""
    if image.dtype != torch.uint8:
        raise ValueError(f"gaussian_blur takes uint8, got {image.dtype}")
    taps = _q8_taps_bitexact(gaussian_kernel_1d(ksize, sigma))

    def run(x):
        acc = _sep_conv_i32(x.to(torch.int32), taps, taps, border)
        return ((acc + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)

    return _filter_channels(image, run)


def gaussian_mean_u8(image: torch.Tensor, ksize: int, sigma: float = 0.0,
                     border: str = "replicate") -> torch.Tensor:
    """Local Gaussian-weighted mean as int32 (the inner mean of
    cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C)): a float32
    separable convolution with replicate border, rounded half to even."""
    mf = _sep_conv_f32(image.to(torch.float32), f32_taps(ksize, sigma),
                       border)
    return torch.round(mf).to(torch.int32)


def box_blur(image: torch.Tensor, ksize: int, border: str = "reflect101",
             normalize: bool = True) -> torch.Tensor:
    """cv2.blur / cv2.boxFilter parity on uint8 input: the int32 window sum,
    or with ``normalize`` the mean rounded half up (ksize odd: no ties)."""
    if image.dtype != torch.uint8:
        raise ValueError(f"box_blur takes uint8, got {image.dtype}")
    ones = [1] * ksize

    def run(x):
        acc = _sep_conv_i32(x.to(torch.int32), ones, ones, border)
        if not normalize:
            return acc
        n2 = ksize * ksize
        return torch.div(acc + n2 // 2, n2, rounding_mode="floor").clamp(
            0, 255).to(torch.uint8)

    return _filter_channels(image, run)


def box_mean_u8(image: torch.Tensor, ksize: int,
                border: str = "replicate") -> torch.Tensor:
    """Local box mean as int32 in [0, 255] (the inner mean of
    cv2.adaptiveThreshold(ADAPTIVE_THRESH_MEAN_C)), rounded half up."""
    ones = [1] * ksize
    acc = _sep_conv_i32(image.to(torch.int32), ones, ones, border)
    n2 = ksize * ksize
    return torch.div(acc + n2 // 2, n2, rounding_mode="floor").clamp(0, 255)


def sobel(image: torch.Tensor, dx: int, dy: int,
          border: str = "replicate") -> torch.Tensor:
    """3x3 Sobel derivative, int32 output (cv2.Sobel CV_16S semantics)."""
    smooth = [1, 2, 1]
    deriv = [-1, 0, 1]
    x = image.to(torch.int32)
    if dx == 1 and dy == 0:
        return _sep_conv_i32(x, smooth, deriv, border)
    if dx == 0 and dy == 1:
        return _sep_conv_i32(x, deriv, smooth, border)
    raise ValueError("sobel supports (dx,dy) in {(1,0),(0,1)}")


# tan(22.5 deg) in Q15 — the constant OpenCV's Canny NMS uses.
_TG22 = 13573
# Hysteresis rounds run between two convergence checks (each check is one
# host sync).  A round at the fixpoint changes nothing, so running past it
# leaves the output identical to a check after every round.
HYSTERESIS_CHECK_EVERY = 16


def _shift(a: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """a[..., i + di, j + dj], zero (False) outside the frame."""
    H, W = a.shape[-2], a.shape[-1]
    p = _pad2d(a, 1, 1, "constant", 0)
    return p[..., 1 + di:1 + di + H, 1 + dj:1 + dj + W]


def _dilate8(a: torch.Tensor) -> torch.Tensor:
    """3x3 binary dilation of a bool plane (outside the frame is False)."""
    H, W = a.shape[-2], a.shape[-1]
    p = _pad2d(a, 1, 1, "constant", False)
    rows = p[..., 0:W] | p[..., 1:W + 1] | p[..., 2:W + 2]
    return rows[..., 0:H, :] | rows[..., 1:H + 1, :] | rows[..., 2:H + 2, :]


def canny(image: torch.Tensor, threshold1: float, threshold2: float,
          aperture_size: int = 3, l2_gradient: bool = False,
          max_hysteresis_iters: int = 64) -> torch.Tensor:
    """Canny edge detection following OpenCV's algorithm (uint8 0/255).

    3x3 Sobel (replicate border), L1 or L2 magnitude, OpenCV's integer
    sector logic for non-maximum suppression with its tie-breaking (> / >=
    on the horizontal and vertical sectors, strict > on both diagonal
    neighbours), and hysteresis by growing the strong edges through the
    weak candidates to the fixpoint.  The growth runs on the tensors'
    device and asks the host whether it has converged once every
    HYSTERESIS_CHECK_EVERY rounds.  ``max_hysteresis_iters`` is accepted
    for the JAX signature; like the JAX loop, the growth always reaches
    the fixpoint."""
    del max_hysteresis_iters
    if aperture_size != 3:
        raise NotImplementedError("only aperture_size=3 is supported")
    low, high = min(threshold1, threshold2), max(threshold1, threshold2)
    gx = sobel(image, 1, 0)
    gy = sobel(image, 0, 1)
    if l2_gradient:
        m = gx * gx + gy * gy
        # cv2: clamp to 32767, square only positive thresholds, then floor
        low, high = min(32767.0, low), min(32767.0, high)
        low = low * low if low > 0 else low
        high = high * high if high > 0 else high
    else:
        m = gx.abs() + gy.abs()
    low, high = int(math.floor(low)), int(math.floor(high))

    # All products fit in int32: |sobel| <= 1020, 1020 * tan-constants < 2^31.
    xs = gx.abs()
    ys_15 = gy.abs() << 15
    tg22x = xs * _TG22
    tg67x = tg22x + (xs << 16)
    horiz = ys_15 < tg22x
    vert = ys_15 > tg67x
    same_sign = (gx ^ gy) >= 0     # gradient in the main diagonal direction

    keep_h = (m > _shift(m, 0, -1)) & (m >= _shift(m, 0, 1))
    keep_v = (m > _shift(m, -1, 0)) & (m >= _shift(m, 1, 0))
    keep_d1 = (m > _shift(m, -1, -1)) & (m > _shift(m, 1, 1))   # "\"
    keep_d2 = (m > _shift(m, -1, 1)) & (m > _shift(m, 1, -1))   # "/"
    keep = torch.where(horiz, keep_h, torch.where(
        vert, keep_v, torch.where(same_sign, keep_d1, keep_d2)))

    cand = keep & (m > low)
    edges = cand & (m > high)
    while True:
        for _ in range(HYSTERESIS_CHECK_EVERY):
            prev = edges
            edges = edges | (_dilate8(edges) & cand)
        if torch.equal(edges, prev):
            break
    return torch.where(edges, 255, 0).to(torch.uint8)
