"""Hough line transform: a vote accumulator on the device and
deterministic segment extraction on the host (port of
heimdall_tpu/ops/hough.py).

cv2.HoughLinesP is probabilistic (it visits edge pixels in random order and
mutates the accumulator as it goes), so the JAX package replaces it with a
deterministic design, kept here:

  1. a full (theta, rho) vote accumulator over the edge pixels, counted in
     int32 by ``index_add_`` on the edges' device (integer adds: the same
     counts in any order);
  2. 3x3 non-maximum suppression + threshold -> top-K (rho, theta) lines,
     on the host with scipy;
  3. line segments recovered by walking each line across the edge image
     and splitting on gaps (max_line_gap / min_line_length), on the host.

A vote's bin is round((x*cos + y*sin) / rho_res) in float32, formed as
XLA's CPU code for the JAX program forms it: y*sin rounded to float32,
then x*cos added to it in one fused multiply-add (one rounding), then the
division (``_fma_f32``).  cos and sin of each float32 theta are taken in
float64 and rounded to float32 on the host, so the table is the same on
every device.
"""

import math

import numpy as np
import torch


def _trig_table(theta_bins: int):
    """float32 thetas i * (pi / theta_bins) and their cos, sin."""
    thetas = (np.arange(theta_bins, dtype=np.float32)
              * np.float32(math.pi / theta_bins))
    t64 = thetas.astype(np.float64)
    return (np.cos(t64).astype(np.float32), np.sin(t64).astype(np.float32))


def _fma_f32(x: torch.Tensor, c: torch.Tensor,
             p: torch.Tensor) -> torch.Tensor:
    """float32 x*c + p with one rounding (a fused multiply-add), for float32
    tensors, in float64 on any device: x*c is exact in float64, the sum is
    taken with its exact error (two-sum), and an inexact sum is rounded to
    odd before the float32 rounding, which then rounds the exact value."""
    a = x.to(torch.float64) * c.to(torch.float64)
    b = p.to(torch.float64)
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _geometry(H: int, W: int, rho_res: float):
    diag = int(math.ceil(math.sqrt(H * H + W * W)))
    return diag, int(2 * diag / rho_res) + 1


def hough_accumulator(edges: torch.Tensor, rho_res: float = 1.0,
                      theta_bins: int = 180) -> torch.Tensor:
    """Vote accumulator [..., theta_bins, n_rho] (int32) for an edge image
    [..., H, W] (a pixel votes where it is nonzero), on its device."""
    H, W = edges.shape[-2], edges.shape[-1]
    diag, n_rho = _geometry(H, W, rho_res)
    lead = tuple(edges.shape[:-2])
    n = math.prod(lead)
    dev = edges.device
    cos_t, sin_t = (torch.tensor(t, device=dev)
                    for t in _trig_table(theta_bins))
    frame, ys, xs = torch.nonzero(edges.reshape(n, H, W) != 0,
                                  as_tuple=True)
    rho = _fma_f32(xs.to(torch.float32)[None, :], cos_t[:, None],
                   ys.to(torch.float32)[None, :] * sin_t[:, None])  # [T, E]
    rho_div = torch.full((), rho_res, dtype=torch.float32, device=dev)
    rbin = (torch.round(rho / rho_div).to(torch.int32)
            + int(diag / rho_res)).clamp(0, n_rho - 1)
    t = torch.arange(theta_bins, device=dev)[:, None]
    flat = (frame[None, :] * theta_bins + t) * n_rho + rbin
    acc = torch.zeros(n * theta_bins * n_rho, dtype=torch.int32, device=dev)
    acc.index_add_(0, flat.reshape(-1),
                   torch.ones(flat.numel(), dtype=torch.int32, device=dev))
    return acc.reshape(lead + (theta_bins, n_rho))


def hough_lines(edges, threshold: int = 100, rho_res: float = 1.0,
                theta_bins: int = 180, max_lines: int = 32, device=None):
    """Standard Hough transform -> up to max_lines (rho, theta, votes) rows.

    One image [H, W] (numpy or a tensor); the accumulator runs on
    ``device`` (the tensor's own device, or the CPU for a numpy array, when
    None).  Returns numpy arrays (rho float32[K], theta float32[K], votes
    int32[K], valid bool[K])."""
    from scipy.ndimage import maximum_filter
    H, W = edges.shape[-2], edges.shape[-1]
    diag, _ = _geometry(H, W, rho_res)
    if not isinstance(edges, torch.Tensor):
        edges = torch.from_numpy(np.ascontiguousarray(edges))
    if device is not None:
        edges = edges.to(device)
    # the host stage takes the counts as the JAX package's float32 votes
    acc = hough_accumulator(edges, rho_res, theta_bins).cpu().numpy().astype(
        np.float32)
    local_max = acc >= maximum_filter(acc, size=3, mode="constant")
    peaks = (acc >= threshold) & local_max
    t_idx, r_idx = np.nonzero(peaks)
    votes = acc[t_idx, r_idx]
    order = np.argsort(-votes)[:max_lines]
    t_idx, r_idx, votes = t_idx[order], r_idx[order], votes[order]
    rho = (r_idx - diag / rho_res) * rho_res
    theta = t_idx * (math.pi / theta_bins)
    k = len(order)
    pad = max_lines - k
    return (np.pad(rho.astype(np.float32), (0, pad)),
            np.pad(theta.astype(np.float32), (0, pad)),
            np.pad(votes.astype(np.int32), (0, pad)),
            np.pad(np.ones(k, bool), (0, pad)))


def hough_lines_p(edges, threshold: int = 100, min_line_length: float = 50,
                  max_line_gap: float = 10, rho_res: float = 1.0,
                  theta_bins: int = 180, max_lines: int = 32,
                  device=None) -> np.ndarray:
    """Deterministic stand-in for cv2.HoughLinesP.

    Returns an [N, 1, 4] int32 array of (x1, y1, x2, y2) segments (the
    shape cv2 produces), by walking each detected Hough line across the
    edge image and splitting on gaps.  The accumulator runs on ``device``
    (see hough_lines)."""
    edges_np = (edges.cpu().numpy() if isinstance(edges, torch.Tensor)
                else np.asarray(edges))
    H, W = edges_np.shape[-2:]
    rho, theta, votes, valid = hough_lines(
        edges, threshold, rho_res, theta_bins, max_lines, device)
    segments = []
    for r, t, ok in zip(rho, theta, valid):
        if not ok:
            continue
        c, s = math.cos(t), math.sin(t)
        # Walk along the line direction (-s, c) from its closest point.
        x0, y0 = c * r, s * r
        length = int(math.hypot(H, W))
        run_start, gap, last_on = None, 0, None
        for step in range(-length, length + 1):
            x = int(round(x0 - s * step))
            y = int(round(y0 + c * step))
            on = (0 <= x < W and 0 <= y < H and edges_np[y, x] > 0)
            if on:
                if run_start is None:
                    run_start = (x, y)
                last_on = (x, y)
                gap = 0
            elif run_start is not None:
                gap += 1
                if gap > max_line_gap:
                    if math.dist(run_start, last_on) >= min_line_length:
                        segments.append((*run_start, *last_on))
                    run_start, last_on, gap = None, None, 0
        if run_start is not None and last_on is not None and \
                math.dist(run_start, last_on) >= min_line_length:
            segments.append((*run_start, *last_on))
    if not segments:
        return np.empty((0, 1, 4), np.int32)
    return np.asarray(segments, np.int32).reshape(-1, 1, 4)
