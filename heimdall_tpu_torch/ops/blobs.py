"""Per-blob statistics: fixed-size blob tables from label images
(port of heimdall_tpu/ops/blobs.py).

The table is built in two steps that the fused CUDA kernel shares:

1. ``blob_sums``: the raw integer outputs of the fused kernel, in its
   layout — per-slot sums [B, 8, K] (ones, boundary, x, y, gray, b, g, r),
   the inclusive bbox [B, 4, K] (x0, y0, x1, y1), the bbox-window sums
   [B, 4, K] (gray, b, g, r) and the true blob count [B].  Slots are the
   first K roots in raster order; slots past the blob count stay zero.
   Sums are exact integer accumulations (``index_add_`` in int64).
2. ``table_from_sums``: the float formulas of the JAX package, in its
   order — Pick's-theorem area N_px - N_boundary/2 - 1, truncated pixel
   centroid, masked fg/bg means, and the intensity/shape/color scores.
"""

from typing import NamedTuple, Optional, Sequence

import torch

# Row layout of the sums output [B, 8, K].
S_ONES, S_BND, S_X, S_Y, S_GRAY, S_B, S_G, S_R = range(8)
N_SUMS = 8


class BlobTable(NamedTuple):
    """Fixed-size per-frame blob table; every field is [..., K]."""
    valid: torch.Tensor            # bool — slot holds a real blob
    area: torch.Tensor             # float32 — cv2.contourArea equivalent
    area_px: torch.Tensor          # int32 — pixel count
    cx: torch.Tensor               # int32 — centroid x (truncated)
    cy: torch.Tensor               # int32 — centroid y (truncated)
    x: torch.Tensor                # int32 — bbox left
    y: torch.Tensor                # int32 — bbox top
    w: torch.Tensor                # int32 — bbox width
    h: torch.Tensor                # int32 — bbox height
    intensity_diff: torch.Tensor   # float32 — |bg_mean - fg_mean| (gray)
    intensity_score: torch.Tensor  # float32
    shape_score: torch.Tensor      # float32
    color_score: torch.Tensor      # float32
    n_blobs: torch.Tensor          # int32 [...] — true blob count (may exceed K)


def box_sums(plane: torch.Tensor, x0, y0, x1, y1) -> torch.Tensor:
    """Sums of plane [B, H, W] over the inclusive boxes [B, K] (int64)."""
    B, H, W = plane.shape
    ii = torch.zeros((B, H + 1, W + 1), dtype=torch.int64, device=plane.device)
    ii[:, 1:, 1:] = plane.to(torch.int64).cumsum(-1).cumsum(-2)
    flat = ii.reshape(B, -1)

    def at(yy, xx):
        return flat.gather(1, yy * (W + 1) + xx)

    return at(y1 + 1, x1 + 1) - at(y0, x1 + 1) - at(y1 + 1, x0) + at(y0, x0)


def blob_sums(labels: torch.Tensor, mask: torch.Tensor, gray: torch.Tensor,
              color: Optional[Sequence[torch.Tensor]] = None,
              max_blobs: int = 64):
    """Raw per-slot integer statistics in the fused kernel's layout.

    Args:
      labels: int32 [B, H, W] from connected_components (background H*W).
      mask: bool [B, H, W] foreground (hole-filled) mask.
      gray: uint8 [B, H, W] grayscale.
      color: optional (b, g, r) uint8 planes [B, H, W]; without it the
        b/g/r rows of both sum outputs are zero.
      max_blobs: K; blobs past the first K roots are counted in n only.

    Returns (sums i32 [B, 8, K], bbox i32 [B, 4, K], bgsum i32 [B, 4, K],
    n_blobs i32 [B]).
    """
    B, H, W = mask.shape
    K = max_blobs
    HW = H * W
    lab = labels.reshape(B, HW).to(torch.int64)
    m = mask.reshape(B, HW)
    lin = torch.arange(HW, device=mask.device)
    is_root = m & (lab == lin)
    n_blobs = is_root.sum(1)
    rank = is_root.cumsum(1) - 1                      # raster rank of roots
    # a pixel takes the slot of the root its label names, and none if the
    # label names no root (a label plane need not come from labeling)
    named = lab.clamp(max=HW - 1)
    slot = torch.where(is_root.gather(1, named), rank.gather(1, named), K)
    sums, bbox = slot_sums(mask, gray, color, torch.where(m, slot, K), K)
    valid = sums[:, S_ONES] > 0
    # y0 is the root's row, as in the fused kernel (a root is its
    # component's first raster pixel in a labeling's planes)
    root_y = torch.zeros((B, K + 1), dtype=torch.int64, device=mask.device)
    root_y.scatter_(1, torch.where(is_root, rank, K).clamp(max=K),
                    (lin // W).expand(B, HW))
    bbox[:, 1] = root_y[:, :K]
    bbox = torch.where(valid[:, None], bbox, 0)
    x0, y0, x1, y1 = bbox.unbind(1)
    box_planes = [gray] + (list(color) if color is not None else [])
    bg = [torch.where(valid, box_sums(p, x0, y0, x1, y1), 0)
          for p in box_planes]
    bg += [torch.zeros_like(x0)] * (4 - len(bg))
    bgsum = torch.stack(bg, 1)
    return (sums.to(torch.int32), bbox.to(torch.int32),
            bgsum.to(torch.int32), n_blobs.to(torch.int32))


def slot_sums(mask: torch.Tensor, gray: torch.Tensor,
              color: Optional[Sequence[torch.Tensor]], slot: torch.Tensor,
              max_blobs: int, halo_top=None, halo_bot=None):
    """Per-slot integer sums of the pixels in slots 0..K-1.

    slot: int64 [B, H*W], each pixel's slot (>= K for none).  halo_top /
    halo_bot: the mask rows above and below the planes ([B, W]; None: the
    frame's edge, background), for planes that hold a shard of a frame's
    rows.  Returns (sums int64 [B, 8, K] — ones, boundary, x, y, gray, b,
    g, r, the color rows 0 without color planes; bbox int64 [B, 4, K] — x0,
    y0, x1, y1 inclusive, W, H, -1, -1 for a slot with no pixel)."""
    B, H, W = mask.shape
    K = max_blobs
    HW = H * W
    dev = mask.device
    bid = slot.clamp(max=K)                           # K: dropped bucket
    flat = (torch.arange(B, device=dev)[:, None] * (K + 1) + bid).reshape(-1)

    mp = torch.zeros((B, H + 2, W + 2), dtype=torch.int32, device=dev)
    mp[:, 1:-1, 1:-1] = mask
    if halo_top is not None:
        mp[:, 0, 1:-1] = halo_top.to(torch.bool)
    if halo_bot is not None:
        mp[:, -1, 1:-1] = halo_bot.to(torch.bool)
    nb4 = (mp[:, :-2, 1:-1] + mp[:, 2:, 1:-1]
           + mp[:, 1:-1, :-2] + mp[:, 1:-1, 2:])
    boundary = mask.to(torch.bool) & (nb4 < 4)

    lin = torch.arange(HW, device=dev)
    xs = (lin % W).expand(B, HW)
    ys = (lin // W).expand(B, HW)
    planes = [torch.ones((B, HW), dtype=torch.int64, device=dev),
              boundary.reshape(B, HW), xs, ys, gray.reshape(B, HW)]
    if color is not None:
        planes += [c.reshape(B, HW) for c in color]
    acc = torch.zeros((N_SUMS, B * (K + 1)), dtype=torch.int64, device=dev)
    for s, v in enumerate(planes):
        acc[s].index_add_(0, flat, v.reshape(-1).to(torch.int64))
    sums = acc.view(N_SUMS, B, K + 1)[:, :, :K].permute(1, 0, 2)

    def extreme(v, init, reduce):
        out = torch.full((B * (K + 1),), init, dtype=torch.int64, device=dev)
        out.scatter_reduce_(0, flat, v.reshape(-1), reduce=reduce)
        return out.view(B, K + 1)[:, :K]

    bbox = torch.stack([extreme(xs, W, "amin"), extreme(ys, H, "amin"),
                        extreme(xs, -1, "amax"), extreme(ys, -1, "amax")], 1)
    return sums.contiguous(), bbox


def table_from_sums(sums: torch.Tensor, bbox: torch.Tensor,
                    bgsum: torch.Tensor, n_blobs: torch.Tensor,
                    use_color: bool = True) -> BlobTable:
    """BlobTable from the raw per-slot sums (the formulas of
    heimdall_tpu/ops/pallas_kernels.py::pallas_blob_table, in its order).

    Divisions by constants divide by a float32 tensor on the same device:
    on CUDA a division by a Python scalar becomes a multiplication by its
    reciprocal, which can differ from the reference in the last bit.  The
    tensor is filled on the device (no host copy, so no stream sync)."""
    dev = sums.device
    thirty = torch.full((), 30.0, dtype=torch.float32, device=dev)
    area_px = sums[:, S_ONES]
    valid = area_px > 0
    safe_px = area_px.clamp(min=1)
    area = (area_px.to(torch.float32)
            - 0.5 * sums[:, S_BND].to(torch.float32) - 1.0)
    cx = torch.div(sums[:, S_X], safe_px, rounding_mode="floor")
    cy = torch.div(sums[:, S_Y], safe_px, rounding_mode="floor")

    x0 = torch.where(valid, bbox[:, 0], 0)
    y0 = torch.where(valid, bbox[:, 1], 0)
    w = torch.where(valid, bbox[:, 2] - bbox[:, 0] + 1, 0)
    h = torch.where(valid, bbox[:, 3] - bbox[:, 1] + 1, 0)

    bg_px = w * h - area_px
    safe_bg = bg_px.clamp(min=1)

    def means(fg_sum, box_sum):
        fg = torch.where(valid, fg_sum / safe_px, 127.0)
        bgm = torch.where(bg_px > 0, (box_sum - fg_sum) / safe_bg, 127.0)
        return fg, bgm

    fg_mean, bg_mean = means(sums[:, S_GRAY], bgsum[:, 0])
    intensity_diff = (bg_mean - fg_mean).abs()
    intensity_score = torch.clamp(intensity_diff / thirty, max=1.0)

    rect_area = (w * h).to(torch.float32)
    shape_score = torch.where(rect_area > 0, 1.0 - area / rect_area, 1.0)

    if use_color:
        diffs = []
        for ch, srow in ((1, S_B), (2, S_G), (3, S_R)):
            c_fg, c_bg = means(sums[:, srow], bgsum[:, ch])
            diffs.append((c_fg - c_bg).abs())
        color_diff = torch.maximum(torch.maximum(diffs[0], diffs[1]),
                                   diffs[2])
        color_score = torch.clamp(color_diff / thirty, max=1.0)
    else:
        color_score = torch.full_like(intensity_score, 0.5)

    return BlobTable(
        valid=valid, area=area, area_px=area_px, cx=cx, cy=cy,
        x=x0, y=y0, w=w, h=h,
        intensity_diff=intensity_diff, intensity_score=intensity_score,
        shape_score=shape_score, color_score=color_score, n_blobs=n_blobs)


def blob_stats(labels: torch.Tensor, mask: torch.Tensor, gray: torch.Tensor,
               color: Optional[torch.Tensor] = None, max_blobs: int = 64,
               use_color: bool = True) -> BlobTable:
    """The per-blob statistics table (fields [B, K]).

    Args:
      labels: int32 [B, H, W] from connected_components (background H*W).
      mask: bool [B, H, W] foreground mask.
      gray: uint8 [B, H, W] grayscale used for intensity stats.
      color: optional uint8 [B, H, W, 3] BGR frame for color stats.
      max_blobs: table capacity K; blobs beyond K are dropped (counted in
        n_blobs so callers can detect overflow).
      use_color: when False (or color is None) color_score is the neutral
        0.5 of the reference.
    """
    with_color = use_color and color is not None
    planes = ([color[..., c] for c in range(3)] if with_color else None)
    raw = blob_sums(labels, mask, gray, planes, max_blobs)
    return table_from_sums(*raw, use_color=with_color)


def confidence_python(table: BlobTable) -> torch.Tensor:
    """The reference Python confidence blend: 0.5*intensity + 0.2*shape +
    0.3*color."""
    return (0.5 * table.intensity_score + 0.2 * table.shape_score
            + 0.3 * table.color_score)


def confidence_native(table: BlobTable) -> torch.Tensor:
    """The reference native-path blend: 0.7*intensity + 0.3*shape."""
    return 0.7 * table.intensity_score + 0.3 * table.shape_score
