"""Per-blob statistics of the band-tiled route (counterpart of
heimdall_tpu/ops/stats_tiled.py).

``blob_stats_tiled`` gives the BlobTable of ops/blobs.py's ``blob_stats``
from the outputs of ops/ccl_tiled.py (labels, root table, root count and
per-band slot incidence), through two wrappers that launch the hand-written
kernels of ``csrc/stats_tiled.cu`` on CUDA tensors (raising if they cannot)
and run their plain PyTorch versions on CPU tensors:

* ``banded_stats`` (TPU kernel B4a): per-slot sums [B, 8, K] (ones,
  boundary, x, y, gray, b, g, r; the color rows stay 0 without color) and
  the inclusive bbox [B, 4, K] (x0, y0, x1, y1; unused slots W, H, -1, -1);
* ``bbox_sums`` (B4b): per-slot sums of gray (and b, g, r) over the bbox
  window [B, 4, K], visiting the (slot, band) pairs of the incidence lists
  (one launch that writes every output: no zero fill before it).

On a shard of a frame's rows (parallel/tiled_sp.py), ``banded_stats_sp``
(B4a on a shard) launches the banded stats with the labels in the frame's
indices and the boundary across the shard's cut rows taken from the
neighbouring shards' mask rows; B4b runs as it is, on bboxes given in the
shard's rows.

The table itself comes from ops/blobs.py's ``table_from_sums``.  Sums are
int32, as in the JAX package: ``check_sum_bound`` refuses frames whose
whole-frame X-sum could wrap.  Each wrapper counts launches in
``.launches``.
"""

import torch

from heimdall_tpu_torch.ops.blobs import (BlobTable, N_SUMS, box_sums,
                                          slot_sums, table_from_sums)
from heimdall_tpu_torch.ops._launch import check_cuda, raise_on, stream
from heimdall_tpu_torch.ops.ccl_tiled import (MAX_SLOTS,
                                              connected_components_tiled,
                                              label_slots)


def check_sum_bound(H: int, W: int):
    """Raise ValueError when the X-sum of a whole-frame blob, H * W(W-1)/2,
    does not fit int32 (about 2.2 MP; 1920x1080 gives 2.0e9)."""
    if H * (W * (W - 1) // 2) >= 2**31:
        raise ValueError(f"frame {H}x{W} exceeds the int32 sum bound of the "
                         "blob statistics (H * W*(W-1)/2 < 2**31)")


def color_layout(color, channel_major: bool, B: int, H: int, W: int):
    """(C, frame stride, channel stride, pixel stride) of the color frames:
    [B, H, W, 3], or [B, 3, H, W] with channel_major; C = 1 without."""
    if color is None:
        return 1, 0, 0, 0
    want = (B, 3, H, W) if channel_major else (B, H, W, 3)
    if tuple(color.shape) != want or color.dtype != torch.uint8:
        raise ValueError(f"color must be uint8 {want}, got "
                         f"{color.dtype} {tuple(color.shape)}")
    if channel_major:
        return 3, 3 * H * W, H * W, 1
    return 3, 3 * H * W, 1, 3


def _color_planes(color, channel_major: bool):
    if color is None:
        return []
    if channel_major:
        return [color[:, c] for c in range(3)]
    return [color[..., c] for c in range(3)]


def banded_stats_reference(labels, mask, gray, color, root_table, root_count,
                           max_blobs: int = 64, channel_major: bool = False):
    """Plain PyTorch version of hd_banded_stats: (sums int32 [B, 8, K],
    bbox int32 [B, 4, K])."""
    K = max_blobs
    slot = label_slots(labels, root_table[:, :K], root_count)
    sums, bbox = slot_sums(mask, gray, _color_planes(color, channel_major),
                           slot, K)
    return sums.to(torch.int32), bbox.to(torch.int32)


def banded_stats(labels, mask, gray, color, root_table, root_count,
                 max_blobs: int = 64, channel_major: bool = False):
    """Per-slot sums and bbox (see banded_stats_reference).  labels int32
    [B, H, W] (background H*W), mask bool/uint8 [B, H, W], gray uint8
    [B, H, W], color None or uint8 frames, root_table int32 [B, >=K]
    (ascending, padded with H*W), root_count int32 [B]."""
    B, H, W = labels.shape
    K = max_blobs
    if labels.device.type == "cpu":
        return banded_stats_reference(labels, mask, gray, color, root_table,
                                      root_count, K, channel_major)
    from heimdall_tpu_torch.ops import _cuda

    if not 1 <= K <= MAX_SLOTS:
        raise ValueError(f"max_blobs must be in 1..{MAX_SLOTS}, got {K}")
    C, fs, cs, ps = color_layout(color, channel_major, B, H, W)
    check_cuda(labels, "labels", (torch.int32,))
    check_cuda(mask, "mask", (torch.bool, torch.uint8), (B, H, W))
    check_cuda(gray, "gray", (torch.uint8,), (B, H, W))
    if color is not None:
        check_cuda(color, "color", (torch.uint8,))
    rl = root_table[:, :K].contiguous()
    check_cuda(rl, "root_table", (torch.int32,), (B, K))
    check_cuda(root_count, "root_count", (torch.int32,), (B,))
    dev = labels.device
    sums = torch.empty((B, N_SUMS, K), dtype=torch.int32, device=dev)
    bbox = torch.empty((B, 4, K), dtype=torch.int32, device=dev)
    raise_on(_cuda.library("stats_tiled").hd_banded_stats(
        0 if color is None else color.data_ptr(), C, fs, cs, ps, B, H, W, K,
        mask.data_ptr(), labels.data_ptr(), rl.data_ptr(),
        root_count.data_ptr(), gray.data_ptr(), sums.data_ptr(),
        bbox.data_ptr(), stream(labels)), "banded_stats")
    banded_stats.launches += 1
    return sums, bbox


banded_stats.launches = 0


def banded_stats_sp_reference(labels, mask, gray, color, root_table,
                              root_count, max_blobs: int = 64,
                              halo_top=None, halo_bot=None,
                              channel_major: bool = False):
    """Plain PyTorch version of hd_banded_stats_sp: (sums int32 [B, 8, K],
    bbox int32 [B, 4, K]) of a shard, in its rows."""
    K = max_blobs
    slot = label_slots(labels, root_table[:, :K], root_count)
    sums, bbox = slot_sums(mask, gray, _color_planes(color, channel_major),
                           slot, K, halo_top, halo_bot)
    return sums.to(torch.int32), bbox.to(torch.int32)


def banded_stats_sp(labels, mask, gray, color, root_table, root_count,
                    sentinel: int, max_blobs: int = 64, halo_top=None,
                    halo_bot=None, channel_major: bool = False):
    """banded_stats on a shard [B, Hl, W] of frames: labels and
    root_table in the frame's indices (background sentinel), halo_top /
    halo_bot uint8 [B, W] the mask rows across the shard's first and last
    row (None at the frame's edge).  Sums and bbox in the shard's rows
    (unused slots W, Hl, -1, -1)."""
    B, H, W = labels.shape
    K = max_blobs
    if labels.device.type == "cpu":
        return banded_stats_sp_reference(labels, mask, gray, color,
                                         root_table, root_count, K,
                                         halo_top, halo_bot, channel_major)
    from heimdall_tpu_torch.ops import _cuda

    if not 1 <= K <= MAX_SLOTS:
        raise ValueError(f"max_blobs must be in 1..{MAX_SLOTS}, got {K}")
    C, fs, cs, ps = color_layout(color, channel_major, B, H, W)
    check_cuda(labels, "labels", (torch.int32,))
    check_cuda(mask, "mask", (torch.bool, torch.uint8), (B, H, W))
    check_cuda(gray, "gray", (torch.uint8,), (B, H, W))
    if color is not None:
        check_cuda(color, "color", (torch.uint8,))
    for h in (halo_top, halo_bot):
        if h is not None:
            check_cuda(h, "halo", (torch.uint8,), (B, W))
    rl = root_table[:, :K].contiguous()
    check_cuda(rl, "root_table", (torch.int32,), (B, K))
    check_cuda(root_count, "root_count", (torch.int32,), (B,))
    dev = labels.device
    sums = torch.empty((B, N_SUMS, K), dtype=torch.int32, device=dev)
    bbox = torch.empty((B, 4, K), dtype=torch.int32, device=dev)
    raise_on(_cuda.library("stats_tiled").hd_banded_stats_sp(
        0 if color is None else color.data_ptr(), C, fs, cs, ps, B, H, W, K,
        sentinel, mask.data_ptr(), labels.data_ptr(), rl.data_ptr(),
        root_count.data_ptr(), gray.data_ptr(),
        None if halo_top is None else halo_top.data_ptr(),
        None if halo_bot is None else halo_bot.data_ptr(), sums.data_ptr(),
        bbox.data_ptr(), stream(labels)), "banded_stats_sp")
    banded_stats_sp.launches += 1
    return sums, bbox


banded_stats_sp.launches = 0


def bbox_sums_reference(bbox, slot_list, slot_count, band: int, gray,
                        color=None, channel_major: bool = False):
    """Plain PyTorch version of hd_bbox_sums: int32 [B, 4, K], the sums
    over each listed (slot, band) pair of the slot's bbox window within the
    band's rows, added over the bands."""
    B, H, W = gray.shape
    K = bbox.shape[-1]
    R = slot_list.shape[1]
    dev = gray.device
    t = torch.arange(K, device=dev)
    listed = t < slot_count.to(torch.int64)[..., None]          # [B, R, K]
    present = torch.zeros((B, R, K + 1), dtype=torch.bool, device=dev)
    present.scatter_(2, torch.where(listed, slot_list.to(torch.int64), K),
                     listed)
    present = present[..., :K]
    bb = bbox.to(torch.int64)
    x0, x1 = bb[:, None, 0], bb[:, None, 2]                    # [B, 1, K]
    top = torch.arange(R, device=dev)[None, :, None] * band    # [1, R, 1]
    y0 = torch.maximum(bb[:, None, 1], top)
    y1 = torch.minimum(bb[:, None, 3], (top + band).clamp(max=H) - 1)
    ok = present & (y0 <= y1) & (x0 <= x1)
    boxes = [torch.where(ok, v, 0).reshape(B, R * K)
             for v in (x0, y0, x1, y1)]
    out = torch.zeros((B, 4, K), dtype=torch.int64, device=dev)
    for c, plane in enumerate([gray] + _color_planes(color, channel_major)):
        s = box_sums(plane, *boxes).view(B, R, K)
        out[:, c] = torch.where(ok, s, 0).sum(1)
    return out.to(torch.int32)


def bbox_sums(bbox, slot_list, slot_count, band: int, gray, color=None,
              channel_major: bool = False):
    """Bbox-window sums (see bbox_sums_reference).  bbox int32 [B, 4, K]
    from banded_stats, slot_list int32 [B, R, K], slot_count int32 [B, R]
    with R = ceil(H / band), gray uint8 [B, H, W], color None or frames."""
    B, H, W = gray.shape
    K = bbox.shape[-1]
    R = -(-H // band)
    if gray.device.type == "cpu":
        return bbox_sums_reference(bbox, slot_list, slot_count, band, gray,
                                   color, channel_major)
    from heimdall_tpu_torch.ops import _cuda

    C, fs, cs, ps = color_layout(color, channel_major, B, H, W)
    check_cuda(gray, "gray", (torch.uint8,))
    check_cuda(bbox, "bbox", (torch.int32,), (B, 4, K))
    check_cuda(slot_list, "slot_list", (torch.int32,), (B, R, K))
    check_cuda(slot_count, "slot_count", (torch.int32,), (B, R))
    if color is not None:
        check_cuda(color, "color", (torch.uint8,))
    if not 1 <= K <= MAX_SLOTS:
        raise ValueError(f"the kernel takes 1..{MAX_SLOTS} slots, got {K}")
    out = torch.empty((B, 4, K), dtype=torch.int32, device=gray.device)
    raise_on(_cuda.library("stats_tiled").hd_bbox_sums(
        0 if color is None else color.data_ptr(), C, fs, cs, ps, B, H, W,
        band, K, bbox.data_ptr(), slot_list.data_ptr(), slot_count.data_ptr(),
        gray.data_ptr(), out.data_ptr(), stream(gray)), "bbox_sums")
    bbox_sums.launches += 1
    return out


bbox_sums.launches = 0


def blob_stats_tiled(labels, mask, gray, color=None, band: int = 256,
                     max_blobs: int = 64, use_color: bool = True,
                     root_table=None, root_count=None, slot_list=None,
                     slot_count=None,
                     channel_major: bool = False) -> BlobTable:
    """BlobTable of ops.blobs.blob_stats from the tiled labeling's outputs.

    labels/mask/gray: [B, H, W] (labels int32, background H*W); color: None
    or uint8 [B, H, W, 3] ([B, 3, H, W] with channel_major); root_table
    [B, >=K] and root_count [B] from connected_components_tiled(
    return_roots=K); slot_list [B, R, K] / slot_count [B, R] from its
    band_slots=True (without them every slot is listed in every band)."""
    B, H, W = labels.shape
    check_sum_bound(H, W)
    if root_table is None or root_count is None:
        raise ValueError("blob_stats_tiled needs root_table and root_count "
                         "(connected_components_tiled(return_roots=K))")
    K = max_blobs
    root_count = root_count.to(torch.int32)
    if color is not None and not use_color:
        color = None
    if slot_list is None or slot_count is None:
        R = -(-H // band)
        slot_list = torch.arange(K, dtype=torch.int32, device=labels.device)
        slot_list = slot_list.expand(B, R, K).contiguous()
        slot_count = root_count.clamp(max=K)[:, None].expand(B, R)
        slot_count = slot_count.contiguous()
    sums, bbox = banded_stats(labels, mask, gray, color,
                              root_table.to(torch.int32), root_count, K,
                              channel_major)
    box = bbox_sums(bbox, slot_list.to(torch.int32),
                    slot_count.to(torch.int32), band, gray, color,
                    channel_major)
    return table_from_sums(sums, bbox, box, root_count,
                           use_color=color is not None)


def label_and_table(mask, gray, color=None, band: int = 256,
                    max_blobs: int = 64, use_color: bool = True,
                    channel_major: bool = False):
    """The band route from a filled mask: connected_components_tiled
    (8-connected, the first ``max_blobs`` roots and each band's slot lists),
    then blob_stats_tiled on its outputs.  Returns (labels, BlobTable)."""
    labels, roots, n, slot_list, slot_count = connected_components_tiled(
        mask, connectivity=8, band=band, return_roots=max_blobs,
        band_slots=True)
    return labels, blob_stats_tiled(
        labels, mask, gray, color, band=band, max_blobs=max_blobs,
        use_color=use_color, root_table=roots, root_count=n,
        slot_list=slot_list, slot_count=slot_count,
        channel_major=channel_major)
