"""The two-kernel split of the fused detect: the label kernel (frame ->
label plane, and its stage truncations) and the stats kernel (frame + label
plane -> the fused kernel's tables).  Counterpart of
heimdall_tpu/ops/pallas_kernels.py::_make_label_kernel (B6b) and
::_make_stats_kernel (B6a), and of the truncations of the label kernel that
heimdall_tpu's profilers build (scripts/profile_fused.py,
scripts/profile_preprocess.py).  The profiling path runs them
(heimdall_tpu_torch/scripts/profile_fused.py, profile_preprocess.py).

Both take BGR planes [B, 3, H, W] uint8 (the layout of the Pallas kernels'
blocks).  On a CUDA tensor each wrapper launches its hand-written kernels
of csrc/fused_detect.cu (hd_label: the fused detect's one-pass preprocess
stopped at the stage, its tile fill and its tile labels;
and csrc/stats_labels.cu's hd_stats_from_labels: two passes over the label
plane, then the bbox windows) and raises if it cannot; on a CPU tensor it
runs its plain version.  stats_kernel on label_kernel's labels gives
contamination_fused's outputs, field for field.
"""

import collections

import torch

from heimdall_tpu_torch.ops import _launch
from heimdall_tpu_torch.ops.blobs import N_SUMS, blob_sums
from heimdall_tpu_torch.ops.ccl import connected_components, fill_holes
from heimdall_tpu_torch.ops.color import gray_from_planes
from heimdall_tpu_torch.ops.fused_kernels import (MAX_FRAME_PX, kernel_taps,
                                                  preprocess_stage)

# hd_label's stages, in order, and what each returns ([B, H, W]): gray u8;
# the Q8 blur5 u8; the INV threshold of the f32 mean11, u8 0/255; the opened
# and closed mask ("pre"), u8 0/1; the hole-filled mask, u8 0/1; the
# 8-connected labels ("ccl", the label kernel itself), int32, background
# H*W.
STAGES = ("gray", "blur5", "mean11", "pre", "fill", "ccl")


def check_frames(frames: torch.Tensor):
    """(B, H, W) of a [B, 3, H, W] uint8 batch of at most MAX_FRAME_PX px
    per frame (the int32 sum bound of the fused kernel's statistics)."""
    if frames.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8, got {frames.dtype}")
    if frames.dim() != 4 or frames.shape[1] != 3:
        raise ValueError(f"frames must be BGR planes [B, 3, H, W], got "
                         f"{tuple(frames.shape)}")
    B, _, H, W = frames.shape
    if H * W > MAX_FRAME_PX:
        raise ValueError(f"{H}x{W} frames exceed the split kernels' "
                         f"{MAX_FRAME_PX} px (int32 sums)")
    if not (1 <= B <= 65535 and H >= 3 and W >= 3):
        raise ValueError(f"unsupported shape B={B} H={H} W={W}")
    return B, H, W


def _gray(frames: torch.Tensor) -> torch.Tensor:
    return gray_from_planes(frames[:, 0], frames[:, 1], frames[:, 2])


def label_kernel_reference(frames: torch.Tensor, contrast_threshold,
                           stage: str = "ccl") -> torch.Tensor:
    """Plain PyTorch version of hd_label: the plane of ``stage``."""
    gray = _gray(frames)
    if stage == "gray":
        return gray
    if stage in ("blur5", "mean11", "pre"):
        return preprocess_stage(gray, contrast_threshold, stage)
    mask = fill_holes(preprocess_stage(gray, contrast_threshold) > 0)
    if stage == "fill":
        return mask.to(torch.uint8)
    return connected_components(mask, connectivity=8)


def label_kernel(frames: torch.Tensor, contrast_threshold,
                 stage: str = "ccl") -> torch.Tensor:
    """The label kernel (B6b) up to ``stage`` (one of STAGES; "ccl", the
    default, is the whole kernel): frames [B, 3, H, W] uint8 -> the stage's
    plane [B, H, W].  On the card each stage is reached by the fused
    detect's kernels: gray by its own pass, blur5 to pre by the one-pass
    preprocess stopped at the stage, fill by pre and the tile fill, ccl by
    fill and the tile labels; a call launches
    ``hd_label_launches(stage, H, W)`` CUDA kernels (1 up to pre, 4 at fill,
    7 at ccl, fewer for a frame of one 32x128 tile).

    ``label_kernel.launches`` counts wrapper calls that launched and
    ``label_kernel.stage_launches`` counts them by stage."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    B, H, W = check_frames(frames)
    if frames.device.type == "cpu":
        return label_kernel_reference(frames, contrast_threshold, stage)
    from heimdall_tpu_torch.ops import _cuda

    _launch.check_cuda(frames, "frames", (torch.uint8,))
    dev = frames.device
    s = STAGES.index(stage)
    lib = _cuda.library("fused_detect")
    plane = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    table = flags = labels = None
    if stage in ("fill", "ccl"):
        table = torch.empty(
            (B, _cuda.library("ccl_tiled").hd_flood_entries(H, W)),
            dtype=torch.int32, device=dev)
    if stage == "ccl":
        flags = torch.empty((B, lib.hd_label_tiles(H, W)), dtype=torch.uint8,
                            device=dev)
        labels = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    q8, k11 = kernel_taps()
    err = lib.hd_label(
        frames.data_ptr(), B, H, W, int(contrast_threshold), s, q8, k11,
        _ptr(table), _ptr(flags), plane.data_ptr(), _ptr(labels),
        _launch.stream(frames))
    _launch.raise_on(err, "label")
    label_kernel.launches += 1
    label_kernel.stage_launches[stage] += 1
    return plane if labels is None else labels


def _ptr(t):
    return None if t is None else t.data_ptr()


label_kernel.launches = 0
label_kernel.stage_launches = collections.Counter()


def stats_kernel_reference(frames: torch.Tensor, labels: torch.Tensor,
                           max_blobs: int = 64):
    """Plain PyTorch version of hd_stats_from_labels: ops/blobs.py's
    blob_sums with foreground = labels != H*W (a pixel whose label names no
    root gets no slot)."""
    H, W = frames.shape[-2:]
    planes = (frames[:, 0], frames[:, 1], frames[:, 2])
    return blob_sums(labels, labels != H * W, _gray(frames), planes,
                     max_blobs)


def stats_kernel(frames: torch.Tensor, labels: torch.Tensor,
                 max_blobs: int = 64):
    """The stats kernel (B6a): frames [B, 3, H, W] uint8 and a label plane
    int32 [B, H, W] with values in [0, H*W] -> (sums i32 [B,8,K] — ones,
    boundary, x, y, gray, b, g, r; bbox i32 [B,4,K] — x0, y0, x1, y1
    inclusive; bgsum i32 [B,4,K] — bbox-window sums of gray, b, g, r;
    n_blobs i32 [B]) over the first K roots in raster order.  Background is
    H*W; a root is a pixel whose label is its own linear index; a pixel
    belongs to the slot of the root its label names, or to none if it names
    no root or a root ranked K or later; y0 is the root's row (label_kernel's
    labels name their component's first raster pixel).  Slots past min(n, K)
    are zero.  On the card a call launches
    ``hd_stats_from_labels_launches()`` CUDA kernels (3): the roots of each
    8192-pixel chunk, the per-slot sums over 128 x 32 strips (a warp
    each), the bbox windows; no plane of scratch.  ``stats_kernel.launches``
    counts wrapper calls that launched."""
    B, H, W = check_frames(frames)
    K = max_blobs
    if not 1 <= K <= 1024:
        raise ValueError(f"max_blobs must be in [1, 1024], got {K}")
    if labels.dtype != torch.int32 or tuple(labels.shape) != (B, H, W):
        raise ValueError(f"labels must be int32 {(B, H, W)}, got "
                         f"{labels.dtype} {tuple(labels.shape)}")
    if frames.device.type == "cpu":
        if labels.device.type != "cpu":
            raise ValueError("frames and labels must be on one device")
        return stats_kernel_reference(frames, labels, K)
    from heimdall_tpu_torch.ops import _cuda

    _launch.check_cuda(frames, "frames", (torch.uint8,))
    _launch.check_cuda(labels, "labels", (torch.int32,))
    lib = _cuda.library("stats_labels")
    sums, bbox, bgsum, n, scratch = _launch.alloc(
        frames.device, ((B, N_SUMS, K), torch.int32),
        ((B, 4, K), torch.int32), ((B, 4, K), torch.int32),
        ((B,), torch.int32),
        ((B, lib.hd_stats_scratch(H, W, K)), torch.int32))
    err = lib.hd_stats_from_labels(
        frames.data_ptr(), B, H, W, K, labels.data_ptr(), scratch.data_ptr(),
        sums.data_ptr(), bbox.data_ptr(), bgsum.data_ptr(), n.data_ptr(),
        _launch.stream(frames))
    _launch.raise_on(err, "stats")
    stats_kernel.launches += 1
    return sums, bbox, bgsum, n


stats_kernel.launches = 0
