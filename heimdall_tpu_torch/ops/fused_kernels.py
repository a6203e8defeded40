"""The fused contamination detect: CUDA kernel, plain version, and the table
and gates around it (counterpart of heimdall_tpu/ops/pallas_kernels.py).

``contamination_fused`` runs the whole per-frame job — gray, Q8 blur5, f32
mean11 with rint, INV threshold, open/close, hole fill, 8-connected CCL and
the first-K-root statistics — and returns the raw outputs in the layout of
``contamination_pallas``.  On a CUDA tensor it launches the hand-written
kernels of ``csrc/fused_detect.cu`` (the one-pass preprocess, then the
shared-memory tile fill and labeling of ``csrc/tile_uf.cuh``, then the
stats); on a CPU tensor it runs
``contamination_fused_reference``, the same function composed from the plain
ops of this package.  ``fused_blob_table`` and ``fused_detect`` add the
BlobTable formulas, the confidence blend and the gates (``gate``).
``preprocess`` runs the kernel's preprocess stages alone (to the closed
binary plane), for the band-tiled route of frames of any size.

Accepted frame forms (uint8):
  [B, H, W, 3]  BGR,
  [B, 3, H, W]  BGR planes with channel_major=True (the feeder layout),
  [B, 1, H, W]  Mono8 with channel_major=True,
  [B, H, W]     Mono8 (color sums skipped; color_score is 0.5 downstream).
"""

import ctypes

import numpy as np
import torch

from heimdall_tpu_torch.ops import blobs as blobs_mod
from heimdall_tpu_torch.ops.blobs import N_SUMS
from heimdall_tpu_torch.ops.ccl import connected_components, fill_holes
from heimdall_tpu_torch.ops.color import gray_from_planes
from heimdall_tpu_torch.ops.filters import (_q8_taps_bitexact, f32_taps,
                                            gaussian_blur, gaussian_kernel_1d)
from heimdall_tpu_torch.ops.morphology import morphology_ex
from heimdall_tpu_torch.ops.threshold import adaptive_threshold

# The detector sends frames of up to this many pixels through the fused
# kernel and larger ones through the band-tiled route
# (detectors/contamination_detector.py::contamination_program), whose int32
# sums are guarded by ops/stats_tiled.py; a direct call of the fused kernel
# on a larger frame raises.
MAX_FRAME_PX = 400_000


def frame_layout(frames: torch.Tensor, channel_major: bool):
    """(B, C, H, W, channel stride, pixel stride) of a frame batch."""
    if frames.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8, got {frames.dtype}")
    if frames.dim() == 3:
        B, H, W = frames.shape
        return B, 1, H, W, 0, 1
    if frames.dim() == 4 and channel_major and frames.shape[1] in (1, 3):
        B, C, H, W = frames.shape
        return B, C, H, W, H * W, 1
    if frames.dim() == 4 and not channel_major and frames.shape[-1] == 3:
        B, H, W, C = frames.shape
        return B, C, H, W, 1, 3
    raise ValueError(
        f"frames must be [B,H,W], [B,1|3,H,W] (channel_major) or [B,H,W,3]; "
        f"got {tuple(frames.shape)} with channel_major={channel_major}")


def _planes(frames: torch.Tensor, channel_major: bool):
    """(gray [B,H,W], color planes (b, g, r) or None)."""
    B, C, H, W, _, _ = frame_layout(frames, channel_major)
    if C == 1:
        return frames.reshape(B, H, W), None
    if channel_major:
        color = (frames[:, 0], frames[:, 1], frames[:, 2])
    else:
        color = (frames[..., 0], frames[..., 1], frames[..., 2])
    return gray_from_planes(*color), color


def preprocess_stage(gray: torch.Tensor, contrast_threshold,
                     stage: str = "pre") -> torch.Tensor:
    """Blur, INV threshold, open and close of a gray batch, up to ``stage``:
    "blur5" (the Q8 blur, u8), "mean11" (the threshold of the f32 mean11,
    u8 0/255) or "pre" (the opened and closed mask, u8 1 = foreground)."""
    # one channel: gaussian_blur takes a last axis of 1, 3 or 4 for colour,
    # which a gray batch of that width is not
    blurred = gaussian_blur(gray[..., None], 5, 0)[..., 0]
    if stage == "blur5":
        return blurred
    binary = adaptive_threshold(blurred, 255, "gaussian", "binary_inv", 11,
                                int(contrast_threshold))
    if stage == "mean11":
        return binary
    se3 = np.ones((3, 3), np.uint8)
    binary = morphology_ex(binary, "open", se3)
    binary = morphology_ex(binary, "close", se3)
    return (binary > 0).to(torch.uint8)


def preprocess_reference(frames: torch.Tensor, contrast_threshold,
                         channel_major: bool = False):
    """Plain PyTorch version of hd_preprocess: (gray u8 [B,H,W], closed
    binary u8 [B,H,W] with 1 for foreground)."""
    gray, _ = _planes(frames, channel_major)
    return gray, preprocess_stage(gray, contrast_threshold)


def kernel_taps():
    """The Q8 blur5 and f32 mean11 taps as C arrays."""
    q8 = _q8_taps_bitexact(gaussian_kernel_1d(5, 0.0))
    return (ctypes.c_int * 5)(*q8), (ctypes.c_float * 11)(*f32_taps(11))


def preprocess(frames: torch.Tensor, contrast_threshold,
               channel_major: bool = False):
    """The fused kernel's preprocess stages alone, for frames of any size:
    (gray u8 [B,H,W], closed binary u8 [B,H,W], 1 = foreground).

    On a CUDA tensor this launches hd_preprocess of csrc/fused_detect.cu,
    one pass over shared-memory tiles with no scratch plane (and raises if
    it cannot); on a CPU tensor it runs the plain version.
    ``preprocess.launches`` counts kernel launches."""
    if frames.device.type == "cpu":
        return preprocess_reference(frames, contrast_threshold, channel_major)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    from heimdall_tpu_torch.ops import _cuda

    B, C, H, W, cstride, pstride = frame_layout(frames, channel_major)
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if not (3 <= H and 3 <= W and 1 <= B <= 65535 and H * W < 2**31):
        raise ValueError(f"unsupported shape B={B} H={H} W={W}")
    gray, binary = (torch.empty((B, H, W), dtype=torch.uint8,
                                device=frames.device) for _ in range(2))
    q8, k11 = kernel_taps()
    err = _cuda.library("fused_detect").hd_preprocess(
        frames.data_ptr(), B, H, W, C, cstride, pstride,
        int(contrast_threshold), q8, k11, gray.data_ptr(), binary.data_ptr(),
        torch.cuda.current_stream(frames.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"preprocess kernel launch failed: CUDA error {err}")
    preprocess.launches += 1
    return gray, binary


preprocess.launches = 0


def contamination_fused_reference(frames: torch.Tensor, contrast_threshold,
                                  max_blobs: int = 64,
                                  channel_major: bool = False,
                                  return_labels: bool = False):
    """Plain PyTorch version of the fused kernel (any device, any size).

    Returns (sums i32 [B,8,K], bbox i32 [B,4,K], bgsum i32 [B,4,K],
    n_blobs i32 [B]) and, with return_labels, the label plane i32
    [B,H,W] (background H*W)."""
    gray, color = _planes(frames, channel_major)
    mask = fill_holes(preprocess_stage(gray, contrast_threshold) > 0)
    labels = connected_components(mask, connectivity=8)
    out = blobs_mod.blob_sums(labels, mask, gray, color, max_blobs)
    return out + (labels,) if return_labels else out


def _launch(frames: torch.Tensor, contrast_threshold, max_blobs: int,
            channel_major: bool, return_labels: bool):
    from heimdall_tpu_torch.ops import _cuda

    B, C, H, W, cstride, pstride = frame_layout(frames, channel_major)
    K = max_blobs
    if H * W > MAX_FRAME_PX:
        raise NotImplementedError(
            f"{H}x{W} frames exceed the fused kernel's {MAX_FRAME_PX} px; "
            "larger frames (up to 2 MP) take the band-tiled route, "
            "contamination_program(..., tiled_band=128), as "
            "ContaminationDetector.run_device does")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if not (3 <= H and 3 <= W and 1 <= B <= 65535 and 1 <= K <= 1024):
        raise ValueError(f"unsupported shape B={B} H={H} W={W} K={K}")
    dev = frames.device
    i32, u8 = torch.int32, torch.uint8

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    sums = torch.zeros((B, N_SUMS, K), dtype=i32, device=dev)
    bbox = empty((B, 4, K), i32)
    bgsum = torch.zeros((B, 4, K), dtype=i32, device=dev)
    n = empty((B,), i32)
    labels, rank = empty((B, H, W), i32), empty((B, H, W), i32)
    gray, mask = empty((B, H, W), u8), empty((B, H, W), u8)
    table = empty((B, _cuda.library("ccl_tiled").hd_flood_entries(H, W)),
                  i32)
    lib = _cuda.library("fused_detect")
    flags = empty((B, lib.hd_label_tiles(H, W)), u8)
    rowcnt, rowoff = empty((B, H), i32), empty((B, H), i32)
    q8, k11 = kernel_taps()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.hd_fused_detect(
        frames.data_ptr(), B, H, W, C, cstride, pstride,
        int(contrast_threshold), K, q8, k11, gray.data_ptr(),
        mask.data_ptr(), table.data_ptr(), flags.data_ptr(), rank.data_ptr(),
        labels.data_ptr(), rowcnt.data_ptr(), rowoff.data_ptr(),
        sums.data_ptr(), bbox.data_ptr(), bgsum.data_ptr(), n.data_ptr(),
        stream)
    if err:
        raise RuntimeError(f"fused_detect kernel launch failed: CUDA error {err}")
    contamination_fused.launches += 1
    out = (sums, bbox, bgsum, n)
    return out + (labels,) if return_labels else out


def contamination_fused(frames: torch.Tensor, contrast_threshold,
                        max_blobs: int = 64, channel_major: bool = False,
                        return_labels: bool = False):
    """Run the fused detect over a uint8 batch.

    On a CUDA tensor this launches the kernel of csrc/fused_detect.cu (and
    raises if it cannot); on a CPU tensor it runs the plain version.
    Returns (sums i32 [B,8,K] — ones, boundary, x, y, gray, b, g, r;
    bbox i32 [B,4,K] — x0, y0, x1, y1 inclusive; bgsum i32 [B,4,K] —
    bbox-window sums of gray, b, g, r; n_blobs i32 [B]) and, with
    return_labels, the label plane i32 [B,H,W].  Slots past min(n, K) are
    zero.  ``contamination_fused.launches`` counts kernel launches.
    """
    if frames.device.type == "cpu":
        return contamination_fused_reference(frames, contrast_threshold,
                                             max_blobs, channel_major,
                                             return_labels)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    return _launch(frames, contrast_threshold, max_blobs, channel_major,
                   return_labels)


contamination_fused.launches = 0


def fused_blob_table(frames: torch.Tensor, contrast_threshold,
                     max_blobs: int = 64, use_color: bool = True,
                     channel_major: bool = False,
                     return_labels: bool = False):
    """BlobTable of the fused detect (counterpart of pallas_blob_table);
    with return_labels, (table, labels)."""
    if frames.dim() == 3 or (channel_major and frames.shape[1] == 1):
        use_color = False      # Mono8: color_score is the neutral 0.5
    out = contamination_fused(frames, contrast_threshold, max_blobs,
                              channel_major, return_labels)
    table = blobs_mod.table_from_sums(*out[:4], use_color=use_color)
    return (table, out[4]) if return_labels else table


def fused_detect(frames: torch.Tensor, contrast_threshold, min_size,
                 max_size, min_confidence, max_blobs: int = 64,
                 use_color: bool = True, formula: str = "python",
                 channel_major: bool = False, return_labels: bool = False):
    """Detection: fused kernel + table + confidence + gates (counterpart of
    contamination_pallas_detect).

    Returns (BlobTable, confidence [B,K] f32, accepted [B,K] bool) and, with
    return_labels, the label plane as a fourth element."""
    out = fused_blob_table(frames, contrast_threshold, max_blobs, use_color,
                           channel_major, return_labels)
    table = out[0] if return_labels else out
    conf, accepted = gate(table, min_size, max_size, min_confidence, formula)
    return (table, conf, accepted) + ((out[1],) if return_labels else ())


def gate(table, min_size, max_size, min_confidence, formula: str = "python"):
    """Confidence [B,K] f32 and accepted [B,K] bool of a BlobTable: the
    confidence blend, then the size and confidence gates."""
    conf = (blobs_mod.confidence_native(table) if formula == "native"
            else blobs_mod.confidence_python(table))

    def f32(v):   # the gate as float32, filled on the device (no sync)
        return torch.full((), v, dtype=torch.float32, device=conf.device)

    accepted = (table.valid
                & (table.area >= f32(min_size))
                & (table.area <= f32(max_size))
                & (conf >= f32(min_confidence)))
    return conf, accepted
