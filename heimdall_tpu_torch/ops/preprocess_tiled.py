"""The preprocess of the run-table route with the background run tables of
its closed binary (counterpart of heimdall_tpu/ops/preprocess_tiled.py,
TPU kernel B2).

The TPU kernel runs the preprocess in bands with a halo and emits the
tables from the band still in VMEM.  Here the preprocess is
``hd_preprocess`` of ``csrc/fused_detect.cu`` (through
ops/fused_kernels.py::preprocess, for frames of any size: one launch over
shared-memory tiles with a halo) and the tables
come from ``hd_run_extract`` of ``csrc/runtable_tiled.cu`` (through
ops/runtable_tiled.py::run_extract) on the closed binary plane.  Planes are
[B, H, W], unpadded.
"""

import torch

from heimdall_tpu_torch.ops.fused_kernels import (preprocess,
                                                  preprocess_reference)
from heimdall_tpu_torch.ops.runtable_tiled import (run_extract,
                                                   run_extract_reference)


def contamination_preprocess_tiled_reference(images: torch.Tensor,
                                             contrast_threshold,
                                             channel_major: bool = False,
                                             bg_tables: int = 8):
    """Plain PyTorch version of contamination_preprocess_tiled."""
    gray, binary = preprocess_reference(images, contrast_threshold,
                                        channel_major)
    return (binary, gray) + run_extract_reference(binary, bg_tables,
                                                  invert=True)


def contamination_preprocess_tiled(images: torch.Tensor, contrast_threshold,
                                   channel_major: bool = False,
                                   bg_tables: int = 8):
    """uint8 frames ([B, H, W, 3] BGR, [B, 3, H, W] with channel_major, or
    Mono8) -> (binary uint8 [B, H, W], 1 = foreground (the JAX kernel
    writes 255), gray uint8 [B, H, W], and the run tables runid, S, E, nrun
    of the background of binary, bg_tables slots wide), as
    ops/runtable_tiled.py::fill_label_runtable_tiled(pre_extracted=...)
    takes the tables.

    On CUDA tensors this launches the kernels (and raises if it cannot),
    counting one in ``.launches``; on CPU tensors it runs the plain
    versions."""
    gray, binary = preprocess(images, contrast_threshold, channel_major)
    out = (binary, gray) + run_extract(binary, bg_tables, invert=True)
    if images.device.type == "cuda":
        contamination_preprocess_tiled.launches += 1
    return out


contamination_preprocess_tiled.launches = 0
