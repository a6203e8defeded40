"""PyTorch image operators and the fused CUDA detect (port of heimdall_tpu/ops).

The package exports the operators that heimdall_tpu.ops exports, from the
port's own modules.  Importing it builds and loads no CUDA library: each
kernel's wrapper loads its library (ops/_cuda.py) at its first launch.
"""

from heimdall_tpu_torch.ops.color import bgr_to_gray, gray_to_bgr
from heimdall_tpu_torch.ops.filters import (
    gaussian_blur,
    box_blur,
    gaussian_kernel_1d,
    sobel,
    canny,
)
from heimdall_tpu_torch.ops.threshold import (
    threshold,
    threshold_auto,
    otsu_threshold,
    triangle_threshold,
    adaptive_threshold,
)
from heimdall_tpu_torch.ops.morphology import (
    erode,
    dilate,
    morphology_ex,
    structuring_element,
)
from heimdall_tpu_torch.ops.histogram import (equalize_hist, clahe,
                                              histogram256)
from heimdall_tpu_torch.ops import ccl
from heimdall_tpu_torch.ops.ccl import connected_components, fill_holes
from heimdall_tpu_torch.ops.blobs import blob_stats, BlobTable
from heimdall_tpu_torch.ops.hough import hough_lines, hough_lines_p
from heimdall_tpu_torch.ops.demosaic import demosaic_bilinear, yuv422_to_bgr
