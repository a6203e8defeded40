"""heimdall_tpu_torch — the PyTorch/CUDA port of heimdall_tpu for NVIDIA
Hopper (H100).

The contamination detector runs end to end on the card, and the same
functions composed from plain PyTorch ops run on the CPU: frames of up to
400,000 px (640x480) through one fused CUDA kernel (csrc/fused_detect.cu);
larger BGR frames (the 1920x1080 design point) through the run-table route
(csrc/runtable_tiled.cu), with a per-frame fallback to the band route;
larger Mono8 frames through the band route (csrc/ccl_tiled.cu); both then
through the banded statistics (csrc/stats_tiled.cu).  The profiling path
times the 640x480 detect stage by stage through the fused kernel's
two-kernel split (ops/split_kernels.py).  The package imports torch and
numpy, never jax and nothing of heimdall_tpu.

Layers (mirroring heimdall_tpu):
  ops/         color, filters, threshold, morphology, ccl, blobs (plain
               PyTorch), and the wrappers of the CUDA kernels with their
               plain versions: fused_kernels (640x480), preprocess_tiled,
               runtable_tiled, ccl_tiled, stats_tiled (2 MP routes),
               split_kernels (the label and stats kernels and the label
               kernel's stages)
  csrc/        CUDA C++ sources, built by ops/_cuda.py at first use
  detectors/   Defect model + ContaminationDetector
  perf/        metrics, profiling sessions (torch.profiler traces), reports
  camera/      the camera HAL with its simulated cameras
  scripts/     profile_fused, profile_preprocess: stage timings on the card
  examples/    performance_analysis: a profiling session around the
               simulated camera and the detector
  utils/       numpy drawing and host contour tracing
  scene.py     the bench scene generator
"""

__version__ = "0.1.0"

from heimdall_tpu_torch.detectors.base import Defect, DefectDetector
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.ops.blobs import BlobTable

__all__ = ["BlobTable", "ContaminationDetector", "Defect", "DefectDetector"]
