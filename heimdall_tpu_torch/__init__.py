"""heimdall_tpu_torch — the PyTorch/CUDA port of heimdall_tpu for NVIDIA
Hopper (H100).

The inspection system runs end to end on the card: stations read frame
batches from their image sources and run a pipeline or an inspector (the
"contamination" pipeline, then the contamination detector on its
processed frames) on one device, with PLC reject pulses and result
records; ``python -m heimdall_tpu_torch.main -s`` starts the simulated
two-station line.  The same functions composed from plain PyTorch ops run
on the CPU when ``device="cpu"`` is passed.

The detector takes frames of up to 400,000 px (640x480) through one fused
CUDA kernel (csrc/fused_detect.cu); larger BGR frames (the 1920x1080
design point) through the run-table route (csrc/runtable_tiled.cu), with
a per-frame fallback to the band route; larger Mono8 frames through the
band route (csrc/ccl_tiled.cu); both then through the banded statistics
(csrc/stats_tiled.cu).  The pipelines' contour stage labels through the
band route's kernels too.  The profiling path times the 640x480 detect
stage by stage through the fused kernel's two-kernel split
(ops/split_kernels.py).  The package imports torch and numpy (and yaml,
scipy and cv2 where the JAX package does), never jax and nothing of
heimdall_tpu.

Layers (mirroring heimdall_tpu):
  core/        Config, ImageSource (acquisition), Pipeline with its stages
               and PipelineFactory (five types), System with its
               InspectionStations, ResultRepository
  ops/         color, filters (blur, box, Sobel, Canny), threshold (fixed,
               Otsu, Triangle, adaptive), histogram (equalize, CLAHE),
               hough, morphology, ccl, blobs, demosaic (plain PyTorch),
               and the wrappers of the CUDA kernels with their plain
               versions:
               fused_kernels (640x480), preprocess_tiled, runtable_tiled,
               ccl_tiled, stats_tiled (2 MP routes), split_kernels (the
               label and stats kernels and the label kernel's stages)
  csrc/        CUDA C++ sources, built by ops/_cuda.py at first use
  detectors/   Defect model, ContaminationDetector and
               MultiClassDefectDetector
  inspection/  Inspector framework -> InspectionResult;
               ContaminationInspector
  runtime/     PLC client and RejectionController, diagnostics, the
               frame ring and feeders (pinned-slot uploads), recovery,
               the RT scheduler, ipc, Modbus/TCP, net
  native_bridge  the C++ host runtime (native/libheimdall_native.so)
               with fallbacks to the port's pipelines and detector
  models/      inference of the segmentation UNet (float and int8) and
               its detector, the blob-patch classifier and the anomaly
               autoencoder; convert (flax parameters to state_dicts);
               training-data capture
  serving/     the live dashboard (REST, server-sent events) and the
               results viewer
  parallel/    multi-device inspection on torch.distributed: meshes of
               ("data", "spatial") over a world's ranks (launch starts
               one on a machine), the sharded inspection, line and
               data-parallel steps, and the band kernels across devices
               (tiled_sp, with the shard entries of ccl_tiled and
               stats_tiled); dryrun runs every step once
  perf/        metrics, profiling sessions (torch.profiler traces), reports
  camera/      the camera HAL with its simulated cameras, the 4-camera
               GigE system, the Aravis hardware backend
  lighting/    controllers, sync, calibration (the uniformity map on the
               device), monitoring
  scripts/     profile_fused, profile_preprocess, ...: stage timings on
               the card
  examples/    performance_analysis: a profiling session around the
               simulated camera and the detector; line_simulation (the
               4-camera line: bottles/h and per-bottle latency),
               realtime_processing, gige_bottle_inspection,
               pet_bottle_inspection
  utils/       numpy drawing and host contour tracing
  config/      simulation.yaml, the simulated line of ``main -s``
  main.py      the command-line entry point (--dashboard serves the
               dashboard); cli.py the dashboard's control CLI
  scene.py     the bench scene generator
"""

__version__ = "0.1.0"

from heimdall_tpu_torch.core.config import Config
from heimdall_tpu_torch.core.acquisition import ImageSource, ImageSourceFactory
from heimdall_tpu_torch.core.pipeline import (Pipeline, PipelineFactory,
                                              ProcessingStage)
from heimdall_tpu_torch.core.system import System, InspectionStation
from heimdall_tpu_torch.core.results import ResultRepository
from heimdall_tpu_torch.detectors.base import Defect, DefectDetector
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.inspection.base_inspector import (Inspector,
                                                          InspectionResult)
from heimdall_tpu_torch.inspection.contamination_inspector import (
    ContaminationInspector)
from heimdall_tpu_torch.ops.blobs import BlobTable

__all__ = ["BlobTable", "Config", "ContaminationDetector",
           "ContaminationInspector", "Defect", "DefectDetector",
           "ImageSource", "ImageSourceFactory", "InspectionResult",
           "InspectionStation", "Inspector", "Pipeline", "PipelineFactory",
           "ProcessingStage", "ResultRepository", "System"]
