"""Processing pipelines: declarative stage chains run on one device (port
of heimdall_tpu/core/pipeline.py).

The same stage classes, the same PipelineFactory pipeline types ("basic",
"bottle_base", "sidewall", "preform", "contamination") and the same
context-dict protocol (original_image / current_image / stage_results /
stage_times with its "<fused>" entry / result_image / success / error /
total_time) as the JAX package.

Where JAX compiles the stage chain into one jitted program, the port runs
the stages eagerly on the pipeline's device: a stage's ``apply(x, aux)``
maps a batch of tensors [N, H, W(, C)] on that device to the next,
optionally writing device outputs into ``aux[self.name]``; ``host_post``
turns those outputs, as numpy arrays, into host-side context entries
(contour lists, Hough segments).  "<fused>" times the whole chain.

The contour stage labels through the band-tiled wrappers
(ops/stats_tiled.py::label_and_table: connected_components_tiled, then
blob_stats_tiled), which launch the hand-written kernels on a CUDA tensor
and run their plain versions on a CPU tensor.  A pipeline runs on CUDA
unless it is given ``device="cpu"``; it raises where there is no card.
"""

import importlib
import logging
import time
from typing import Any, Dict, List

import numpy as np
import torch

from heimdall_tpu_torch.detectors.contamination_detector import (
    TILED_BAND, _label_of_blob, resolve_device)
from heimdall_tpu_torch.ops import color, filters, histogram, hough, morphology
from heimdall_tpu_torch.ops.blobs import BlobTable
from heimdall_tpu_torch.ops.stats_tiled import label_and_table
from heimdall_tpu_torch.utils import contours as contours_mod

# the module: the ops package exports its function of the same name
thresh_ops = importlib.import_module("heimdall_tpu_torch.ops.threshold")

logger = logging.getLogger("heimdall.pipeline")


def _to_device(images, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor on device."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    return images.to(device).contiguous()


def _to_host(tree):
    """Tensors (in dicts and BlobTables) as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, BlobTable):
        return BlobTable(*(_to_host(t) for t in tree))
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


class ProcessingStage:
    """Base class for pipeline stages.

    Subclasses implement ``apply(image, aux)`` on tensors of the stage's
    device, returning the transformed batch (and optionally writing device
    outputs into ``aux[self.name]``).  ``host_post`` runs after the chain
    with numpy copies to populate host-side context entries.  A pipeline
    sets ``device`` on the stages it holds; a stage used alone runs on
    CUDA unless its ``device`` is set.
    """

    def __init__(self, name: str, config: Dict[str, Any] = None):
        self.name = name
        self.config = config or {}
        self.device = None
        self.logger = logging.getLogger(f"heimdall.pipeline.{name}")

    def apply(self, image: torch.Tensor, aux: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def host_post(self, aux_np: Dict[str, Any],
                  context: Dict[str, Any]) -> None:
        """Optional host-side post-processing of this stage's aux outputs."""

    # Reference-compatible single-image callable (times itself into context).
    def __call__(self, image, context: Dict[str, Any] = None):
        if context is None:
            context = {}
        start = time.time()
        batched = _to_device(np.asarray(image)[None],
                             resolve_device(self.device))
        aux: Dict[str, Any] = {}
        out = self.apply(batched, aux)[0].cpu().numpy()
        if aux:
            self.host_post(_to_host(aux), context)
        elapsed = time.time() - start
        context.setdefault("stage_times", {})[self.name] = elapsed
        self.logger.debug("Stage %s completed in %.4fs", self.name, elapsed)
        return out

    # alias kept for reference API compatibility
    def process(self, image, context=None):
        return self.__call__(image, context)


class Pipeline:
    """A named chain of stages run on one device."""

    def __init__(self, name: str, config: Dict[str, Any] = None,
                 instrumented: bool = False, device=None):
        self.name = name
        self.config = config or {}
        self.device = resolve_device(device)
        self.stages: List[ProcessingStage] = []
        self.instrumented = self.config.get("instrumented", instrumented)
        self.logger = logging.getLogger(f"heimdall.pipeline.{name}")

    def add_stage(self, stage: ProcessingStage) -> "Pipeline":
        stage.device = self.device
        self.stages.append(stage)
        return self

    def _run(self, images: torch.Tensor, capture_stages: bool):
        """The stage chain on a device batch: (result, snapshots, aux)."""
        aux: Dict[str, Any] = {}
        snapshots = []
        x = images
        for stage in self.stages:
            x = stage.apply(x, aux)
            if capture_stages:
                snapshots.append(x)
        return x, snapshots, aux

    # ------------------------------------------------------------------
    def process(self, image, context: Dict[str, Any] = None) -> Dict[str, Any]:
        """Single-image API with the reference's context protocol."""
        if context is None:
            context = {}
        context["pipeline_name"] = self.name
        context["start_time"] = time.time()
        context["original_image"] = image
        context["current_image"] = np.asarray(image).copy()
        context["stage_results"] = {}
        context["stage_times"] = {}
        stage = None
        try:
            if self.instrumented:
                x = np.asarray(image)
                for stage in self.stages:
                    x = stage(x, context)
                    context["stage_results"][stage.name] = np.asarray(x).copy()
                context["current_image"] = x
            else:
                batched = _to_device(np.asarray(image)[None], self.device)
                t0 = time.time()
                result, snaps, aux = self._run(batched, True)
                result = result[0].cpu().numpy()
                fused_time = time.time() - t0
                for stage, snap in zip(self.stages, snaps):
                    context["stage_results"][stage.name] = \
                        snap[0].cpu().numpy()
                context["stage_times"]["<fused>"] = fused_time
                aux_np = _to_host(aux)
                for stage in self.stages:
                    stage.host_post(aux_np, context)
                context["current_image"] = result
            context["result_image"] = context["current_image"]
            context["success"] = True
        except Exception as exc:
            self.logger.error("Error in pipeline: %s", exc)
            context["success"] = False
            context["error"] = str(exc)
            context["error_stage"] = getattr(stage, "name", "unknown")
        finally:
            context["total_time"] = time.time() - context["start_time"]
            self.logger.debug("Pipeline %s completed in %.4fs",
                              self.name, context["total_time"])
        return context

    def process_batch(self, images, capture_stages: bool = False,
                      device_only: bool = False) -> Dict[str, Any]:
        """Batched execution: images [N, H, W, C] (numpy or a tensor).

        With device_only=True the result and the aux outputs stay tensors
        on the pipeline's device and no stage's host_post runs: the chain
        makes no host sync unless a stage's ``apply`` does (the Canny
        hysteresis asks whether it has converged).
        """
        context: Dict[str, Any] = {
            "pipeline_name": self.name,
            "start_time": time.time(),
        }
        result, snaps, aux = self._run(_to_device(images, self.device),
                                       capture_stages)
        if device_only:
            context["result_image"] = result
            context["aux"] = aux
        else:
            context["result_image"] = result.cpu().numpy()
            aux_np = _to_host(aux)
            if capture_stages:
                context["stage_results"] = {
                    s.name: v.cpu().numpy()
                    for s, v in zip(self.stages, snaps)}
            for stage in self.stages:
                stage.host_post(aux_np, context)
        context["success"] = True
        context["total_time"] = time.time() - context["start_time"]
        return context


# ---------------------------------------------------------------------------
# Stages (each the JAX package's stage on tensors; cv2 parity as there)
# ---------------------------------------------------------------------------

class GrayscaleStage(ProcessingStage):
    """BGR -> gray (reference pipeline.py:208-217); cv2 bit-exact."""

    def apply(self, image, aux):
        return color.bgr_to_gray(image)


class GaussianBlurStage(ProcessingStage):
    """Gaussian blur (reference pipeline.py:220-233); cv2 bit-exact."""

    def __init__(self, name, config=None):
        super().__init__(name, config)
        self.kernel_size = self.config.get("kernel_size", 5)
        self.sigma = self.config.get("sigma", 0)

    def apply(self, image, aux):
        return filters.gaussian_blur(image, self.kernel_size, self.sigma)


class CannyEdgeStage(ProcessingStage):
    """Canny edges (reference pipeline.py:236-259)."""

    def __init__(self, name, config=None):
        super().__init__(name, config)
        self.threshold1 = self.config.get("threshold1", 50)
        self.threshold2 = self.config.get("threshold2", 150)
        self.aperture_size = self.config.get("aperture_size", 3)
        self.l2_gradient = self.config.get("L2gradient", False)

    def apply(self, image, aux):
        gray = color.bgr_to_gray(image)
        return filters.canny(gray.to(torch.int32), self.threshold1,
                             self.threshold2, self.aperture_size,
                             self.l2_gradient)


class AdaptiveThresholdStage(ProcessingStage):
    """Adaptive threshold (reference pipeline.py:262-287); cv2 bit-exact."""

    def __init__(self, name, config=None):
        super().__init__(name, config)
        self.max_value = self.config.get("max_value", 255)
        method = self.config.get("method", "ADAPTIVE_THRESH_GAUSSIAN_C")
        self.method = "gaussian" if "GAUSSIAN" in str(method) else "mean"
        ttype = self.config.get("threshold_type", "THRESH_BINARY")
        self.threshold_type = _cv_name_to_method(ttype)
        self.block_size = self.config.get("block_size", 11)
        self.C = self.config.get("C", 2)

    def apply(self, image, aux):
        gray = color.bgr_to_gray(image)
        return thresh_ops.adaptive_threshold(
            gray, self.max_value, self.method, self.threshold_type,
            self.block_size, self.C)


class MorphologyStage(ProcessingStage):
    """Morphological open/close/... (reference pipeline.py:290-332);
    cv2 bit-exact."""

    _OPS = {2: "erode", 3: "dilate", "MORPH_ERODE": "erode",
            "MORPH_DILATE": "dilate", "MORPH_OPEN": "open",
            "MORPH_CLOSE": "close", "MORPH_GRADIENT": "gradient",
            "MORPH_TOPHAT": "tophat", "MORPH_BLACKHAT": "blackhat"}

    def __init__(self, name, config=None):
        super().__init__(name, config)
        op = self.config.get("operation", "MORPH_OPEN")
        if isinstance(op, str):
            self.operation = self._OPS.get(op, op)
        else:
            # cv2 integer constants: MORPH_ERODE=0 ... MORPH_BLACKHAT=6
            self.operation = ["erode", "dilate", "open", "close",
                              "gradient", "tophat", "blackhat"][int(op)]
        self.kernel_size = self.config.get("kernel_size", 5)
        self.iterations = self.config.get("iterations", 1)
        shape = self.config.get("kernel_shape", "rect")
        self.kernel = morphology.structuring_element(
            shape if shape in ("rect", "ellipse", "cross") else "rect",
            self.kernel_size)

    def apply(self, image, aux):
        return morphology.morphology_ex(image, self.operation, self.kernel,
                                        self.iterations)


class ThresholdStage(ProcessingStage):
    """Fixed/Otsu/Triangle threshold (reference pipeline.py:335-363);
    cv2 bit-exact (Otsu/Triangle to the same selected threshold)."""

    def __init__(self, name, config=None):
        super().__init__(name, config)
        self.threshold = self.config.get("threshold", 127)
        self.max_value = self.config.get("max_value", 255)
        method = self.config.get("method", "THRESH_BINARY")
        self.auto = None
        if method in ("THRESH_OTSU", 8):
            self.auto = "otsu"
            self.method = "binary"
        elif method in ("THRESH_TRIANGLE", 16):
            self.auto = "triangle"
            self.method = "binary"
        else:
            self.method = _cv_name_to_method(method)

    def apply(self, image, aux):
        gray = color.bgr_to_gray(image)
        if self.auto:
            _, out = thresh_ops.threshold_auto(gray, self.max_value,
                                               self.method, self.auto)
            return out
        return thresh_ops.threshold(gray, self.threshold, self.max_value,
                                    self.method)


class ContourDetectionStage(ProcessingStage):
    """Contour detection + area filter + draw (reference pipeline.py:366-443).

    Device side: binarize if needed -> labels (the band-tiled labeling with
    its root table and band slot lists) -> blob table (banded stats and
    bbox sums, no colour) -> the boundaries of the blobs that pass the area
    filter drawn (eroded for thickness) in the configured colour.  Host
    side: contour point lists traced from the label image into
    context["contours"] / ["contour_count"].
    """

    def __init__(self, name, config=None):
        super().__init__(name, config)
        self.min_area = self.config.get("min_area", 0)
        self.max_area = self.config.get("max_area", float("inf"))
        self.draw = self.config.get("draw", True)
        self.color = tuple(self.config.get("color", (0, 255, 0)))
        self.thickness = self.config.get("thickness", 2)
        self.max_blobs = self.config.get("max_blobs", 64)

    def apply(self, image, aux):
        if image.dim() >= 3 and image.shape[-1] == 3:
            gray = color.bgr_to_gray(image)
            binary = thresh_ops.threshold(gray, 127, 255, "binary")
        else:
            binary = image
        mask = (binary > 0).contiguous()
        labels, table = label_and_table(
            mask, binary.contiguous(), band=TILED_BAND,
            max_blobs=self.max_blobs, use_color=False)
        ok = (table.valid & (table.area >= self.min_area)
              & (table.area <= self.max_area))
        aux[self.name] = {"labels": labels, "table": table, "ok": ok}
        if not self.draw:
            return image
        keep = _pixel_keep_mask(labels, mask, ok)
        boundary = keep & ~_erode_bool(keep, self.thickness)
        canvas = image if (image.dim() >= 3 and image.shape[-1] == 3) \
            else color.gray_to_bgr(image)
        # the colour as scalars: a colour tensor copied from the host would
        # wait for the card
        return torch.stack([torch.where(boundary, c, canvas[..., i])
                            for i, c in enumerate(self.color)], -1)

    def host_post(self, aux_np, context):
        data = aux_np.get(self.name)
        if data is None:
            return
        labels = np.asarray(data["labels"])
        table = data["table"]
        ok = np.asarray(data["ok"])
        # Only single-image contexts get full contour lists.
        if labels.ndim == 3 and labels.shape[0] == 1:
            found = []
            for k in np.nonzero(ok[0])[0]:
                bbox = (int(table.x[0][k]), int(table.y[0][k]),
                        int(table.w[0][k]), int(table.h[0][k]))
                crop_labels = labels[0]
                pts = contours_mod.blob_contour(
                    crop_labels, _label_of_blob(crop_labels, bbox), bbox)
                found.append(pts)
            context["contours"] = found
            context["contour_count"] = len(found)
        else:
            context["contour_count"] = int(ok.sum())


class HoughLinesStage(ProcessingStage):
    """Probabilistic Hough lines (reference pipeline.py:445-503).

    The accumulator counts on the stage's device, segment extraction runs
    on the host (ops/hough.py); the image passes through unchanged.
    """

    def __init__(self, name, config=None):
        super().__init__(name, config)
        self.rho = self.config.get("rho", 1)
        self.theta_bins = 180
        self.threshold = self.config.get("threshold", 100)
        self.min_line_length = self.config.get("min_line_length", 50)
        self.max_line_gap = self.config.get("max_line_gap", 10)
        self.draw = self.config.get("draw", True)
        self.color = tuple(self.config.get("color", (0, 0, 255)))
        self.thickness = self.config.get("thickness", 2)

    def apply(self, image, aux):
        gray = color.bgr_to_gray(image)
        aux[self.name] = {"edges": gray}
        return image

    def host_post(self, aux_np, context):
        data = aux_np.get(self.name)
        if data is None:
            return
        edges = np.asarray(data["edges"])
        # batched contexts keep the first frame's line list (segment
        # extraction is per frame; loop externally for per-frame lines)
        edges2d = edges[0] if edges.ndim == 3 else edges
        lines = hough.hough_lines_p(
            edges2d, self.threshold, self.min_line_length,
            self.max_line_gap, self.rho, self.theta_bins,
            device=resolve_device(self.device))
        context["lines"] = lines
        context["line_count"] = len(lines)


class HistogramEqualizationStage(ProcessingStage):
    """Global equalization or CLAHE (reference pipeline.py:506-531)."""

    def __init__(self, name, config=None):
        super().__init__(name, config)
        self.clahe = self.config.get("clahe", False)
        self.clip_limit = self.config.get("clip_limit", 2.0)
        self.tile_size = self.config.get("tile_size", 8)

    def apply(self, image, aux):
        gray = color.bgr_to_gray(image)
        if self.clahe:
            return histogram.clahe(gray, self.clip_limit, self.tile_size)
        return histogram.equalize_hist(gray)


# ---------------------------------------------------------------------------

class PipelineFactory:
    """Builds the five reference pipeline types
    (reference pipeline.py:130-205, same stage parameters)."""

    @staticmethod
    def create_pipeline(name: str, pipeline_type: str,
                        config: Dict[str, Any] = None,
                        device=None) -> Pipeline:
        pipeline = Pipeline(name, config, device=device)
        if pipeline_type == "basic":
            pipeline.add_stage(GrayscaleStage("grayscale"))
            pipeline.add_stage(GaussianBlurStage("blur", {"kernel_size": 5}))
            pipeline.add_stage(CannyEdgeStage("edges"))
        elif pipeline_type == "bottle_base":
            pipeline.add_stage(GrayscaleStage("grayscale"))
            pipeline.add_stage(GaussianBlurStage("blur", {"kernel_size": 5}))
            pipeline.add_stage(AdaptiveThresholdStage("threshold"))
            pipeline.add_stage(MorphologyStage("morphology", {
                "operation": "MORPH_CLOSE", "kernel_size": 5}))
            pipeline.add_stage(ContourDetectionStage("contours", {
                "min_area": 50, "draw": True}))
        elif pipeline_type == "sidewall":
            pipeline.add_stage(GrayscaleStage("grayscale"))
            pipeline.add_stage(GaussianBlurStage("blur", {"kernel_size": 3}))
            pipeline.add_stage(CannyEdgeStage("edges", {
                "threshold1": 30, "threshold2": 120}))
            pipeline.add_stage(HoughLinesStage("lines"))
        elif pipeline_type == "preform":
            pipeline.add_stage(GrayscaleStage("grayscale"))
            pipeline.add_stage(HistogramEqualizationStage("equalize"))
            pipeline.add_stage(GaussianBlurStage("blur", {"kernel_size": 3}))
            pipeline.add_stage(ThresholdStage("threshold", {
                "method": "THRESH_OTSU"}))
        elif pipeline_type == "contamination":
            pipeline.add_stage(GrayscaleStage("grayscale"))
            pipeline.add_stage(GaussianBlurStage("blur", {"kernel_size": 3}))
            pipeline.add_stage(ThresholdStage("threshold", {
                "method": "THRESH_BINARY_INV", "threshold": 50}))
            pipeline.add_stage(MorphologyStage("morphology", {
                "operation": "MORPH_OPEN", "kernel_size": 3,
                "iterations": 1}))
        else:
            raise ValueError(f"Unsupported pipeline type: {pipeline_type}")
        return pipeline


# ---------------------------------------------------------------------------
# helpers

def _cv_name_to_method(name) -> str:
    mapping = {
        "THRESH_BINARY": "binary", 0: "binary",
        "THRESH_BINARY_INV": "binary_inv", 1: "binary_inv",
        "THRESH_TRUNC": "trunc", 2: "trunc",
        "THRESH_TOZERO": "tozero", 3: "tozero",
        "THRESH_TOZERO_INV": "tozero_inv", 4: "tozero_inv",
    }
    return mapping.get(name, name if isinstance(name, str) else "binary")


def _pixel_keep_mask(labels: torch.Tensor, mask: torch.Tensor,
                     ok: torch.Tensor) -> torch.Tensor:
    """Per-pixel bool [B, H, W]: the pixel belongs to a blob whose table
    slot passed.  A blob is ranked by its root in raster order; blobs past
    the last slot take the last slot's verdict, as in the JAX package."""
    B, H, W = labels.shape
    HW = H * W
    K = ok.shape[-1]
    lab = labels.reshape(B, HW).to(torch.int64)
    m = mask.reshape(B, HW)
    is_root = m & (lab == torch.arange(HW, device=labels.device))
    compact = is_root.to(torch.int32).cumsum(-1) - 1
    comp_at_root = torch.where(is_root, compact, 0)
    padded = torch.cat([comp_at_root, comp_at_root.new_zeros((B, 1))], -1)
    bid = padded.gather(1, lab).clamp(max=K - 1).to(torch.int64)
    keep = ok.gather(1, bid) & m
    return keep.reshape(B, H, W)


def _erode_bool(mask: torch.Tensor, thickness: int) -> torch.Tensor:
    """Binary erosion by a (2t-1) square (at least 3), outside the frame
    False: used for boundary thickness."""
    k = max(2 * thickness - 1, 3)
    r = k // 2
    H, W = mask.shape[-2], mask.shape[-1]
    mp = filters._pad2d(mask, r, r, "constant", False)
    rows = mp[..., 0:W]
    for dj in range(1, k):
        rows = rows & mp[..., dj:dj + W]
    out = rows[..., 0:H, :]
    for di in range(1, k):
        out = out & rows[..., di:di + H, :]
    return out
