"""Contamination detector on PyTorch/CUDA (port of
heimdall_tpu/detectors/contamination_detector.py).

Per frame: gray -> GaussianBlur(5,5) -> adaptiveThreshold(GAUSSIAN_C,
BINARY_INV, block 11, C=contrast_threshold) -> open then close (3x3 rect)
-> hole fill -> 8-connected components -> per-blob statistics and the
confidence blend 0.5*intensity + 0.2*shape + 0.3*color, then the size and
confidence gates.  Frames of up to MAX_FRAME_PX (400,000) pixels go through
the fused kernel of ops/fused_kernels.py; larger ones (the 1920x1080 design
point) through ``contamination_program``'s tiled routes: BGR frames through
the run tables (ops/preprocess_tiled.py, ops/runtable_tiled.py), Mono8
frames through the bands (the fused kernel's preprocess stages, then
ops/ccl_tiled.py), both then through ops/stats_tiled.py.  On the card each
stage launches its CUDA kernel; on the CPU its plain version.

Host-side work is the frame upload, the download of the small blob table
and, only when contour metadata is requested, border following on the
returned label image.
"""

from collections import Counter
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from heimdall_tpu_torch.detectors.base import Defect, DefectDetector
from heimdall_tpu_torch.ops.blobs import BlobTable
from heimdall_tpu_torch.ops.ccl_tiled import (connected_components_tiled,
                                              fill_holes_tiled)
from heimdall_tpu_torch.ops.fused_kernels import (MAX_FRAME_PX,
                                                  frame_layout, fused_detect,
                                                  gate, preprocess)
from heimdall_tpu_torch.ops.preprocess_tiled import (
    contamination_preprocess_tiled)
from heimdall_tpu_torch.ops.runtable_tiled import fill_label_runtable_tiled
from heimdall_tpu_torch.ops.stats_tiled import (blob_stats_tiled,
                                                check_sum_bound)
from heimdall_tpu_torch.utils import contours as contours_mod

# Config keys of the JAX detector that tune or route its TPU build only.
TPU_TUNING_KEYS = ("backend", "ccl_sweeps", "ccl_adaptive", "ccl_scan_steps",
                   "rt_ccl", "rt_fill")


# Rows per band of the tiled routes that run_device takes for large frames.
TILED_BAND = 128


def contamination_program(images: torch.Tensor, contrast_threshold,
                          min_size, max_size, min_confidence,
                          max_blobs: int = 64, use_color: bool = True,
                          formula: str = "python",
                          return_labels: bool = False, tiled_band: int = 0,
                          channel_major: bool = False,
                          tiled_runtable: bool = True, rt_bg: int = 8,
                          rt_fg: int = 7):
    """The batched detection program (counterpart of the JAX
    contamination_program, without its TPU tuning knobs).

    images: uint8 [N, H, W, 3] BGR, [N, H, W] Mono8, or with
    channel_major=True [N, 3|1, H, W] planes, on the device it runs on.
    With tiled_band = 0 the batch goes through the fused kernel
    (ops/fused_kernels.py::fused_detect, frames of up to MAX_FRAME_PX).
    With tiled_band > 0, on bands of min(tiled_band, 128) rows: BGR frames
    with tiled_runtable take contamination_preprocess_tiled (with the
    background run tables) -> fill_label_runtable_tiled (rt_bg / rt_fg runs
    per row before a frame falls back to the bands); Mono8 frames (and BGR
    without tiled_runtable) take preprocess -> fill_holes_tiled ->
    connected_components_tiled; then blob_stats_tiled -> confidence ->
    gates.  Every route gives the same outputs.

    Returns (table: BlobTable, confidence [N,K] f32, accepted [N,K] bool
    [, labels int32 [N,H,W]])."""
    if tiled_band <= 0:
        return fused_detect(images, contrast_threshold, min_size, max_size,
                            min_confidence, max_blobs, use_color, formula,
                            channel_major, return_labels)
    band = min(tiled_band, 128)
    _, C, H, W, _, _ = frame_layout(images, channel_major)
    check_sum_bound(H, W)
    if C == 3 and tiled_runtable:
        binary, gray, *bg_tables = contamination_preprocess_tiled(
            images, contrast_threshold, channel_major, bg_tables=rt_bg)
        mask, labels, rl, n, slot_list, slot_count = (
            fill_label_runtable_tiled(binary, band, max_blobs=max_blobs,
                                      r_bg=rt_bg, r_fg=rt_fg,
                                      pre_extracted=bg_tables))
    else:
        gray, binary = preprocess(images, contrast_threshold, channel_major)
        mask = fill_holes_tiled(binary, band=band)
        labels, rl, n, slot_list, slot_count = connected_components_tiled(
            mask, connectivity=8, band=band, return_roots=max_blobs,
            band_slots=True)
    table = blob_stats_tiled(labels, mask, gray,
                             images if C == 3 else None, band=band,
                             max_blobs=max_blobs, use_color=use_color,
                             root_table=rl, root_count=n,
                             slot_list=slot_list, slot_count=slot_count,
                             channel_major=channel_major)
    conf, accepted = gate(table, min_size, max_size, min_confidence, formula)
    return (table, conf, accepted) + ((labels,) if return_labels else ())


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def config_from_reference(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The port's config from a heimdall_tpu ContaminationDetector config:
    every key keeps its meaning; the TPU tuning keys are dropped."""
    return {k: v for k, v in (cfg or {}).items() if k not in TPU_TUNING_KEYS}


_NUMPY_DTYPES = {torch.bool: np.bool_, torch.int32: np.int32,
                 torch.int64: np.int64}


def download_table(table: BlobTable, conf: torch.Tensor,
                   accepted: torch.Tensor):
    """(BlobTable, confidence, accepted) as numpy arrays, in one transfer:
    every [N, K] field packed as int32 words (float32 by its bits) into one
    device tensor, with n_blobs as one more row."""
    n, k = conf.shape
    fields = list(table[:-1]) + [conf, accepted]
    words = [f.view(torch.int32) if f.dtype == torch.float32
             else f.to(torch.int32) for f in fields]
    last = torch.zeros((n, k), dtype=torch.int32, device=conf.device)
    last[:, 0] = table.n_blobs
    host = torch.stack(words + [last], 1).cpu().numpy()
    out = [np.ascontiguousarray(host[:, i]).view(np.float32)
           if f.dtype == torch.float32
           else host[:, i].astype(_NUMPY_DTYPES[f.dtype])
           for i, f in enumerate(fields)]
    tbl = BlobTable(*out[:-2], host[:, -1, 0].astype(
        _NUMPY_DTYPES[table.n_blobs.dtype]))
    return tbl, out[-2], out[-1]


def _label_of_blob(labels: np.ndarray, bbox) -> int:
    """Recover the CCL label value of the blob occupying bbox
    (copy of heimdall_tpu/core/pipeline.py::_label_of_blob)."""
    x, y, w, h = bbox
    H, W = labels.shape
    crop = labels[y:y + h, x:x + w]
    vals = crop[crop != H * W]
    if len(vals) == 0:
        return H * W
    return Counter(vals.tolist()).most_common(1)[0][0]


class ContaminationDetector(DefectDetector):
    """API-parity contamination detector, device-batched.

    Defaults match the reference: min 10 / max 3000 / contrast 15 /
    confidence 0.25 / use_color True, K = 64 blob slots.

    The JAX detector's TPU tuning keys (``backend``, ``ccl_sweeps``,
    ``ccl_adaptive``, ``ccl_scan_steps``, ``rt_ccl``, ``rt_fill``) are
    accepted and ignored: frames of up to 400,000 px take the fused route
    and larger ones (up to the int32 sum bound, about 2.2 MP) the tiled
    routes (run tables for BGR, bands for Mono8), on the card and on the
    CPU alike; all give the fixpoint results the JAX defaults give.

    ``device`` defaults to CUDA; construction raises when no card is
    present unless ``device="cpu"`` is passed.  A ``ccl_scan_steps`` of 0
    or less raises ValueError, as in the JAX detector.
    """

    def __init__(self, name: str = "contamination_detector",
                 config: Dict[str, Any] = None, device=None):
        super().__init__(name, config)
        scan_steps = self.config.get("ccl_scan_steps", 5)
        if scan_steps is not None and scan_steps < 1:
            # the JAX detector's check: None (full-width scans) is its "off"
            raise ValueError(
                f"ccl_scan_steps must be None or >= 1, got {scan_steps}")
        self.device = resolve_device(device)
        self.min_contaminant_size = self.config.get("min_contaminant_size", 10)
        self.max_contaminant_size = self.config.get("max_contaminant_size", 3000)
        self.contrast_threshold = self.config.get("contrast_threshold", 15)
        self.min_confidence = self.config.get("min_confidence", 0.25)
        self.use_color = self.config.get("use_color", True)
        self.max_blobs = self.config.get("max_blobs", 64)
        self.formula = self.config.get("confidence_formula", "python")
        self.include_contours = self.config.get("include_contours", True)
        # exact_geometry replaces the device approximations (Pick's-theorem
        # area, pixel centroid) with bit-exact polygon geometry traced
        # host-side, and re-applies the gates with it.  "auto" traces the
        # accepted blobs plus any blob within 2 px^2 / 0.02 conf of a gate;
        # True traces every valid blob; False keeps raw device values.
        self.exact_geometry = self.config.get("exact_geometry", "auto")
        self.logger.info(
            "Detector %s initialized with min_size=%s, max_size=%s, "
            "threshold=%s on %s", self.name, self.min_contaminant_size,
            self.max_contaminant_size, self.contrast_threshold, self.device)

    # -- device execution --------------------------------------------------
    def _upload(self, images) -> torch.Tensor:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if images.dtype == torch.uint16:
            # Mono10/12/16 cameras: use the high byte (the reference's
            # pipeline operates on 8-bit data throughout)
            images = (images.to(torch.int32) >> 8).to(torch.uint8)
        return images.to(self.device).contiguous()

    def run_device(self, images, return_labels: bool = False,
                   channel_major: bool = False):
        """Run the batch on the detector's device; returns device tensors
        (table: BlobTable, confidence [N,K], accepted [N,K][, labels]).

        Input forms: [N, H, W, 3] BGR, [N, H, W] Mono8, or with
        channel_major=True [N, 3|1, H, W] planes (the feeder layout).
        uint8, or uint16 (the high byte is used)."""
        images = self._upload(images)
        if channel_major and (images.dim() != 4
                              or images.shape[1] not in (1, 3)):
            raise ValueError(
                f"channel_major expects [N, 1|3, H, W], got "
                f"{tuple(images.shape)}")
        _, _, H, W, _, _ = frame_layout(images, channel_major)
        return contamination_program(
            images, int(self.contrast_threshold),
            float(self.min_contaminant_size),
            float(self.max_contaminant_size), float(self.min_confidence),
            max_blobs=self.max_blobs, use_color=self.use_color,
            formula=self.formula, return_labels=return_labels,
            tiled_band=TILED_BAND if H * W > MAX_FRAME_PX else 0,
            channel_major=channel_major)

    def verdict_device(self, images, channel_major: bool = False):
        """Per-frame reject flag (any accepted blob) and max accepted
        confidence, reduced on the device: two [N] tensors."""
        _, conf, accepted = self.run_device(images,
                                            channel_major=channel_major)
        return (accepted.any(dim=1),
                torch.where(accepted, conf, 0.0).max(dim=1).values)

    # -- host API ----------------------------------------------------------
    def detect(self, image: np.ndarray,
               context: Dict[str, Any] = None) -> List[Defect]:
        """Single-image reference-compatible API."""
        return self.detect_batch(np.asarray(image)[None], context)[0]

    def detect_batch(self, images,
                     context: Dict[str, Any] = None) -> List[List[Defect]]:
        """Batched detection: one device call for the whole batch.

        images: a numpy array, or a tensor (on the detector's device it is
        used in place).  The blob table, confidences and gates come back in
        one download; the label planes in a second, only when contours or
        exact geometry are wanted."""
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        want_contours = (self.include_contours or self.exact_geometry) and (
            context is None or context.get("include_contours", True))
        out = self.run_device(images, return_labels=want_contours)
        table, conf, accepted = download_table(*out[:3])
        labels_np = out[3].cpu().numpy() if want_contours else None
        return self._table_to_defects(table, conf, accepted, labels_np)

    def _candidate_slots(self, i, table, conf, accepted, valid):
        """Blob slots worth host-side work for frame i under "auto" exact
        geometry: everything accepted, plus any valid blob whose device
        area/confidence sits within the approximation margin of a gate
        boundary — those can flip accept/reject once re-measured exactly."""
        area = np.asarray(table.area[i], np.float64)
        near_size = np.minimum(np.abs(area - self.min_contaminant_size),
                               np.abs(area - self.max_contaminant_size)) <= 2
        in_size_loose = ((area >= self.min_contaminant_size - 2)
                         & (area <= self.max_contaminant_size + 2))
        near_conf = np.abs(np.asarray(conf[i], np.float64)
                           - self.min_confidence) <= 0.02
        boundary = valid[i] & in_size_loose & (near_size | near_conf)
        return np.nonzero(accepted[i] | boundary)[0]

    def _table_to_defects(self, table, conf, accepted,
                          labels: Optional[np.ndarray]) -> List[List[Defect]]:
        mode = self.exact_geometry
        exact = mode and labels is not None     # True or "auto"
        results: List[List[Defect]] = []
        n = accepted.shape[0]
        valid = np.asarray(table.valid)
        accepted = np.asarray(accepted)
        for i in range(n):
            defects: List[Defect] = []
            if not exact:
                candidates = np.nonzero(accepted[i])[0]
            elif mode == "auto":
                candidates = self._candidate_slots(i, table, conf, accepted,
                                                   valid)
            else:
                candidates = np.nonzero(valid[i])[0]
            for k in candidates:
                bbox = (int(table.x[i][k]), int(table.y[i][k]),
                        int(table.w[i][k]), int(table.h[i][k]))
                position = (int(table.cx[i][k]), int(table.cy[i][k]))
                area = float(table.area[i][k])
                confidence = float(conf[i][k])
                shape_score = float(table.shape_score[i][k])
                pts = None
                if exact:
                    geom = contours_mod.exact_blob_geometry(
                        labels[i], _label_of_blob(labels[i], bbox), bbox)
                    area = geom["area"]
                    position = geom["position"]
                    pts = geom["contour"]
                    if not (self.min_contaminant_size <= area
                            <= self.max_contaminant_size):
                        continue
                    rect_area = bbox[2] * bbox[3]
                    shape_score = 1.0 - (area / rect_area
                                         if rect_area > 0 else 0.0)
                    if self.formula == "native":
                        confidence = (0.7 * float(
                            table.intensity_score[i][k])
                            + 0.3 * shape_score)
                    else:
                        confidence = (0.5 * float(
                            table.intensity_score[i][k])
                            + 0.2 * shape_score
                            + 0.3 * float(table.color_score[i][k]))
                    if confidence < self.min_confidence:
                        continue
                metadata: Dict[str, Any] = {
                    "intensity_diff": float(table.intensity_diff[i][k]),
                    "shape_score": shape_score,
                    "color_score": float(table.color_score[i][k]),
                    "bounding_box": bbox,
                }
                if labels is not None and self.include_contours:
                    if pts is None:
                        pts = contours_mod.blob_contour(
                            labels[i], _label_of_blob(labels[i], bbox), bbox)
                    metadata["contour"] = pts.tolist()
                defects.append(Defect(
                    defect_type="contamination",
                    position=position,
                    size=area,
                    confidence=confidence,
                    metadata=metadata))
            results.append(defects)
        return results

    # -- visualization -----------------------------------------------------
    def visualize(self, image: np.ndarray,
                  defects: List[Defect]) -> np.ndarray:
        from heimdall_tpu_torch.utils import draw
        if image.ndim == 2:
            viz = np.stack([image] * 3, axis=-1)
        else:
            viz = image.copy()
        for defect in defects:
            if defect.defect_type != "contamination":
                continue
            green = int(255 * (1 - defect.confidence))
            red = int(255 * defect.confidence)
            color = (0, green, red)  # BGR
            if "bounding_box" in defect.metadata:
                x, y, w, h = defect.metadata["bounding_box"]
                draw.rect_outline(viz, (x, y), (x + w, y + h), color, 2)
                if "contour" in defect.metadata:
                    pts = np.asarray(defect.metadata["contour"],
                                     np.int32).reshape(-1, 2)
                    draw.polylines(viz, [tuple(p) for p in pts], color, 2)
                draw.put_text(viz, f"{defect.confidence:.2f}", (x, y - 5),
                              color, 1)
            else:
                radius = int(np.sqrt(max(defect.size, 0) / np.pi))
                draw.circle_outline(viz, defect.position, radius, color, 2)
        return viz
