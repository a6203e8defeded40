"""The port's pipelines against heimdall_tpu's (JAX on the CPU): every
stage, and all five PipelineFactory types through process and
process_batch.

The same seeded simulation frames (and frames with long dark lines, so
that the Hough stage finds lines) go to both; result images, stage
results, contour lists, contour counts and line segments must be exactly
equal.  The port runs with device="cpu": the contour stage's band-tiled
labeling and statistics run their plain versions.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heimdall_tpu.core import pipeline as jpipe
from heimdall_tpu.core.acquisition import SimulationImageSource as JaxSim

from heimdall_tpu_torch.core import pipeline as tpipe

H, W = 120, 160
TYPES = ("basic", "bottle_base", "sidewall", "preform", "contamination")


@functools.lru_cache(maxsize=None)
def _frames():
    """4 simulation frames (seed 0, defects likely) and 2 with lines."""
    src = JaxSim("cam", {"width": W, "height": H, "seed": 0,
                         "defect_probability": 0.6})
    _, sim = src.read_batch(4)
    lines = np.full((2, H, W, 3), 200, np.uint8)
    lines[0, 40:43, 5:155] = 30
    lines[0, 10:110, 70:73] = 60
    for t in range(100):
        lines[1, 10 + t, 20 + t:23 + t] = 40
    lines[1, 90:93, 10:150] = 50
    return np.concatenate([sim, lines])


@functools.lru_cache(maxsize=None)
def _jax_batch(ptype):
    p = jpipe.PipelineFactory.create_pipeline("p", ptype)
    ctx = p.process_batch(_frames(), capture_stages=True)
    return _host(ctx)


@functools.lru_cache(maxsize=None)
def _jax_single(ptype, i):
    p = jpipe.PipelineFactory.create_pipeline("p", ptype)
    return _host(p.process(_frames()[i]))


def _host(ctx):
    out = {}
    for k, v in ctx.items():
        if k == "stage_results":
            out[k] = {s: np.asarray(x) for s, x in v.items()}
        elif k in ("result_image", "current_image"):
            out[k] = np.asarray(v)
        else:
            out[k] = v
    return out


def _assert_ctx_equal(want, got):
    np.testing.assert_array_equal(got["result_image"], want["result_image"])
    assert got["result_image"].dtype == want["result_image"].dtype
    assert set(got.get("stage_results", {})) == set(
        want.get("stage_results", {}))
    for s, v in want.get("stage_results", {}).items():
        np.testing.assert_array_equal(got["stage_results"][s], v, err_msg=s)
    for key in ("contour_count", "line_count"):
        assert got.get(key) == want.get(key), key
    assert ("contours" in got) == ("contours" in want)
    if "contours" in want:
        assert len(got["contours"]) == len(want["contours"])
        for a, b in zip(got["contours"], want["contours"]):
            np.testing.assert_array_equal(a, b)
    assert ("lines" in got) == ("lines" in want)
    if "lines" in want:
        np.testing.assert_array_equal(got["lines"], want["lines"])
    assert got["success"] is True and want["success"] is True


@pytest.mark.parametrize("ptype", TYPES)
def test_process_batch(ptype):
    p = tpipe.PipelineFactory.create_pipeline("p", ptype, device="cpu")
    got = p.process_batch(_frames(), capture_stages=True)
    _assert_ctx_equal(_jax_batch(ptype), got)
    assert [s.name for s in p.stages] == list(got["stage_results"])


@pytest.mark.parametrize("ptype,i", [(t, 0) for t in TYPES]
                         + [("sidewall", 4)])
def test_process_single(ptype, i):
    p = tpipe.PipelineFactory.create_pipeline("p", ptype, device="cpu")
    got = p.process(_frames()[i])
    want = _jax_single(ptype, i)
    _assert_ctx_equal(want, got)
    assert set(got["stage_times"]) == set(want["stage_times"]) == {
        "<fused>"}
    assert got["pipeline_name"] == "p"


def test_found_contours_and_lines():
    """The frames give the checks something to compare."""
    assert _jax_batch("bottle_base")["contour_count"] > 0
    assert len(_jax_single("bottle_base", 0)["contours"]) > 0
    assert _jax_single("sidewall", 4)["line_count"] > 0


def test_process_batch_device_only_keeps_tensors():
    p = tpipe.PipelineFactory.create_pipeline("p", "bottle_base",
                                              device="cpu")
    ctx = p.process_batch(torch.from_numpy(_frames()), device_only=True)
    assert isinstance(ctx["result_image"], torch.Tensor)
    np.testing.assert_array_equal(ctx["result_image"].numpy(),
                                  _jax_batch("bottle_base")["result_image"])
    assert "contour_count" not in ctx
    aux = ctx["aux"]["contours"]
    assert isinstance(aux["labels"], torch.Tensor)
    assert int(aux["ok"].sum()) == _jax_batch("bottle_base")["contour_count"]


@pytest.mark.parametrize("ptype", ["bottle_base", "sidewall"])
def test_instrumented(ptype):
    jp = jpipe.PipelineFactory.create_pipeline(
        "p", ptype, {"instrumented": True})
    tp = tpipe.PipelineFactory.create_pipeline(
        "p", ptype, {"instrumented": True}, device="cpu")
    frame = _frames()[4 if ptype == "sidewall" else 0]
    want, got = _host(jp.process(frame)), tp.process(frame)
    _assert_ctx_equal(want, got)
    assert set(got["stage_times"]) == set(want["stage_times"]) == {
        s.name for s in tp.stages}


def test_unknown_type_raises_as_in_jax():
    with pytest.raises(ValueError, match="Unsupported pipeline type"):
        jpipe.PipelineFactory.create_pipeline("p", "bogus")
    with pytest.raises(ValueError, match="Unsupported pipeline type"):
        tpipe.PipelineFactory.create_pipeline("p", "bogus", device="cpu")


def test_failing_stage_reports_as_in_jax():
    def boom(module):
        class Boom(module.ProcessingStage):
            def apply(self, image, aux):
                raise RuntimeError("boom")
        return Boom("boom")

    want = jpipe.Pipeline("p").add_stage(boom(jpipe)).process(_frames()[0])
    got = tpipe.Pipeline("p", device="cpu").add_stage(
        boom(tpipe)).process(_frames()[0])
    for ctx in (want, got):
        assert ctx["success"] is False and ctx["error"] == "boom"
        assert "result_image" not in ctx
    assert got["error_stage"] == want["error_stage"]


# Every stage class alone, with the configurations the factory does not
# use: (class name, config, input "bgr", "gray" or "mask").
STAGES = [
    ("GrayscaleStage", {}, "bgr"),
    ("GaussianBlurStage", {"kernel_size": 7, "sigma": 1.5}, "bgr"),
    ("CannyEdgeStage", {"L2gradient": True, "threshold1": 90,
                        "threshold2": 40}, "bgr"),
    ("AdaptiveThresholdStage", {"method": "ADAPTIVE_THRESH_MEAN_C",
                                "threshold_type": "THRESH_BINARY_INV",
                                "block_size": 7, "C": 3}, "bgr"),
    ("AdaptiveThresholdStage", {"threshold_type": 1, "C": 5}, "gray"),
    ("MorphologyStage", {"operation": "MORPH_GRADIENT",
                         "kernel_shape": "ellipse", "kernel_size": 5},
     "gray"),
    ("MorphologyStage", {"operation": 6, "kernel_shape": "cross",
                         "kernel_size": 3, "iterations": 2}, "mask"),
    ("ThresholdStage", {"method": "THRESH_TRIANGLE"}, "bgr"),
    ("ThresholdStage", {"method": "THRESH_TRUNC", "threshold": 150},
     "gray"),
    ("ThresholdStage", {"method": 4, "threshold": 90.5}, "bgr"),
    ("ContourDetectionStage", {"min_area": 10, "max_area": 400,
                               "thickness": 1, "color": (255, 0, 0)},
     "bgr"),
    ("ContourDetectionStage", {"draw": False, "max_blobs": 4}, "mask"),
    ("ContourDetectionStage", {"thickness": 3, "max_blobs": 2}, "mask"),
    ("HoughLinesStage", {"threshold": 60, "min_line_length": 30,
                         "max_line_gap": 4}, "mask"),
    ("HistogramEqualizationStage", {"clahe": True, "clip_limit": 3.0,
                                    "tile_size": 4}, "bgr"),
]


def _stage_input(kind):
    """The frames as BGR, as their G plane, or as a 0/255 mask of it."""
    frames = _frames()
    if kind == "bgr":
        return frames
    gray = np.ascontiguousarray(frames[..., 1])
    return gray if kind == "gray" else np.where(gray < 120, 255, 0).astype(
        np.uint8)


@pytest.mark.parametrize("cls,cfg,kind", STAGES,
                         ids=[f"{c}-{i}" for i, (c, _, _) in
                              enumerate(STAGES)])
def test_stage(cls, cfg, kind):
    x = _stage_input(kind)
    jp = jpipe.Pipeline("p").add_stage(getattr(jpipe, cls)("s", cfg))
    tp = tpipe.Pipeline("p", device="cpu").add_stage(
        getattr(tpipe, cls)("s", cfg))
    want = _host(jp.process_batch(x, capture_stages=True))
    if cls == "HistogramEqualizationStage":
        # XLA's jit contracts CLAHE's bilinear blend into fused
        # multiply-adds (ROADMAP.md §C): hold the stage against the JAX
        # stage run eagerly, as the op tests hold clahe.
        eager = np.asarray(jp.stages[0].apply(jnp.asarray(x), {}))
        assert 0 < (eager != want["result_image"]).sum() <= 4
        want["result_image"] = want["stage_results"]["s"] = eager
    _assert_ctx_equal(want, tp.process_batch(x, capture_stages=True))
