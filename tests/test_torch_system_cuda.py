"""The system path on the card against the port's CPU path (marked
``cuda``; each test skips where torch.cuda.is_available() is false): every
PipelineFactory type, the contour stage through the band-tiled kernels,
and ContaminationInspector.inspect_batch.  This file imports no JAX:

    python -m pytest tests/test_torch_system_cuda.py -q -m cuda --noconftest

Equality is exact: result images, contour and line counts, line segments
and defects (the detector's table formulas are the same float32
operations in the same order on both devices).
"""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.core.acquisition import SimulationImageSource
from heimdall_tpu_torch.core.pipeline import PipelineFactory
from heimdall_tpu_torch.inspection import ContaminationInspector
from heimdall_tpu_torch.ops import ccl, ccl_tiled, stats_tiled

TYPES = ("basic", "bottle_base", "sidewall", "preform", "contamination")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _sim(n, h, w, seed=0, p=0.3):
    src = SimulationImageSource("cam", {"width": w, "height": h,
                                        "seed": seed,
                                        "defect_probability": p})
    src.open()
    return src.read_batch(n)[1]


def _assert_ctx_equal(got, want):
    np.testing.assert_array_equal(got["result_image"], want["result_image"])
    for key in ("contour_count", "line_count"):
        assert got.get(key) == want.get(key), key
    if "lines" in want:
        np.testing.assert_array_equal(got["lines"], want["lines"])


@pytest.mark.cuda
@pytest.mark.parametrize("ptype", TYPES)
@pytest.mark.parametrize("hw", [(480, 640), (1080, 1920)])
def test_pipeline_types_equal_cpu(card, ptype, hw):
    frames = np.concatenate([_sim(2, *hw), scene.make_frames(2, *hw,
                                                             seed=1)])
    got = PipelineFactory.create_pipeline("p", ptype, device=card)
    want = PipelineFactory.create_pipeline("p", ptype, device="cpu")
    _assert_ctx_equal(got.process_batch(frames), want.process_batch(frames))
    one_got, one_want = got.process(frames[0]), want.process(frames[0])
    _assert_ctx_equal(one_got, one_want)
    if "contours" in one_want:
        assert len(one_got["contours"]) == len(one_want["contours"])
        for a, b in zip(one_got["contours"], one_want["contours"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_contour_stage_launches_the_tiled_kernels(card, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for module, name in ((ccl, "connected_components"),
                         (ccl_tiled, "connected_components"),
                         (ccl_tiled, "band_ccl_reference"),
                         (ccl_tiled, "merge_reference"),
                         (stats_tiled, "banded_stats_reference"),
                         (stats_tiled, "bbox_sums_reference")):
        monkeypatch.setattr(module, name, plain)
    frames = scene.make_frames(8, 1080, 1920, seed=2)
    p = PipelineFactory.create_pipeline("p", "bottle_base", device=card)
    names = ("band_ccl", "merge_bands")
    before = [getattr(ccl_tiled, n).launches for n in names] + [
        stats_tiled.banded_stats.launches, stats_tiled.bbox_sums.launches]
    ctx = p.process_batch(frames, device_only=True)
    torch.cuda.synchronize()
    after = [getattr(ccl_tiled, n).launches for n in names] + [
        stats_tiled.banded_stats.launches, stats_tiled.bbox_sums.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    assert ctx["result_image"].is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(480, 640), (1080, 1920)])
def test_inspect_batch_equals_cpu(card, hw):
    frames = _sim(8, *hw, seed=0, p=0.3)
    got = ContaminationInspector("i", device=card).inspect_batch(frames)
    want = ContaminationInspector("i", device="cpu").inspect_batch(frames)
    for a, b in zip(got, want):
        assert a.success and b.success
        assert [d.to_dict() for d in a.defects] == [
            d.to_dict() for d in b.defects]
