"""The serving path on the card against the port's CPU path (marked
``cuda``; each test skips where torch.cuda.is_available() is false): the
dashboard's loop through the fused kernel, the multi-class detector at
640x480 (fused kernel) and 1920x1080 Mono8 (band route), the models, and
demosaic/YUV.  This file imports no JAX:

    python -m pytest tests/test_torch_serving_cuda.py -q -m cuda --noconftest

Integer outputs, tables and defects are exact; the float32 UNet within
1e-5 (cuDNN sums in another order, TF32 off), the int8 UNet's logits
exact and its probabilities within 1e-6, the bf16 models within 1e-4 (a
few times the 2.3e-5 that chip_smoke.py reads for the classifier).
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.detectors.multi_defect import (
    MultiClassDefectDetector)
from heimdall_tpu_torch.models import anomaly, defect_classifier, quantized
from heimdall_tpu_torch.models import segmentation
from heimdall_tpu_torch.ops import demosaic, fused_kernels, stats_tiled
from heimdall_tpu_torch.ops import ccl_tiled
from heimdall_tpu_torch.serving import DashboardServer


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _defect_rows(results):
    return [[d.to_dict() for d in r] for r in results]


@pytest.mark.cuda
def test_dashboard_serves_frames_through_the_fused_kernel(card):
    srv = DashboardServer(port=0, device=card)
    srv.start_background()
    fused_kernels.contamination_fused.launches = 0
    try:
        srv.state.start()
        deadline = time.time() + 300
        while srv.state.snapshot_stats()["frames_processed"] == 0:
            assert time.time() < deadline
            time.sleep(0.1)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/api/latest", timeout=10) as r:
            assert "defect_count" in json.loads(r.read())
    finally:
        srv.shutdown()
    assert fused_kernels.contamination_fused.launches > 0
    assert not [t for t in threading.enumerate()
                if t.name == "dashboard-loop"]


@pytest.mark.cuda
@pytest.mark.parametrize("hw,mono", [((480, 640), False),
                                     ((1080, 1920), True)])
def test_multi_class_on_the_card_equals_cpu(card, hw, mono):
    frames = scene.make_frames(2, *hw, seed=2)
    if mono:
        frames = np.ascontiguousarray(frames[..., 1])
    for w in (fused_kernels.contamination_fused, ccl_tiled.band_ccl,
              stats_tiled.bbox_sums):
        w.launches = 0
    got = MultiClassDefectDetector(device=card).detect_batch(frames)
    want = MultiClassDefectDetector(device="cpu").detect_batch(frames)
    assert _defect_rows(got) == _defect_rows(want)
    if mono:
        assert ccl_tiled.band_ccl.launches and stats_tiled.bbox_sums.launches
    else:
        assert fused_kernels.contamination_fused.launches


@pytest.mark.cuda
def test_models_on_the_card_equal_cpu(card):
    frames = scene.ring_frames(2, 120, 160, seed=1)
    seg = segmentation.DefectSegmenter(base=16, device=card)
    seg_cpu = segmentation.DefectSegmenter(base=16, device="cpu")
    prob = seg.predict(frames)
    np.testing.assert_allclose(prob, seg_cpu.predict(frames), rtol=0,
                               atol=1e-5)

    class Fixed:
        def predict(self, images):
            return prob

    cfg = {"threshold": float(np.median(prob)), "min_contaminant_size": 1}
    ccl_tiled.band_ccl.launches = 0
    got = segmentation.SegmentationDetector(Fixed(), config=cfg,
                                            device=card).detect_batch(frames)
    want = segmentation.SegmentationDetector(
        Fixed(), config=cfg, device="cpu").detect_batch(frames)
    assert _defect_rows(got) == _defect_rows(want)
    assert ccl_tiled.band_ccl.launches > 0

    q = quantized.QuantizedSegmenter.from_segmenter(seg_cpu, frames)
    q_card = quantized.QuantizedSegmenter(q.qparams, device=card)
    np.testing.assert_allclose(q_card.predict(frames), q.predict(frames),
                               rtol=0, atol=1e-6)

    clf = defect_classifier.DefectClassifier(device=card)
    clf_cpu = defect_classifier.DefectClassifier(device="cpu")
    patches = np.random.RandomState(0).randint(
        0, 256, (16, 32, 32, 1)).astype(np.uint8)
    np.testing.assert_allclose(clf.predict(patches),
                               clf_cpu.predict(patches), rtol=0, atol=1e-4)
    ae = anomaly.AnomalyDetector(device=card)
    ae_cpu = anomaly.AnomalyDetector(device="cpu")
    tiles = np.random.RandomState(1).randint(0, 256, (2, 128, 192)).astype(
        np.uint8)
    np.testing.assert_allclose(ae.score(tiles), ae_cpu.score(tiles),
                               rtol=1e-4)


@pytest.mark.cuda
def test_concurrent_unet_forwards_stay_float32(card):
    """cuDNN's TF32 flag is process-wide: two threads' forwards at once
    must both compute in float32 (float32_convs serialises them, so one
    forward's exit cannot turn TF32 back on inside the other)."""
    frames = [scene.ring_frames(2, 240, 320, seed=s) for s in (4, 5)]
    seg = segmentation.DefectSegmenter(base=16, device=card)
    seg_cpu = segmentation.DefectSegmenter(base=16, device="cpu")
    want = [seg_cpu.predict(f) for f in frames]
    tf32 = torch.backends.cudnn.allow_tf32
    got = [[], []]
    start = threading.Barrier(2)

    def run(i):
        start.wait()
        for _ in range(8):
            got[i].append(seg.predict(frames[i]))

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for i in (0, 1):
        assert len(got[i]) == 8
        for prob in got[i]:
            np.testing.assert_allclose(prob, want[i], rtol=0, atol=1e-5)
    assert torch.backends.cudnn.allow_tf32 == tf32


@pytest.mark.cuda
def test_demosaic_on_the_card_equals_cpu(card):
    raw = np.random.RandomState(0).randint(0, 256, (2, 37, 53)).astype(
        np.uint8)
    for pattern in ("rg", "gr", "gb", "bg"):
        got = demosaic.demosaic_bilinear(raw, pattern, device=card)
        assert got.is_cuda
        assert torch.equal(got.cpu(), demosaic.demosaic_bilinear(
            raw, pattern, device="cpu"))
    yuv = np.random.RandomState(1).randint(0, 256, (2, 37, 108)).astype(
        np.uint8)
    assert torch.equal(demosaic.yuv422_to_bgr(yuv, device=card).cpu(),
                       demosaic.yuv422_to_bgr(yuv, device="cpu"))
