"""The port's segmentation U-Net and its detector against heimdall_tpu's
(JAX on the CPU), the flax parameters carried across by models/convert.py:
probabilities within 1e-5 and masks equal; the model input exact; the
detector's defects equal to JAX's on the same probabilities (labels, blob
table and bbox confidences: both label with 6 sweeps of
ops.connected_components, then blobs.blob_stats).

The port runs with device="cpu"; the UNet's width is cut (base 8), frames
are small and odd-sized.  JAX's flax init and its detector's labeling run
jitted here (the same values as eager, in a fraction of the time).
"""

import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

from heimdall_tpu import ops as jops
from heimdall_tpu.ops import blobs as jblobs
from heimdall_tpu.models import segmentation as jseg

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.models import convert, layers
from heimdall_tpu_torch.models import segmentation as tseg
from heimdall_tpu_torch.ops import ccl as tccl


def _frames():
    rng = np.random.RandomState(0)
    bgr = rng.randint(0, 256, (2, 37, 53, 3)).astype(np.uint8)
    gray = scene.ring_frames(2, 40, 52, seed=1)[..., 1]
    return bgr, gray


def jax_segmenter(base=8, seed=1):
    """JAX's DefectSegmenter with its flax init jitted."""
    cls = jseg.SegmentationUNet
    init = cls.init
    cls.init = lambda self, *args: jax.jit(functools.partial(init, self))(
        *args)
    try:
        return jseg.DefectSegmenter(base=base, seed=seed)
    finally:
        del cls.init


def port_segmenter(theirs):
    seg = tseg.DefectSegmenter(base=theirs.model.base, device="cpu")
    seg.model.load_state_dict(convert.state_dict_from_flax(
        jax.device_get(theirs.params)))
    return seg


@functools.lru_cache(maxsize=None)
def _segmenters():
    theirs = jax_segmenter()
    return theirs, port_segmenter(theirs)


@pytest.mark.parametrize("form", ["bgr", "gray"])
def test_unet_predict_equals_flax(form):
    theirs, mine = _segmenters()
    images = _frames()[0 if form == "bgr" else 1]
    want = theirs.predict(images)
    got = mine.predict(images)
    assert got.shape == want.shape == images.shape[:3]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.array_equal(got >= 0.5, want >= 0.5)
    # a tensor batch gives the same
    np.testing.assert_array_equal(mine.predict(torch.from_numpy(images)),
                                  got)


def test_model_input_pads_with_edge_values():
    frames = _frames()[0]
    x, hw = tseg._to_model_input(frames, torch.device("cpu"))
    want, whw = jseg._to_model_input(frames)
    assert hw == whw == (37, 53) and x.shape == (2, 1, 40, 56)
    np.testing.assert_array_equal(x[:, 0].numpy(), np.asarray(want)[..., 0])


def test_segmenter_save_load(tmp_path):
    _, mine = _segmenters()
    path = str(tmp_path / "unet.pt")
    mine.save(path)
    other = tseg.DefectSegmenter(base=8, seed=9, device="cpu")
    other.load(path)
    frames = _frames()[0]
    np.testing.assert_array_equal(other.predict(frames),
                                  mine.predict(frames))


class _FixedProb:
    """A segmenter whose predict returns the given probabilities."""

    def __init__(self, prob):
        self.prob = prob

    def predict(self, images):
        return self.prob


def _blob_prob(n, h, w, seed):
    """Probability maps under 0.45 with disks of 1-6 px radius and a bar
    above 0.5 (some blobs under the size gate, some touching each other or
    the frame's edge)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    prob = rng.uniform(0, 0.45, (n, h, w)).astype(np.float32)
    for i in range(n):
        for _ in range(6):
            cy, cx, r = rng.randint(0, h), rng.randint(0, w), \
                rng.randint(1, 7)
            disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            prob[i][disk] = rng.uniform(0.5, 1.0, int(disk.sum()))
        prob[i, 5:8, 3:w - 3] = 0.9
    return prob


@pytest.fixture()
def jitted_labels(monkeypatch):
    """JAX's detector labels eagerly; jitted, the same functions give the
    same table in seconds."""
    monkeypatch.setattr(jops, "connected_components", jax.jit(
        jops.connected_components,
        static_argnames=("connectivity", "max_iters", "sweeps")))
    monkeypatch.setattr(jblobs, "blob_stats", jax.jit(
        jblobs.blob_stats, static_argnames=("max_blobs", "use_color")))


@pytest.mark.parametrize("config", [{}, {"max_blobs": 3, "threshold": 0.6,
                                         "min_contaminant_size": 1}])
def test_segmentation_detector_equals_jax(config, jitted_labels):
    frames = scene.ring_frames(3, 57, 75, seed=4)
    prob = _blob_prob(3, 57, 75, seed=6)
    want = jseg.SegmentationDetector(_FixedProb(prob),
                                     config=config).detect_batch(frames)
    got = tseg.SegmentationDetector(_FixedProb(prob), config=config,
                                    device="cpu").detect_batch(frames)
    assert sum(map(len, want)) > 3
    assert len(got) == len(want)
    for a_list, b_list in zip(got, want):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            assert a.defect_type == b.defect_type == "segmented_defect"
            assert tuple(a.position) == tuple(b.position)
            assert a.size == b.size
            assert a.confidence == b.confidence
            assert a.metadata == b.metadata
    single = tseg.SegmentationDetector(_FixedProb(prob[:1]), config=config,
                                       device="cpu").detect(frames[0])
    assert [d.to_dict() for d in single] == [d.to_dict() for d in got[0]]


def test_detector_on_the_segmenter(jitted_labels):
    """The port's whole chain (its UNet, then its detector) against JAX's
    detector given the port's probabilities (pixels within 1e-5 of the
    threshold may fall on either side between the two UNets).

    The seeded UNet's map lies in 0.43-0.51 on these frames, so its mask at
    0.48 is speckled.  Both detectors label with 6 unrolled sweeps and no
    fixpoint check (heimdall_tpu/models/segmentation.py:172), which leave
    some components split on this mask: the test checks that they do, and
    holds the port against JAX's detector as it is, exactly."""
    _, mine = _segmenters()
    frames = _frames()[1]
    cfg = {"threshold": 0.48, "min_contaminant_size": 1}
    got = tseg.SegmentationDetector(mine, config=cfg,
                                    device="cpu").detect_batch(frames)
    prob = mine.predict(frames)
    ccl = jops.connected_components
    mask = prob >= 0.48
    six = np.asarray(ccl(mask, connectivity=8, sweeps=6))
    assert (six != np.asarray(ccl(mask, connectivity=8))).any()
    np.testing.assert_array_equal(
        tccl.connected_components(torch.from_numpy(mask), 8,
                                  sweeps=6).numpy(), six)
    want = jseg.SegmentationDetector(_FixedProb(prob),
                                     config=cfg).detect_batch(frames)
    assert sum(map(len, want)) > 4
    assert [[d.to_dict() for d in r] for r in got] == \
        [[d.to_dict() for d in r] for r in want]


@pytest.mark.parametrize("sweeps,max_iters", [(1, 0), (2, 0), (0, 2),
                                              (0, 0)])
def test_sweep_labels_equal_jax(sweeps, max_iters, jitted_labels):
    """ops/ccl.py's connected_components with JAX's sweeps and max_iters
    equals JAX's on speckle masks (a sweep or two leave components split;
    the fixpoint does not)."""
    rng = np.random.default_rng(7)
    mask = rng.random((2, 23, 31)) < 0.55
    want = np.asarray(jops.connected_components(
        mask, connectivity=8, max_iters=max_iters, sweeps=sweeps))
    got = tccl.connected_components(torch.from_numpy(mask), 8,
                                    max_iters=max_iters, sweeps=sweeps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_float32_convs_serialises_its_callers():
    """cuDNN's TF32 flag is process-wide: a second caller of float32_convs
    waits until the first has left, TF32 stays off for the whole of the
    first's calls, and the setting is restored after both.  Only the
    device's type is read, so this runs without a card."""
    card = torch.device("cuda")
    before = torch.backends.cudnn.allow_tf32
    inside, release, log = threading.Event(), threading.Event(), []

    def first():
        with layers.float32_convs(card):
            log.append(("first in", torch.backends.cudnn.allow_tf32))
            inside.set()
            release.wait(10)
            log.append(("first out", torch.backends.cudnn.allow_tf32))

    def second():
        inside.wait(10)
        with layers.float32_convs(card):
            log.append(("second in", torch.backends.cudnn.allow_tf32))

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    assert inside.wait(10)
    time.sleep(0.2)
    assert log == [("first in", False)]
    release.set()
    for t in threads:
        t.join(10)
    assert log == [("first in", False), ("first out", False),
                   ("second in", False)]
    assert torch.backends.cudnn.allow_tf32 == before
