"""The port's multi-class defect detector (detectors/multi_defect.py)
against heimdall_tpu's (JAX on the CPU): on the same frames, every defect's
kind, position, size and bounding box exact and its float fields
(confidence, aspect and fill ratios, scores) within 1e-6 (XLA's jit on the
CPU may divide by a constant through its reciprocal: ROADMAP.md §C); and
classify_table itself equal on the port's table.

Frames: the bench scene, the inspector's ring frames and the adversarial
masks drawn as frames (long spiral arms, nested rings, noise, blobs cut by
the frame's edges), at 120x160, BGR and Mono8; with the default rules and
with rules that turn most blobs into colour defects, deformations and
cracks.  The port runs with device="cpu".
"""

import functools

import pytest
import torch

from heimdall_tpu.detectors.multi_defect import (
    MultiClassDefectDetector as JaxMulti)

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.detectors.contamination_detector import (
    download_table)
from heimdall_tpu_torch.detectors.multi_defect import (
    MultiClassDefectDetector)

H, W = 120, 160
CONFIGS = {
    "default": {},
    # colour dominance, deformation and crack cuts low enough that every
    # rule fires on these frames
    "loose": {"color_dominance": 0.2, "deform_area": 300.0,
              "crack_aspect": 1.5, "crack_fill": 0.6, "min_size": 4},
}
FLOATS = ("aspect_ratio", "fill_ratio", "intensity_score", "color_score",
          "shape_score")


@functools.lru_cache(maxsize=None)
def _frames(name):
    if name == "bench":
        return scene.make_frames(2, H, W, seed=0)
    if name == "rings":
        return scene.ring_frames(2, H, W, seed=1)
    return scene.mask_frames(list(scene.adversarial_masks(H, W,
                                                          seed=1).values()))


@functools.lru_cache(maxsize=None)
def _detectors(config):
    cfg = CONFIGS[config]
    return JaxMulti(config=cfg), MultiClassDefectDetector(config=cfg,
                                                          device="cpu")


def _assert_defects_equal(got, want):
    assert len(got) == len(want)
    for a_list, b_list in zip(got, want):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            assert a.defect_type == b.defect_type
            assert tuple(a.position) == tuple(b.position)
            assert a.size == b.size
            assert a.metadata["bounding_box"] == b.metadata["bounding_box"]
            assert abs(a.confidence - b.confidence) <= 1e-6
            for k in FLOATS:
                assert abs(a.metadata[k] - b.metadata[k]) <= 1e-6, k


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", ["bench", "rings", "adversarial"])
def test_detect_batch_equals_jax(name, config):
    frames = _frames(name)
    theirs, mine = _detectors(config)
    want = theirs.detect_batch(frames)
    got = mine.detect_batch(frames)
    assert sum(map(len, want)) > 0
    _assert_defects_equal(got, want)
    # Mono8 frames (the colour score is then neutral)
    _assert_defects_equal(mine.detect_batch(frames[..., 1]),
                          theirs.detect_batch(frames[..., 1]))


def test_every_kind_is_held():
    kinds = set()
    for config in CONFIGS:
        theirs, mine = _detectors(config)
        for name in ("bench", "rings", "adversarial"):
            kinds |= {d.defect_type for r in
                      mine.detect_batch(_frames(name)) for d in r}
    assert kinds == {"contamination", "crack", "deformation",
                     "color_defect"}


def test_classify_table_equals_jax_on_the_ports_table():
    theirs, mine = _detectors("loose")
    frames = _frames("adversarial")
    table, conf, accepted = download_table(*mine._front.run_device(frames))
    assert accepted.any()
    _assert_defects_equal(mine.classify_table(table, conf, accepted),
                          theirs.classify_table(table, conf, accepted))


def test_detect_and_tensor_input():
    theirs, mine = _detectors("default")
    frames = _frames("rings")
    want = mine.detect_batch(frames)
    _assert_defects_equal([mine.detect(frames[1])], want[1:])
    _assert_defects_equal(mine.detect_batch(torch.from_numpy(frames)), want)
    _assert_defects_equal([mine.detect(frames[1])],
                          [theirs.detect(frames[1])])


def test_front_keeps_jax_config():
    theirs, mine = _detectors("loose")
    for key in ("crack_aspect", "crack_fill", "deform_area",
                "color_dominance"):
        assert getattr(mine, key) == getattr(theirs, key)
    for key in ("min_contaminant_size", "max_contaminant_size",
                "contrast_threshold", "min_confidence", "include_contours"):
        assert getattr(mine._front, key) == getattr(theirs._front, key)
    assert mine.device == torch.device("cpu")


def test_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("holds the no-card error")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiClassDefectDetector()
