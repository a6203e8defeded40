"""The port's models against heimdall_tpu's flax models (JAX on the CPU),
with the flax parameters carried across by models/convert.py: the
conversions themselves, the seeded initialisation, the bf16 classifier and
autoencoder (within the tolerances measured here, CLASSIFIER_TOL and
AE_TOL: 2.2e-5 and 3.6e-5 at these inputs; argmax and is_anomalous
equal), the blob patches, the checkpoints and the no-card rule.  The U-Net
and its detector are held in tests/test_torch_segmentation.py, the int8
U-Net in tests/test_torch_quantized.py, training in
tests/test_torch_training.py and test_torch_training_bf16.py.

The port runs with device="cpu"; frames and patches are small.  JAX's
flax inits run jitted here (the same values as eager, in less time).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heimdall_tpu.detectors.contamination_detector import (
    ContaminationDetector as JaxDetector)
from heimdall_tpu.models import anomaly as jan
from heimdall_tpu.models import defect_classifier as jdc
from heimdall_tpu.models import segmentation as jseg

import heimdall_tpu_torch.models as tmodels
from heimdall_tpu_torch import scene
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector, download_table)
from heimdall_tpu_torch.models import anomaly as tan
from heimdall_tpu_torch.models import convert
from heimdall_tpu_torch.models import defect_classifier as tdc
from heimdall_tpu_torch.models import quantized as tq
from heimdall_tpu_torch.models import segmentation as tseg

def jitted_init(cls, make):
    """make() with cls's flax init jitted (the same parameters as the eager
    init, in a fraction of the time)."""
    init = cls.init
    cls.init = lambda self, *args: jax.jit(functools.partial(init, self))(
        *args)
    try:
        return make()
    finally:
        del cls.init


# bf16 models: the largest probability / reconstruction difference allowed
# against flax, a few times the readings at these inputs (2.2e-5 and
# 3.6e-5).  bf16 holds 8 significant bits, so a product rounded one bf16
# ulp apart (the two libraries accumulate in other orders) could move a
# value by ~4e-3 of itself; limits that loose would not see a missing bf16
# step or a fault below 1e-3.
CLASSIFIER_TOL = 1e-4
AE_TOL = 1e-4


# -------------------------------------------------------------- convert

def test_convert_round_trips_and_maps_each_layer():
    rng = np.random.RandomState(2)
    conv = rng.randn(3, 3, 4, 5).astype(np.float32)
    up = rng.randn(2, 2, 4, 5).astype(np.float32)
    params = {"Conv_0": {"kernel": conv, "bias": np.zeros(5, np.float32)},
              "ConvTranspose_0": {"kernel": up,
                                  "bias": np.ones(5, np.float32)}}
    sd = convert.state_dict_from_flax(params)
    assert sd["Conv_0.weight"].shape == (5, 4, 3, 3)
    assert float(sd["Conv_0.weight"][1, 2, 0, 2]) == conv[0, 2, 2, 1]
    assert sd["ConvTranspose_0.weight"].shape == (4, 5, 2, 2)
    assert float(sd["ConvTranspose_0.weight"][2, 3, 0, 1]) == up[1, 0, 2, 3]
    back = convert.flax_from_state_dict(sd)
    for name in params:
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][k], params[name][k])
    # a Dense after a flatten: flax's (h, w, c) rows in the port's (c, h, w)
    dense = rng.randn(2 * 3 * 4, 6).astype(np.float32)
    w = convert.dense_weight(dense, (2, 3, 4))
    x = rng.randn(2, 3, 4).astype(np.float32)            # an HWC map
    np.testing.assert_allclose(w @ x.transpose(2, 0, 1).ravel(),
                               x.ravel() @ dense, rtol=1e-5)
    with pytest.raises(ValueError):
        convert.state_dict_from_flax({"LayerNorm_0": {"kernel": conv}})


def test_seeded_init_is_deterministic_and_flax_shaped():
    a = tseg.DefectSegmenter(base=8, seed=3, device="cpu").model
    b = tseg.DefectSegmenter(base=8, seed=3, device="cpu").model
    c = tseg.DefectSegmenter(base=8, seed=4, device="cpu").model
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.Conv_1.weight, c.Conv_1.weight)
    assert not bool(a.Conv_1.bias.detach().any())
    flax_shapes = jax.tree.map(np.shape, jax.eval_shape(
        jseg.SegmentationUNet(base=8).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 1)))["params"])
    mine = convert.flax_from_state_dict(a.state_dict())
    assert jax.tree.map(np.shape, mine) == flax_shapes
    # lecun_normal: std sqrt(1 / fan_in), truncated at 2 std
    w = a.Conv_5.weight.detach()
    fan_in = w[0].numel()
    assert float(w.abs().max()) <= 2 / 0.8796 * fan_in ** -0.5 + 1e-6
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.15


# ------------------------------------------------------------ classifier

@functools.lru_cache(maxsize=None)
def _classifiers():
    theirs = jitted_init(jdc.DefectClassifierCNN,
                         lambda: jdc.DefectClassifier(seed=3))
    mine = tdc.DefectClassifier(device="cpu")
    mine.model.load_state_dict(convert.state_dict_from_flax(
        jax.device_get(theirs.params["params"]),
        {"Dense_0": mine.model.flatten_shape()}))
    return theirs, mine


def test_classifier_equals_flax():
    theirs, mine = _classifiers()
    rng = np.random.RandomState(5)
    patches = np.concatenate([
        rng.randint(0, 256, (12, 32, 32, 1)),
        rng.randint(0, 60, (6, 32, 32, 1)),
        rng.randint(180, 256, (6, 32, 32, 1))]).astype(np.uint8)
    want, got = theirs.predict(patches), mine.predict(patches)
    assert got.shape == want.shape == (24, 2) and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    print(f"classifier: max |p - p_flax| {err:.3g}")
    assert err <= CLASSIFIER_TOL
    assert np.array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)
    assert mine.predict(np.zeros((0, 32, 32, 1), np.uint8)).shape == (0, 2)


def test_extract_blob_patches_equals_jax():
    frames = scene.ring_frames(2, 96, 128, seed=2)
    table = download_table(*ContaminationDetector(
        config={"include_contours": False}, device="cpu").run_device(
            frames))[0]
    jtable, _, _ = JaxDetector(config={"include_contours": False}
                               ).run_device(frames)
    got = tdc.extract_blob_patches(frames, table)
    want = jdc.extract_blob_patches(frames, jax.device_get(jtable))
    assert len(want) >= 2 and got.shape[1:] == (32, 32, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tdc.extract_blob_patches(frames[..., 0], table),
        jdc.extract_blob_patches(frames[..., 0], jax.device_get(jtable)))
    _, mine = _classifiers()
    assert mine.predict(got).shape == (len(got), 2)


def test_classifier_checkpoint(tmp_path):
    _, mine = _classifiers()
    path = str(tmp_path / "ckpt")
    mine.save(path)
    assert os.listdir(path) == ["params.pt"]
    other = tdc.DefectClassifier(seed=7, device="cpu")
    other.load(path)
    for k, v in mine.model.state_dict().items():
        assert torch.equal(v, other.model.state_dict()[k]), k
    with pytest.raises(FileNotFoundError):
        other.load(str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        jitted_init(jdc.DefectClassifierCNN,
                    lambda: jdc.DefectClassifier(seed=7)).load(
                        str(tmp_path / "missing"))


# ---------------------------------------------------------------- anomaly

def test_autoencoder_equals_flax():
    theirs = jitted_init(jan.ConvAutoencoder,
                         lambda: jan.AnomalyDetector(seed=4))
    mine = tan.AnomalyDetector(device="cpu")
    mine.model.load_state_dict(convert.state_dict_from_flax(
        jax.device_get(theirs.params["params"])))
    rng = np.random.RandomState(6)
    noisy = rng.randint(0, 256, (3, 128, 130)).astype(np.uint8)
    flat = np.clip(128 + rng.randn(3, 128, 130) * 2, 0, 255).astype(
        np.uint8)
    frames = np.concatenate([noisy, flat])
    tiles = jan._tile_frames(frames)
    np.testing.assert_array_equal(tan._tile_frames(frames), tiles)
    recon = mine.model(torch.from_numpy(tiles)).detach().numpy()[:, 0]
    want_recon = np.asarray(theirs.model.apply(theirs.params,
                                               jnp.asarray(tiles)))[..., 0]
    err = float(np.abs(recon - want_recon).max())
    print(f"autoencoder: max |recon - recon_flax| {err:.3g}")
    assert err <= AE_TOL
    want, got = theirs.score(frames), mine.score(frames)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # a threshold between the noisy frames' scores and the flat ones'
    threshold = float(np.sqrt(want[:3].min() * want[3:].max()))
    assert want[3:].max() * 1.5 < threshold < want[:3].min() / 1.5
    theirs.threshold = mine.threshold = threshold
    assert np.array_equal(mine.is_anomalous(frames),
                          theirs.is_anomalous(frames))
    assert mine.is_anomalous(frames).tolist() == [True] * 3 + [False] * 3
    assert mine.score(frames[3]).shape == (1,)
    with pytest.raises(RuntimeError, match="fit"):
        tan.AnomalyDetector(device="cpu").is_anomalous(frames)


# ------------------------------------------------------ the no-card rule

def test_models_exports_what_jax_exports():
    import heimdall_tpu.models as jmodels
    names = {n for n in dir(jmodels) if not n.startswith("_")
             and n not in {"anomaly", "capture", "defect_classifier",
                           "quantized", "segmentation"}}
    assert names <= set(dir(tmodels))


def test_models_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("holds the no-card error")
    seg = tseg.DefectSegmenter(base=8, device="cpu")
    qparams = tq.quantize_params(
        convert.flax_from_state_dict(seg.model.state_dict()),
        {name: 1.0 for name, _ in tq._LAYERS})
    for make in (lambda: tseg.DefectSegmenter(base=8),
                 lambda: tseg.SegmentationDetector(seg),
                 lambda: tq.QuantizedSegmenter(qparams),
                 lambda: tdc.DefectClassifier(),
                 lambda: tan.AnomalyDetector()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
