"""The port's bf16 models in training against heimdall_tpu's (JAX on the
CPU): the classifier's and the autoencoder's loss, gradients and train
step, and AnomalyDetector.fit, with the helpers of
tests/test_torch_training.py (flax parameters carried across by
models/convert.py; the port on the CPU, one torch thread, small inputs).

Tolerances (tests/_torch_step_rule.py holds them and the rule; the
readings here, over four seeds of each model, in brackets):

* loss within BF16_LOSS_TOL = 1e-4 relative [3.2e-5];
* each kernel's gradient, and every gradient of the float32 last layers
  (Dense_1, ConvTranspose_2), within BF16_KERNEL_TOL = 1e-2 of its largest
  |g| [3.5e-3];
* the biases of the bf16 layers, together, at a cosine of at least
  BIAS_COS = 0.95 with JAX's [0.998].  A bias's gradient is the sum of
  thousands of bf16 terms that cancel to 2-12% of their absolute sum, so
  a product rounded one bf16 ulp the other way (oneDNN and XLA accumulate
  in other orders) or a ReLU at a rounded zero moves it by much of itself:
  single bias elements lie up to 61% of their vector's largest |g| apart,
  0.7-2.6% of the terms' absolute sum.  JAX's own bf16 gradients lie up to
  15% (kernels) and 38% (biases) of the largest |g| from the same model's
  float32 gradients;
* one train step as in tests/test_torch_training.py, every bias of a bf16
  layer counted as within the noise: at most APART_SHARE of the
  parameters further than 1e-5 apart [18 of 355,202 for the classifier,
  45 of 46,529 for the autoencoder];
* AnomalyDetector.fit (4 steps): the same batches in the same order, the
  returned loss and the threshold within FIT_TOL = 1e-3 relative
  [1.9e-5, 7.8e-5].

The classifier's patches are half random and half flat regions of five
levels, so every pooling layer meets tied maxima
(test_torch_training.py::test_max_pool_ties_route_as_flax holds the
routing of their gradient on its own).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax

from heimdall_tpu.models import anomaly as jan
from heimdall_tpu.models import defect_classifier as jdc

from heimdall_tpu_torch.models import anomaly as tan
from heimdall_tpu_torch.models import convert
from heimdall_tpu_torch.models import defect_classifier as tdc

import _torch_step_rule as rule
from test_torch_training import (  # noqa: F401 (one_thread: a fixture)
    check_loss_and_gradients, check_train_step, one_thread, quick_init,
    result, state)


@functools.lru_cache(maxsize=None)
def _classifier_case():
    rng = np.random.RandomState(5)
    levels = np.array([0, 40, 120, 200, 255], np.uint8)
    patches = np.concatenate([
        rng.randint(0, 256, (8, 32, 32, 1)).astype(np.uint8),
        levels[rng.randint(0, 5, (8, 32, 32, 1))]])
    labels = rng.randint(0, 2, 16)
    theirs = quick_init(jdc.DefectClassifierCNN, jdc.DefectClassifier, 3)
    mine = tdc.DefectClassifier(device="cpu")
    flat = {"Dense_0": mine.model.flatten_shape()}
    mine.model.load_state_dict(convert.state_dict_from_flax(
        jax.device_get(theirs.params["params"]), flat))

    def loss_fn(params, x, y):      # ClassifierTrainer's (:146-149)
        logits = theirs.model.apply(params, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    loss_j, g = jax.jit(jax.value_and_grad(loss_fn))(
        theirs.params, jnp.asarray(patches), jnp.asarray(labels))
    grads_j = state(g["params"], flat)
    jdc.ClassifierTrainer(theirs).train_step(patches, labels)
    loss_t = tdc.ClassifierTrainer(mine).train_step(patches, labels)
    return result(loss_j, grads_j, state(theirs.params["params"], flat),
                  loss_t, mine.model, rule.bf16_tols(grads_j, "Dense_1"),
                  rule.BF16_LOSS_TOL)


@functools.lru_cache(maxsize=None)
def _autoencoder_case():
    rng = np.random.RandomState(6)
    frames = np.concatenate([
        rng.randint(0, 256, (1, 64, 192)),
        np.clip(128 + rng.randn(1, 64, 192) * 8, 0, 255)]).astype(np.uint8)
    tiles = jan._tile_frames(frames)
    theirs = quick_init(jan.ConvAutoencoder, jan.AnomalyDetector, 4)
    mine = tan.AnomalyDetector(device="cpu")
    mine.model.load_state_dict(convert.state_dict_from_flax(
        jax.device_get(theirs.params["params"])))

    def loss_fn(params, x):         # AnomalyDetector's (:89-92)
        recon = theirs.model.apply(params, x)
        return jnp.mean((recon - x.astype(jnp.float32) / 255.0) ** 2)

    loss_j, g = jax.jit(jax.value_and_grad(loss_fn))(theirs.params,
                                                     jnp.asarray(tiles))
    grads_j = state(g["params"])
    params, _, _ = theirs._train_step(theirs.params, theirs.opt_state,
                                      jnp.asarray(tiles))
    loss_t = float(mine._train_step(tiles))
    return result(loss_j, grads_j, state(params["params"]), loss_t,
                  mine.model, rule.bf16_tols(grads_j, "ConvTranspose_2"),
                  rule.BF16_LOSS_TOL)


def test_classifier_loss_and_gradients_equal_jax():
    check_loss_and_gradients("classifier", _classifier_case())


def test_classifier_train_step_equals_jax():
    check_train_step("classifier", _classifier_case())


def test_autoencoder_loss_and_gradients_equal_jax():
    check_loss_and_gradients("autoencoder", _autoencoder_case())


def test_autoencoder_train_step_equals_jax():
    check_train_step("autoencoder", _autoencoder_case())


def test_anomaly_fit_equals_jax():
    """fit(epochs=2, batch_size=4) on 3 frames of 64x192 (9 tiles): 4 steps
    a side, the 1-tile tail skipped in each epoch."""
    rng = np.random.RandomState(7)
    frames = np.clip(120 + rng.randn(3, 64, 192) * 10, 0, 255).astype(
        np.uint8)
    theirs = quick_init(jan.ConvAutoencoder, jan.AnomalyDetector, 2)
    mine = tan.AnomalyDetector(device="cpu")
    mine.model.load_state_dict(convert.state_dict_from_flax(
        jax.device_get(theirs.params["params"])))
    seen_j, seen_t = [], []
    step_j, step_t = theirs._train_step, mine._train_step

    def record_j(params, opt_state, x):
        seen_j.append(np.asarray(x))
        return step_j(params, opt_state, x)

    def record_t(tiles):
        seen_t.append(np.asarray(tiles))
        return step_t(tiles)

    theirs._train_step, mine._train_step = record_j, record_t
    loss_j = theirs.fit(frames, epochs=2, batch_size=4)
    loss_t = mine.fit(frames, epochs=2, batch_size=4)
    assert [len(b) for b in seen_t] == [4, 4, 4, 4]
    assert len(seen_j) == len(seen_t)
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)
    assert isinstance(loss_t, float)
    print(f"fit: loss {loss_t} / {loss_j}, threshold {mine.threshold} / "
          f"{theirs.threshold}")
    assert abs(loss_t - loss_j) <= rule.FIT_TOL * loss_j
    assert abs(mine.threshold - theirs.threshold) <= rule.FIT_TOL * \
        theirs.threshold
