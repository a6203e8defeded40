"""The port's training against heimdall_tpu's (JAX on the CPU): its
optax.adam, the max-pool's gradient at ties, and the float32 UNet's loss,
gradients and train step; tests/test_torch_training_bf16.py holds the bf16
classifier and autoencoder and AnomalyDetector.fit with the helpers here.
The flax parameters are carried across by models/convert.py, so both
sides start from the same weights; the port runs with device="cpu" on one
torch thread, on small inputs.

Tolerances (tests/_torch_step_rule.py holds them and the rule, shared
with the card's checks; the readings here in brackets):

* the optimizer: bitwise equal to optax's eager update and within 1
  float32 ulp of its jitted one over 5 steps [0 and 1 ulp];
* the float32 UNet (base 8, 32x32 and 30x34, whose padded rows and
  columns carry no weight): loss within 1e-5 relative, each gradient
  tensor within 1e-5 of its largest |g| [2.1e-6];
* one train step: where |g_jax| exceeds its tensor's gradient tolerance
  (the gradient noise), Adam's first step moves the parameter by about
  lr * sign(g) on both sides, and they agree within PARAM_TOL = 1e-5;
  elsewhere the signs may differ and the parameters may lie up to 2 * lr
  apart.  The share of elements that do lie more than 1e-5 apart is held
  under APART_SHARE = 2e-3 [0 for the UNet].
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from heimdall_tpu.models import segmentation as jseg

from heimdall_tpu_torch.models import convert
from heimdall_tpu_torch.models import segmentation as tseg
from heimdall_tpu_torch.models.optim import Adam

import _torch_step_rule as rule

LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quick_init(cls, make, seed):
    """make() with cls's flax init replaced by draws from numpy of the same
    shapes (a normal of std 1/sqrt(fan_in) for kernels, zero biases, as
    lecun_normal and zeros give): JAX's own init compiles for seconds, and
    any weights serve, since both sides start from the same."""
    init = cls.init

    def fake(self, key, *args):
        rng = np.random.RandomState(seed)

        def draw(path, s):
            if path[-1].key == "bias":
                return jnp.zeros(s.shape, s.dtype)
            fan_in = int(np.prod(s.shape[:-1]))
            return jnp.asarray((rng.standard_normal(s.shape)
                                / np.sqrt(fan_in)).astype(s.dtype))

        return jax.tree_util.tree_map_with_path(
            draw, jax.eval_shape(functools.partial(init, self), key, *args))

    cls.init = fake
    try:
        return make()
    finally:
        del cls.init


def state(tree, flatten=None):
    """A flax tree (parameters or gradients) as the port's state_dict, in
    numpy."""
    return {k: v.numpy() for k, v in convert.state_dict_from_flax(
        jax.device_get(tree), flatten).items()}


def port_state(model, grads=False):
    return {k: (p.grad if grads else p).detach().numpy().copy()
            for k, p in model.named_parameters()}


# ------------------------------------------------------------- optimizer

def test_adam_equals_optax():
    rng = np.random.RandomState(0)
    shapes = [(6, 10)] * 3
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = optax.adam(LR)
    eager = [jnp.asarray(p) for p in params]
    jitted = list(eager)
    s_eager = s_jit = tx.init(eager)

    @jax.jit
    def step_jit(g, st, p):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st

    mine = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = Adam(mine, LR)
    for step in range(5):
        # gradients over nine decades, some exactly zero; at step 3 one
        # tensor has none, which steps as a zero gradient (optax's)
        grads = [(rng.randn(*s) * 10.0 ** rng.uniform(-8, 1, s)).astype(
            np.float32) for s in shapes]
        grads[1][:5] = 0
        if step == 3:
            grads[2][:] = 0
        g = [jnp.asarray(x) for x in grads]
        u, s_eager = tx.update(g, s_eager, eager)
        eager = optax.apply_updates(eager, u)
        jitted, s_jit = step_jit(g, s_jit, jitted)
        for i, (p, x) in enumerate(zip(mine, grads)):
            p.grad = None if step == 3 and i == 2 else torch.from_numpy(x)
        opt.step()
        for i, p in enumerate(mine):
            got = p.detach().numpy()
            np.testing.assert_array_equal(got, np.asarray(eager[i]))
            np.testing.assert_array_max_ulp(got, np.asarray(jitted[i]),
                                            maxulp=1)
            np.testing.assert_array_equal(opt.state[p]["mu"].numpy(),
                                          np.asarray(s_eager[0].mu[i]))
            np.testing.assert_array_equal(opt.state[p]["nu"].numpy(),
                                          np.asarray(s_eager[0].nu[i]))
    assert opt.param_groups[0]["count"] == 5
    assert int(s_eager[0].count) == 5


def test_max_pool_ties_route_as_flax():
    """The gradient of a 2x2 max-pool with tied maxima goes where flax's
    goes (the first in raster order), in bf16 and in float32."""
    rng = np.random.RandomState(1)
    x = rng.randint(0, 3, (2, 8, 8, 3)).astype(np.float32)
    w = rng.randn(2, 4, 4, 3).astype(np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = jax.jit(jax.grad(lambda a: (nn.max_pool(
            a, (2, 2), strides=(2, 2)).astype(jnp.float32) * w).sum()))(
                jnp.asarray(x, jdt))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
        xt.requires_grad_()
        (F.max_pool2d(xt, 2).float()
         * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
        got = xt.grad.float().permute(0, 2, 3, 1).numpy()
        assert (got != 0).sum() == 2 * 4 * 4 * 3
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


# ---------------------------------------------------- one step per model

def _unet_inputs(h, w):
    rng = np.random.RandomState(h * w)
    return (rng.randint(0, 256, (2, h, w)).astype(np.uint8),
            rng.rand(2, h, w) < 0.1)


def _jax_unet_grads(theirs, images, masks, pos_weight=8.0):
    """JAX's DefectSegmenter loss (heimdall_tpu/models/segmentation.py:
    85-122) and its gradients from the segmenter's parameters."""
    x, (H, W) = jseg._to_model_input(images)
    y = jnp.asarray(masks, jnp.float32)
    ph, pw = x.shape[1] - H, x.shape[2] - W
    y = jnp.pad(y, ((0, 0), (0, ph), (0, pw)))
    w = jnp.where(y > 0, pos_weight, 1.0)
    w = w * jnp.zeros(x.shape[1:3], jnp.float32).at[:H, :W].set(1.0)[None]

    def loss_fn(params):
        logits = theirs.model.apply({"params": params}, x)[..., 0]
        bce = optax.sigmoid_binary_cross_entropy(logits, y)
        return (bce * w).sum() / jnp.maximum(w.sum(), 1.0)

    return jax.jit(jax.value_and_grad(loss_fn))(theirs.params)


def result(loss_j, grads_j, after_j, loss_t, model, tols, loss_tol):
    return {"loss_j": float(loss_j), "grads_j": grads_j, "after_j": after_j,
            "loss_t": loss_t, "grads_t": port_state(model, grads=True),
            "after_t": port_state(model), "tols": tols,
            "loss_tol": loss_tol}


@functools.lru_cache(maxsize=None)
def _unet_cases():
    """The UNet (base 8) at 32x32 and 30x34 (padded to 32x36; the padded
    rows and columns masked out) from one JAX segmenter's initial
    parameters; JAX's train step at 32x32."""
    theirs = quick_init(jseg.SegmentationUNet,
                        lambda: jseg.DefectSegmenter(base=8), 1)
    initial = convert.state_dict_from_flax(jax.device_get(theirs.params))
    out = {}
    for h, w in ((30, 34), (32, 32)):
        images, masks = _unet_inputs(h, w)
        loss_j, g = _jax_unet_grads(theirs, images, masks)
        after_j = None
        if (h, w) == (32, 32):
            theirs.train_step(images, masks)
            after_j = state(theirs.params)
        mine = tseg.DefectSegmenter(base=8, device="cpu")
        mine.model.load_state_dict(initial)
        loss_t = mine.train_step(images, masks)
        grads_j = state(g)
        out[f"unet_{h}x{w}"] = result(
            loss_j, grads_j, after_j, loss_t, mine.model,
            rule.f32_tols(grads_j), rule.F32_LOSS_TOL)
    return out


def _steps(c):
    """c's JAX step and the port's, in tests/_torch_step_rule.py's form."""
    return ({"loss": c.get("loss_j"), "grads": c["grads_j"],
             "params": c.get("after_j")},
            {"loss": c.get("loss_t"), "grads": c.get("grads_t"),
             "params": c.get("after_t")})


def check_loss_and_gradients(name, c, bias_cos=rule.BIAS_COS):
    """c's loss within its tolerance, each gradient tensor with a
    tolerance within it (relative to the tensor's largest |g_jax|), and
    the tensors without one (a bf16 layer's biases) together at a cosine
    of at least bias_cos."""
    ref, got = _steps(c)
    figures = rule.hold_loss_and_gradients(name, ref, got, c["tols"],
                                           c["loss_tol"], bias_cos)
    print(f"{name}: loss rel {figures['loss_rel_err']:.3g}; gradients "
          + ", ".join(f"{k} {v:.2g}" for k, v in figures["grad_errs"].items())
          + ("" if figures["bias_cos"] is None else
             f"; bf16 layers' bias gradients, cosine "
             f"{figures['bias_cos']:.5f}"))


def check_train_step(name, c):
    """The parameters after one step: within PARAM_TOL where |g_jax|
    exceeds the gradient noise (its tensor's tolerance times its largest
    |g|, or all of a bf16 layer's biases), within 2 * lr elsewhere; at
    most APART_SHARE of them further apart than PARAM_TOL."""
    ref, got = _steps(c)
    figures = rule.hold_params(name, ref, got, c["tols"], LR)
    print(f"{name}: {figures['quiet']} of {figures['params']} elements "
          f"within the gradient noise, {figures['params_apart']} apart by "
          f"more than {rule.PARAM_TOL}")


@pytest.mark.parametrize("name", ("unet_32x32", "unet_30x34"))
def test_unet_loss_and_gradients_equal_jax(name):
    check_loss_and_gradients(name, _unet_cases()[name])


def test_unet_train_step_equals_jax():
    check_train_step("unet_32x32", _unet_cases()["unet_32x32"])


@pytest.mark.parametrize("h, w", [(32, 32), (30, 34)])
def test_unet_float64_step_holds_the_float32_step(h, w):
    """The UNet's train step in float64 (the model made float64 with
    model.double(): the reference that the card's float32 step is held
    against at line size, chip_smoke.py's phase 4h and
    tests/test_torch_training_cuda.py) holds the float32 step to the
    float32 rule, and keeps the model in float64."""
    images, masks = _unet_inputs(h, w)
    steps = {}
    for dtype in (torch.float32, torch.float64):
        seg = tseg.DefectSegmenter(base=8, device="cpu")
        seg.model.to(dtype)
        loss = seg.train_step(images, masks)
        assert {p.dtype for p in seg.model.parameters()} == {dtype}
        steps[dtype] = {"loss": loss,
                        "grads": port_state(seg.model, grads=True),
                        "params": port_state(seg.model)}
    ref = steps[torch.float64]
    figures = rule.hold_step(f"unet {h}x{w} float32 against float64", ref,
                             steps[torch.float32], rule.f32_tols(
                                 ref["grads"]), rule.F32_LOSS_TOL, LR)
    print(figures)


def test_unet_grad_precision_script():
    """scripts/unet_grad_precision.py on the CPU at 2 x 32 x 48: the
    float32 step within the float32 rule of the float64 one; its main
    needs a card."""
    from heimdall_tpu_torch.scripts import unet_grad_precision as ugp
    from heimdall_tpu_torch import scene

    frames = scene.ring_frames(2, 32, 48, seed=3)
    out, loss = ugp.measure(frames, frames[..., 1] < 60, ["cpu_float32"])
    row = out["cpu_float32"]
    assert np.isfinite(loss) and row["loss_rel_err"] <= rule.F32_LOSS_TOL
    assert set(row["errs"]) == {k for k, _ in tseg.DefectSegmenter(
        base=16, device="cpu").model.named_parameters()}
    assert 0 < row["max_err"] <= rule.F32_GRAD_TOL, row
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            ugp.main([])
