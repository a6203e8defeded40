"""The rule that holds one train step against a reference step: the port
against JAX on the CPU (tests/test_torch_training.py,
tests/test_torch_training_bf16.py), the card against the port's CPU path
(tests/test_torch_training_cuda.py, chip_smoke.py's phase 4h).  It imports
no JAX, so chip_smoke.py can import it.

A step is {"loss": float, "grads": {name: ndarray} or None, "params":
{name: ndarray}} (the gradients of the step's loss at the parameters
before it, and the parameters after it).  ``tols`` gives each gradient
tensor its tolerance, relative to the tensor's largest |g| of the
reference, or None for the biases of a bf16 layer, which are held
together by their cosine with the reference.  A mismatch raises
AssertionError.

* The loss: within ``loss_tol`` relative (F32_LOSS_TOL for the float32
  UNet, BF16_LOSS_TOL for the bf16 models).
* The gradients: each tensor within its tolerance (F32_GRAD_TOL for the
  float32 UNet, BF16_KERNEL_TOL for the bf16 models' kernels and their
  float32 last layers); the bf16 layers' biases at a cosine of at least
  BIAS_COS.
* The parameters after one step: Adam's first step moves each by about
  lr * sign(g) on both sides, so where |g_ref| exceeds its tensor's
  gradient noise (its tolerance times its largest |g|; all of a bf16
  layer's biases count as noise) they agree within PARAM_TOL; elsewhere
  the signs may differ and they may lie up to 2 * lr apart.  At most
  APART_SHARE of all the parameters lie further than PARAM_TOL apart.
* AnomalyDetector.fit: the returned loss and the threshold within
  FIT_TOL relative.
"""

import numpy as np

F32_LOSS_TOL = 1e-5
F32_GRAD_TOL = 1e-5
BF16_LOSS_TOL = 1e-4
BF16_KERNEL_TOL = 1e-2
BIAS_COS = 0.95
PARAM_TOL = 1e-5
APART_SHARE = 2e-3
FIT_TOL = 1e-3


def f32_tols(grads, tol=F32_GRAD_TOL):
    """Every tensor of a float32 model at the same tolerance."""
    return dict.fromkeys(grads, tol)


def bf16_tols(grads, f32_layer):
    """A bf16 model's tolerances: BF16_KERNEL_TOL for the kernels and the
    float32 last layer (whose names start with f32_layer), None for the
    bf16 layers' biases."""
    return {k: None if k.endswith("bias") and not k.startswith(f32_layer)
            else BF16_KERNEL_TOL for k in grads}


def grad_errors(ref, got, tols):
    """{name: max|g - g_ref| / max|g_ref|} for the tensors with a
    tolerance."""
    return {k: float(np.abs(got[k] - g).max() / np.abs(g).max())
            for k, g in ref.items() if tols[k] is not None}


def hold_loss_and_gradients(name, ref, got, tols, loss_tol,
                            bias_cos=BIAS_COS):
    """The loss and every gradient tensor of got against ref; returns
    {"loss_rel_err", "grad_errs", "max_grad_err", "bias_cos"}."""
    rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    assert rel <= loss_tol, (name, got["loss"], ref["loss"])
    assert set(got["grads"]) == set(ref["grads"]), name
    for k, g in ref["grads"].items():
        assert got["grads"][k].shape == g.shape, (name, k)
    errs = grad_errors(ref["grads"], got["grads"], tols)
    bad = {k: v for k, v in errs.items() if v > tols[k]}
    assert not bad, (name, bad)
    cos = None
    biases = [k for k in ref["grads"] if tols[k] is None]
    if biases:
        a = np.concatenate([got["grads"][k] for k in biases])
        b = np.concatenate([ref["grads"][k] for k in biases])
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        assert cos >= bias_cos, (name, cos)
    return {"loss_rel_err": rel, "grad_errs": errs,
            "max_grad_err": max(errs.values(), default=0.0),
            "bias_cos": cos}


def hold_params(name, ref, got, tols, lr):
    """The parameters after one step of Adam at learning rate lr; returns
    {"quiet", "params_apart", "params"}."""
    quiet_n = apart = total = 0
    for k, g in ref["grads"].items():
        diff = np.abs(got["params"][k] - ref["params"][k])
        tol = 1.0 if tols[k] is None else tols[k]
        quiet = np.abs(g) <= tol * np.abs(g).max()
        assert diff[~quiet].max(initial=0) <= PARAM_TOL, (name, k)
        assert diff[quiet].max(initial=0) <= 2 * lr * (1 + 1e-3), (name, k)
        quiet_n += int(quiet.sum())
        apart += int((diff > PARAM_TOL).sum())
        total += diff.size
    assert apart <= APART_SHARE * total, (name, apart, total)
    return {"quiet": quiet_n, "params_apart": apart, "params": total}


def hold_step(name, ref, got, tols, loss_tol, lr):
    """hold_loss_and_gradients (the loss alone where got["grads"] is None)
    and hold_params; returns their figures together."""
    if got["grads"] is None:
        rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        assert rel <= loss_tol, (name, got["loss"], ref["loss"])
        figures = {"loss_rel_err": rel, "max_grad_err": None,
                   "bias_cos": None}
    else:
        figures = hold_loss_and_gradients(name, ref, got, tols, loss_tol)
        figures.pop("grad_errs")
    return dict(figures, **hold_params(name, ref, got, tols, lr),
                loss=got["loss"])
