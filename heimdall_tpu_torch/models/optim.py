"""The port's ``optax.adam`` and the training step its models share.

``Adam`` computes optax 0.2.6's ``adam`` (``scale_by_adam`` then
``scale_by_learning_rate``) in optax's order of operations, one
elementwise op at a time, so that no two of them fuse into a multiply-add:

    mu = (1 - b1) * g + b1 * mu          nu = (1 - b2) * g**2 + b2 * nu
    count += 1
    mu_hat = mu / (1 - b1**count)        nu_hat = nu / (1 - b2**count)
    u = mu_hat / (sqrt(nu_hat + eps_root) + eps)
    p = p + (-lr * u)

``torch.optim.Adam`` computes the same quantity in another order
(``lr / bc1`` times ``m / (sqrt(v) / sqrt(bc2) + eps)``, and on the card in
foreach or fused kernels), which differs in the last bits.  The bias
corrections are rounded to float32 on the host as XLA rounds them (numpy's
float32 power equals XLA's for every count up to 20,000) and divide as a
float32 tensor on the parameters' device: CUDA divides by a Python scalar
through its reciprocal.  The state (``mu`` and ``nu`` a parameter,
float32, on its device; one ``count`` a parameter group, as optax keeps
one) follows optax's; a parameter without a gradient steps on a zero
gradient, as optax's does.
"""

import numpy as np
import torch

from heimdall_tpu_torch.models.layers import float32_convs


class Adam(torch.optim.Optimizer):
    """optax.adam(lr, b1, b2, eps, eps_root) over torch parameters."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        super().__init__(params, {"lr": lr, "b1": b1, "b2": b2, "eps": eps,
                                  "eps_root": eps_root})

    @staticmethod
    def _bias_correction(decay: float, count: int, device) -> torch.Tensor:
        bc = np.float32(1) - np.float32(decay) ** np.float32(count)
        return torch.tensor(bc, dtype=torch.float32, device=device)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, b1, b2 = group["lr"], group["b1"], group["b2"]
            eps, eps_root = group["eps"], group["eps_root"]
            group["count"] = count = group.get("count", 0) + 1
            corrections = {}
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p, dtype=torch.float32)
                    state["nu"] = torch.zeros_like(p, dtype=torch.float32)
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state["mu"] = g * (1 - b1) + state["mu"] * b1
                state["nu"] = (g * g) * (1 - b2) + state["nu"] * b2
                if p.device not in corrections:
                    corrections[p.device] = (
                        self._bias_correction(b1, count, p.device),
                        self._bias_correction(b2, count, p.device))
                bc1, bc2 = corrections[p.device]
                u = (state["mu"] / bc1) / (
                    torch.sqrt(state["nu"] / bc2 + eps_root) + eps)
                p.add_(u * -lr)
        return loss


def train_step(optimizer: torch.optim.Optimizer, loss_fn, device,
               reduce_grads=None) -> torch.Tensor:
    """One optimizer step: loss_fn() -> scalar loss, its backward,
    reduce_grads() (the sharded step's all-reduce) and the update; returns
    the loss, detached.  The forward and the backward hold float32_convs:
    cuDNN's flag is read when each convolution runs, so a backward run
    after the forward's block has exited would compute a float32 model's
    gradients in TF32.  The all-reduce and the update run no convolution,
    and run after the lock is let go."""
    with float32_convs(torch.device(device)):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
    if reduce_grads is not None:
        reduce_grads()
    optimizer.step()
    return loss.detach()
