"""How far the float32 UNet's gradient lies from float64, per tensor, on
the card under each cuDNN setting and on the CPU (one step's loss of
``DefectSegmenter.train_step``, base 16, at the same seeded parameters,
on ring frames with their dark rings as masks).

Every row is held against the same gradient in float64 on the CPU
(``model.double()``), each tensor's error as a share of its largest
|g|: the card's step as ``train_step`` runs it (TF32 off through the
backward), with ``cudnn.benchmark``, with ``cudnn.deterministic``, with
cuDNN off, with the backward in TF32, and in float64; the CPU's float32
step.  It tells a reduced-precision backward from float32's own noise
at line size, where the CPU's float32 sums are not a reference.  It
measures the card: without one it exits with an error.

Usage: python -m heimdall_tpu_torch.scripts.unet_grad_precision
           [frames] [height] [width]        (default 8 480 640)
"""

import sys
import time

import numpy as np
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.models.segmentation import DefectSegmenter

# name: (device, dtype, cuDNN flags for the forward and the backward, TF32
# in the backward)
VARIANTS = {
    "card_float32": ("cuda", torch.float32, {}, False),
    "card_benchmark": ("cuda", torch.float32, {"benchmark": True}, False),
    "card_deterministic": ("cuda", torch.float32, {"deterministic": True},
                           False),
    "card_no_cudnn": ("cuda", torch.float32, {"enabled": False}, False),
    "card_tf32_backward": ("cuda", torch.float32, {}, True),
    "card_float64": ("cuda", torch.float64, {}, False),
    "cpu_float32": ("cpu", torch.float32, {}, False),
}


def step_grads(frames, masks, device, dtype, flags=None, tf32=False):
    """(loss, {name: float64 gradient}, seconds) of one step's loss on
    device in dtype, the forward and the backward under cuDNN ``flags``
    (TF32 off unless ``tf32``: then the backward runs with it allowed)."""
    seg = DefectSegmenter(base=16, seed=0, device=device)
    seg.model.to(dtype)
    loss_fn = seg._loss_fn(frames, masks, 8.0)
    cudnn = torch.backends.cudnn
    setting = dict(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                   deterministic=cudnn.deterministic, allow_tf32=False)
    setting.update(flags or {})
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with cudnn.flags(**setting):
        loss = loss_fn()
    with cudnn.flags(**dict(setting, allow_tf32=tf32)):
        loss.backward()
    sync()
    return (float(loss.detach()), {k: p.grad.detach().cpu().double().numpy()
                          for k, p in seg.model.named_parameters()},
            time.perf_counter() - t0)


def errors(ref, grads):
    return {k: float(np.abs(grads[k] - g).max() / np.abs(g).max())
            for k, g in ref.items()}


def measure(frames, masks, variants):
    """{variant: {"loss_rel_err", "max_err", "s", "errs": {tensor: err}}}
    against the float64 step on the CPU, and that step's loss."""
    ref_loss, ref, _ = step_grads(frames, masks, "cpu", torch.float64)
    out = {}
    for name in variants:
        device, dtype, flags, tf32 = VARIANTS[name]
        loss, grads, s = step_grads(frames, masks, device, dtype, flags,
                                    tf32)
        errs = errors(ref, grads)
        out[name] = {"loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
                     "max_err": max(errs.values()), "s": s, "errs": errs}
    return out, ref_loss


def main(argv=None):
    from heimdall_tpu_torch.scripts.timing import card, require_card
    argv = sys.argv[1:] if argv is None else argv
    require_card()
    n, h, w = (int(a) for a in (argv + ["8", "480", "640"][len(argv):]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = scene.ring_frames(n, h, w, seed=3)
    masks = frames[..., 1] < 60
    out, loss = measure(frames, masks, VARIANTS)
    print(f"{card()}: UNet base 16 on {n}x{h}x{w}, loss {loss:.6f}; each "
          f"gradient tensor against float64 on the CPU, as a share of its "
          f"largest |g|")
    keys = list(next(iter(out.values()))["errs"])
    print("variant".ljust(19), "loss_rel".rjust(9), "max".rjust(9),
          "s".rjust(7), " ".join(k.rjust(22) for k in keys))
    for name, r in out.items():
        print(name.ljust(19), f"{r['loss_rel_err']:9.2e}",
              f"{r['max_err']:9.2e}", f"{r['s']:7.3f}",
              " ".join(f"{r['errs'][k]:22.2e}" for k in keys))
    return out


if __name__ == "__main__":
    main()
