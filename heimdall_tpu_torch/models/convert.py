"""The JAX models' parameters carried across: flax parameter trees (as
numpy) to the port's ``state_dict``s, and back.

A layer's kind follows from its flax name, which the port's modules keep
as their attribute names (``Conv_0``, ``ConvTranspose_1``, ``Dense_0``):

- ``Conv`` kernels go from HWIO to OIHW;
- ``ConvTranspose`` kernels (``transpose_kernel=False``: lax.conv_transpose
  correlates the dilated input with the kernel as given, where
  torch's conv_transpose2d uses it flipped) are flipped in both spatial
  axes and laid out (in, out, kh, kw);
- ``Dense`` kernels are transposed; the first Dense after a flatten also
  has its rows permuted from flax's NHWC flatten order (h, w, c) to the
  port's NCHW order (c, h, w);
- biases are copied.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _kind(name: str) -> str:
    for kind in ("ConvTranspose", "Conv", "Dense"):
        if name.startswith(kind + "_"):
            return kind
    raise ValueError(f"unknown flax layer name {name!r}")


def conv_weight(kernel: np.ndarray) -> np.ndarray:
    """flax Conv kernel HWIO -> torch OIHW."""
    return np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1))


def conv_transpose_weight(kernel: np.ndarray) -> np.ndarray:
    """flax ConvTranspose kernel (kh, kw, in, out) -> torch
    conv_transpose2d's (in, out, kh, kw), flipped in both spatial axes."""
    k = np.asarray(kernel)[::-1, ::-1]
    return np.ascontiguousarray(k.transpose(2, 3, 0, 1))


def dense_weight(kernel: np.ndarray,
                 flatten: Optional[Tuple[int, int, int]] = None
                 ) -> np.ndarray:
    """flax Dense kernel [in, out] -> torch Linear [out, in].  flatten =
    (H, W, C) of the NHWC map that flax flattened into ``in``: the rows
    are reordered for the port's flatten of the same map in NCHW."""
    k = np.asarray(kernel)
    if flatten is not None:
        H, W, C = flatten
        k = k.reshape(H, W, C, -1).transpose(2, 0, 1, 3).reshape(H * W * C,
                                                                  -1)
    return np.ascontiguousarray(k.T)


def state_dict_from_flax(params: Dict, flatten: Optional[Dict[str, Tuple]]
                         = None) -> Dict[str, torch.Tensor]:
    """A flax ``params`` tree ({layer: {"kernel", "bias"}}) as the port's
    state_dict; ``flatten`` maps a Dense layer's name to the (H, W, C) of
    the map flattened into it."""
    flatten = flatten or {}
    out = {}
    for name, p in params.items():
        kind = _kind(name)
        k = np.asarray(p["kernel"], np.float32)
        if kind == "Conv":
            w = conv_weight(k)
        elif kind == "ConvTranspose":
            w = conv_transpose_weight(k)
        else:
            w = dense_weight(k, flatten.get(name))
        out[f"{name}.weight"] = torch.from_numpy(w.copy())
        out[f"{name}.bias"] = torch.from_numpy(
            np.asarray(p["bias"], np.float32).copy())
    return out


def flax_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of state_dict_from_flax for conv layers (the UNet's):
    {layer: {"kernel": HWIO / (kh, kw, in, out), "bias"}} as numpy."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for key, t in state_dict.items():
        name, field = key.rsplit(".", 1)
        a = t.detach().cpu().numpy().astype(np.float32)
        if field == "bias":
            params.setdefault(name, {})["bias"] = a
            continue
        kind = _kind(name)
        if kind == "Conv":
            k = a.transpose(2, 3, 1, 0)
        elif kind == "ConvTranspose":
            k = a.transpose(2, 3, 0, 1)[::-1, ::-1]
        else:
            raise ValueError(f"{name}: only conv layers go back to flax")
        params.setdefault(name, {})["kernel"] = np.ascontiguousarray(k)
    return params
