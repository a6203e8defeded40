"""What the wrappers of the tiled kernels share (ops/ccl_tiled.py,
ops/stats_tiled.py, ops/runtable_tiled.py): argument checks, output
allocation, the per-frame ``active`` flags, the CPU path through a plain
version, and the check of a launch's CUDA error."""

import torch


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(t: torch.Tensor, name: str, dtypes, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {dtypes}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_mask(mask: torch.Tensor):
    """(B, H, W) of a plane batch within the kernels' index range."""
    if mask.dim() != 3:
        raise ValueError(f"planes must be [B, H, W], got {tuple(mask.shape)}")
    B, H, W = mask.shape
    if not (1 <= B <= 65535 and H >= 1 and W >= 1 and H * W < 2**31 - 1):
        raise ValueError(f"unsupported shape B={B} H={H} W={W}")
    return B, H, W


def raise_on(err: int, what: str):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def alloc(device, *specs):
    """Output tensors of (shape, dtype) specs: uninitialised on the card
    (the kernels write them), zeroed on the CPU."""
    new = torch.zeros if device.type == "cpu" else torch.empty
    return tuple(new(shape, dtype=dtype, device=device)
                 for shape, dtype in specs)


def active_ptr(active, B: int):
    """(tensor, address) of the kernels' frame flags: (None, None) for every
    frame, else an int32 [B] copy of ``active``, which the caller keeps
    alive until its launch is queued."""
    if active is None:
        return None, None
    flags = active.to(torch.int32).contiguous()
    check_cuda(flags, "active", (torch.int32,), (B,))
    return flags, flags.data_ptr()


def run_plain(reference, active, frame_args, args, outs):
    """A wrapper's CPU path: the plain version on the frames that active
    marks (every frame without it), written into outs."""
    sel = slice(None) if active is None else active.to(torch.bool)
    if active is not None and not bool(sel.any()):
        return
    res = reference(*(a[sel] for a in frame_args), *args)
    for o, r in zip(outs, (res,) if isinstance(res, torch.Tensor) else res):
        o[sel] = r
