"""The per-step primitive microbench: one primitive of the sweep kernels
iterated N times on each frame's plane, with a data-dependent carry.
Counterpart of the Pallas kernel of heimdall_tpu's timing script
scripts/microbench_vpu.py (S8: make_call's kernel); the port's
heimdall_tpu_torch/scripts/microbench_vpu.py times it by the script's
differencing protocol.

Each of VARIANTS is (name, dtype, sub, factory), in the script's order
(its bodies, then its factories, whose edge masks the TPU builds once per
kernel).  A frame is a plane [sub, W] of ``dtype``; every variant's step is
one function of that plane (step_reference), and the kernel applies it
``iters`` times and writes rows [0, out_rows) as int32: row 0 alone, as the
script does (out_rows = 1), or the whole plane (out_rows = sub).

On a CUDA tensor ``primitive_steps`` runs csrc/primitives.cu
(hd_primitive_steps) and raises if it cannot; on a CPU tensor it runs the
plain version.
"""

import collections

import numpy as np
import torch

from heimdall_tpu_torch.ops import _launch
from heimdall_tpu_torch.ops.fill_sweeps import SMEM_BYTES, shift

H, W = 480, 640          # the script's plane
B = 256                  # the script's batch

# (name, dtype, sub, factory), as scripts/microbench_vpu.py's todo list
# (VARIANTS :256-277, then FACTORY_VARIANTS :244-253)
VARIANTS = (
    ("min_scan_step", "int32", H, False),
    ("min_scan_step", "int16", H, False),
    ("min_scan_step", "int8", H, False),
    ("max_scan_step", "int16", H, False),
    ("or_roll", "int32", H, False),
    ("or_roll", "int16", H, False),
    ("or_roll", "int8", H, False),
    ("nbmin8", "int32", H, False),
    ("nbmin8", "int16", H, False),
    ("nbmin8", "int8", H, False),
    ("add", "int32", H, False),
    ("add", "int16", H, False),
    ("select", "int32", H, False),
    ("select", "int16", H, False),
    ("transpose_pair", "int32", H, False),
    ("transpose_pair", "int16", H, False),
    ("seg_min_step", "int32", 2 * H, False),
    ("seg_min_step", "int16", 2 * H, False),
    ("mxu_cumsum", "int32", H, False),
    ("cumsum_ladder", "int32", H, True),
    ("masked_min_step", "int32", H, True),
    ("masked_ladder5", "int32", H, True),
    ("nbmin_guard", "int32", H, True),
    ("nbmin_masked_sub", "int32", H, True),
    ("or_and_mask", "int32", H, True),
    ("max_ladder_full", "int32", H, True),
    ("sublane_mask_add", "int32", H, True),
)
# the kernel's step codes (csrc/primitives.cu: enum Step) and type codes
STEPS = tuple(dict.fromkeys(name for name, *_ in VARIANTS))
DTYPES = ("int32", "int16", "int8")
# steps whose rows depend on other rows: one frame per thread block cluster
CROSS_ROW = ("nbmin8", "nbmin_guard", "nbmin_masked_sub", "sublane_mask_add")
MAX_W = 640              # one warp's line: 20 values a lane
# A cross-row plane is taken where it fits the shared memory of 8 blocks
# (csrc/primitives.cu: k_cross_rows, which holds frames of more than 1024
# rows; shorter ones run as bands of rows in registers)
CLUSTER = 8
_PEN = 1 << 30           # masked_min_step's and masked_ladder5's edge mask
_GUARD = 1 << 24         # nbmin_guard's, nbmin_masked_sub's, sublane_mask_add's
_FLOOR = -(1 << 22)      # max_ladder_full's
_L, _S = -1, -2          # lanes (columns) and sublanes (rows)


def _pen(v: torch.Tensor, d: int, dim: int, p: int) -> torch.Tensor:
    """roll(v, d) along dim plus p where the read wrapped (positions i < d
    for d > 0, i >= n + d for d < 0): the TPU code's roll plus a
    precomputed edge mask."""
    n = v.shape[dim]
    idx = torch.arange(n, device=v.device)
    wrapped = idx < d if d > 0 else idx >= n + d
    shape = [1] * v.dim()
    shape[dim] = n
    pen = torch.where(wrapped, p, 0).to(v.dtype).view(shape)
    return torch.roll(v, d, dim) + pen


def _min3(a, b, c):
    return torch.minimum(a, torch.minimum(b, c))


def _nbmin8(v):
    row = _min3(v, shift(v, 1, _L, 63), shift(v, -1, _L, 63))
    return _min3(row, shift(row, 1, _S, 63), shift(row, -1, _S, 63))


def _lane_guard(v):
    return _min3(v, _pen(v, 1, _L, _GUARD), _pen(v, -1, _L, _GUARD))


def _nbmin_guard(v):
    row = _lane_guard(v)
    return _min3(row, torch.roll(row, 1, _S), torch.roll(row, -1, _S))


def _nbmin_masked_sub(v):
    row = _lane_guard(v)
    return _min3(row, shift(row, 1, _S, 63), shift(row, -1, _S, 63))


def _seg_min_step(c):
    # rows [:sub/2] are the values v, rows [sub/2:] the flags f
    v, f = c.chunk(2, _S)
    v2 = torch.where(f > 0, v, torch.minimum(v, shift(v, 1, _L, 63)))
    return torch.cat([v2, f | shift(f, 1, _L, 1)], _S)


def _cumsum_ladder(v):
    v = v & 1
    for k in range(10):
        v = v + shift(v, 1 << k, _L, 0)
    return v


def _masked_ladder5(v):
    for k in range(5):
        v = torch.minimum(v, _pen(v, 1 << k, _L, _PEN))
    return v


def _max_ladder_full(v):
    for k in range(10):
        v = torch.maximum(v, _pen(v, 1 << k, _L, _FLOOR))
    return v


_STEP = {
    "min_scan_step": lambda v: torch.minimum(v, shift(v, 1, _L, 63)),
    "max_scan_step": lambda v: torch.maximum(v, shift(v, 1, _L, -1)),
    "or_roll": lambda v: v | torch.roll(v, 1, _L),
    "nbmin8": _nbmin8,
    "add": lambda v: v + 1,
    "select": lambda v: torch.where(v > 0, v, v + 1),
    # transpose, min, transpose back
    "transpose_pair": lambda v: v.clamp_max(63),
    "seg_min_step": _seg_min_step,
    # the triangular product on the TPU's MXU: exact (counts < 2^24)
    "mxu_cumsum": lambda v: torch.cumsum(v & 1, _L, dtype=v.dtype) & 63,
    "cumsum_ladder": _cumsum_ladder,
    "masked_min_step": lambda v: torch.minimum(v, _pen(v, 1, _L, _PEN)),
    "masked_ladder5": _masked_ladder5,
    "nbmin_guard": _nbmin_guard,
    "nbmin_masked_sub": _nbmin_masked_sub,
    "or_and_mask": lambda v: v | shift(v, 1, _L, 0),
    "max_ladder_full": _max_ladder_full,
    "sublane_mask_add": lambda v: torch.minimum(v, _pen(v, 1, _S, _GUARD)),
}


def step_reference(name: str, v: torch.Tensor) -> torch.Tensor:
    """One step of primitive ``name`` on planes v [..., sub, W]."""
    return _STEP[name](v)


def primitive_steps_reference(x: torch.Tensor, name: str, iters: int,
                              out_rows: int = 1) -> torch.Tensor:
    """Plain version of primitive_steps."""
    v = x
    for _ in range(iters):
        v = step_reference(name, v)
    return v[:, :out_rows].to(torch.int32)


def _check(x, name, iters, out_rows):
    dtype = str(x.dtype).removeprefix("torch.")
    if (name, dtype) not in {(n, d) for n, d, _, _ in VARIANTS}:
        raise ValueError(f"no variant {name!r} of type {dtype}: the "
                         f"variants are {[v[:2] for v in VARIANTS]}")
    if x.dim() != 3:
        raise ValueError(f"planes must be [B, sub, W], got {tuple(x.shape)}")
    n, sub, w = x.shape
    if not 1 <= n <= 65535 or sub < 1 or not 1 <= w <= MAX_W:
        raise ValueError(f"the kernel takes 1..65535 planes of at most "
                         f"{MAX_W} columns, got {tuple(x.shape)}")
    if name == "seg_min_step" and sub % 2:
        raise ValueError(f"seg_min_step's plane stacks values and flags: "
                         f"its rows must be even, got {sub}")
    rows = -(-sub // CLUSTER)
    if name in CROSS_ROW and (rows + 2) * w * x.element_size() > SMEM_BYTES:
        raise ValueError(f"{name} keeps a frame in the shared memory of "
                         f"{CLUSTER} blocks: {sub}x{w} {dtype} is too large")
    if not isinstance(iters, int) or iters < 0:
        raise ValueError(f"iters must be an int >= 0, got {iters!r}")
    if out_rows not in (1, sub):
        raise ValueError(f"out_rows must be 1 or {sub}, got {out_rows}")
    return dtype


def primitive_steps(x: torch.Tensor, name: str, iters: int,
                    out_rows: int = 1) -> torch.Tensor:
    """Primitive ``name`` applied ``iters`` times to each plane of x
    [B, sub, W] (its variant's dtype); returns rows [0, out_rows) as int32
    [B, out_rows, W].  ``primitive_steps.launches`` counts kernel launches
    and ``primitive_steps.variant_launches`` counts them by "name/dtype"."""
    dtype = _check(x, name, iters, out_rows)
    if x.device.type == "cpu":
        return primitive_steps_reference(x, name, iters, out_rows)
    from heimdall_tpu_torch.ops import _cuda

    _launch.check_cuda(x, "x", (x.dtype,))
    n, sub, w = x.shape
    out = torch.empty((n, out_rows, w), dtype=torch.int32, device=x.device)
    err = _cuda.library("primitives").hd_primitive_steps(
        x.data_ptr(), n, sub, w, STEPS.index(name), DTYPES.index(dtype),
        iters, out_rows, out.data_ptr(), _launch.stream(x))
    _launch.raise_on(err, "primitive_steps")
    primitive_steps.launches += 1
    primitive_steps.variant_launches[f"{name}/{dtype}"] += 1
    return out


primitive_steps.launches = 0
primitive_steps.variant_launches = collections.Counter()


def inputs(quick: bool = False, only=None, batch: int = B):
    """Yields (name, dtype, planes) for each variant the script runs, with
    the script's planes bit for bit: RandomState(0), then for each variant
    in order randint(0, min(60, dtype's max), (batch, sub, W)) as dtype.
    As in the script, ``only`` (a set of names) and ``quick`` (int32 and
    int16 only) skip variants before they draw."""
    rng = np.random.RandomState(0)
    for name, dtype, sub, _ in VARIANTS:
        if only is not None and name not in only:
            continue
        if quick and dtype not in ("int32", "int16"):
            continue
        lim = min(60, np.iinfo(dtype).max)
        yield name, dtype, rng.randint(0, lim, (batch, sub, W)).astype(dtype)
