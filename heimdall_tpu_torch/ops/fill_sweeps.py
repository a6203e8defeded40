"""The sweep hole fill probe: the preprocess, then the hole fill by row and
column sweeps to a certificate, with one ingredient swapped.  Counterpart
of the Pallas kernel of heimdall_tpu's timing probe
scripts/profile_fill_variants.py (S4; the fill is
pallas_kernels.py::_fill_holes_sweeps); the port's profiler
heimdall_tpu_torch/scripts/profile_fill_variants.py runs it.

Each of VARIANTS is (pack, scan, grow, guard), the TPU code's names:

* pack: the run ids' start flags from a clamped read ("mxu") or from a
  wrapped read and the penalty clamp ("ladder");
* scan: the doubling ladder's edge fill as a wrapped read with an additive
  penalty ("masked") or as an index test and select ("iota");
* grow: a row max of masked lane reads then an up/down max ("new"), or four
  independent shifted ORs ("old");
* guard: 8 rows of seeded background above and below the frame, or none.

"new" is pallas_kernels.py::_fill_holes_sweeps as it stands, which is r3's
tuple.  All nine compute one function, the hole fill (background not
4-connected to the border becomes foreground), so they share one plain
version, which runs the TPU code's ladders; it equals the label kernel's
"fill" stage.

The card's design (csrc/fill_sweeps.cu) takes each sweep's run-OR as carry
arithmetic on bit words, with no ladder and no run ids, so "pack" and
"scan" have no counterpart there: a variant runs the instance of its
(grow, guard) pair, INSTANCES[variant], and ``fill_mask.instance`` names
the last call's.  ``run_ids`` (the first design's tensor-core run ids,
which the sweep CCL probes still run) stays a probe of its own.

Frames are BGR planes [B, 3, H, W] uint8 with W <= 1024 and H <= 1008.  On
a CUDA tensor ``fill_sweeps`` runs the label kernel's "pre" stage, then
``fill_mask`` (csrc/fill_sweeps.cu, hd_sweep_fill: one launch), and raises
if it cannot; on a CPU tensor it runs the plain version.
"""

import collections
import math

import torch

from heimdall_tpu_torch.ops import _launch
from heimdall_tpu_torch.ops.split_kernels import (check_frames, label_kernel,
                                                  label_kernel_reference)

# name: (pack, scan, grow, guard), as scripts/profile_fill_variants.py:168-186
VARIANTS = {
    "new": ("mxu", "iota", "old", False),
    "mxu_pack": ("mxu", "masked", "new", True),
    "iota_scan": ("ladder", "iota", "new", True),
    "old_grow": ("ladder", "masked", "old", True),
    "r3": ("mxu", "iota", "old", False),
    "masked_only": ("mxu", "masked", "old", False),
    "guards_only": ("mxu", "iota", "old", True),
    "ladder_only": ("ladder", "iota", "old", False),
    "new2": ("ladder", "masked", "new", True),
}
# the instance of csrc/fill_sweeps.cu that each variant runs: (grow, guard)
INSTANCES = {name: f"{grow}_grow_{'guard' if guard else 'noguard'}"
             for name, (_, _, grow, guard) in VARIANTS.items()}
GUARD_ROWS = 8
MAX_LINE = 1024          # a row or a guarded column of at most 1024 px
SMEM_BYTES = 232448      # one block's shared memory on an H100
_PEN = 1 << 30           # the ladder's edge fill


def shift(v: torch.Tensor, d: int, dim: int, fill) -> torch.Tensor:
    """out[i] = v[i - d] along dim (d may be negative), fill where i - d
    leaves the axis."""
    n = v.shape[dim]
    if abs(d) >= n:
        return torch.full_like(v, fill)
    pad = torch.full_like(v.narrow(dim, 0, abs(d)), fill)
    if d > 0:
        return torch.cat([pad, v.narrow(dim, 0, n - d)], dim)
    return torch.cat([v.narrow(dim, -d, n + d), pad], dim)


def ladder_steps(n: int) -> int:
    """Steps of a doubling ladder that reaches across a line of n."""
    return max(1, math.ceil(math.log2(n)))


def _min_scan(v, dim, steps, backward):
    for s in range(steps):
        v = torch.minimum(v, shift(v, -(1 << s) if backward else 1 << s,
                                   dim, _PEN))
    return v


def run_min(v: torch.Tensor, rb: torch.Tensor, dim: int,
            steps: int) -> torch.Tensor:
    """The min over each run along dim within 2^steps - 1 positions each
    way, by doubling min-scans of packed keys: v - rb forward, v + rb
    backward (rb: run ids times a step above every value's spread, so no
    run's keys reach another's)."""
    v = _min_scan(v - rb, dim, steps, False) + rb
    return _min_scan(v + rb, dim, steps, True) - rb


def run_count(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Number of runs of x (nonzero) that start at or before each position
    along dim, int32 (1-based on a run; 0 before the first)."""
    x = x != 0
    start = x & ~shift(x, 1, dim, False)
    return start.cumsum(dim, dtype=torch.int32)


def _run_or(f, rb, dim, steps):
    """The OR over each background run (f in {0, 1}): the max by packed
    keys, f + rb forward and f - rb backward, as run_min of -f."""
    return -run_min(-f, rb, dim, steps)


def _grow4(e, bg):
    g = e
    for d, dim in ((1, -2), (-1, -2), (1, -1), (-1, -1)):
        g = g | shift(e, d, dim, 0)
    return g & bg


def _run_ids(bg: torch.Tensor, dim: int) -> torch.Tensor:
    """2 * (number of run starts of bg up to each position along dim)."""
    return 2 * run_count(bg, dim)


def sweep_fill_reference(mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the sweep fill of mask [B, H, W] (nonzero =
    foreground) -> filled u8 [B, H, W] (0/1): row phase (full-width ladder),
    column phase (ladder cut to 5 steps), repeated until one grow4 adds
    nothing, as _fill_holes_sweeps(adaptive=True) does."""
    bg = (mask == 0).to(torch.int32)
    H, W = bg.shape[-2:]
    border = torch.zeros((H, W), dtype=torch.int32, device=bg.device)
    border[0] = border[-1] = 1
    border[:, 0] = border[:, -1] = 1
    rb_r, rb_t = _run_ids(bg, -1), _run_ids(bg, -2)
    row_steps, col_steps = ladder_steps(W), min(ladder_steps(H), 5)
    e = bg * border
    while True:
        e = _run_or(_grow4(e, bg), rb_r, -1, row_steps) & bg
        e = _run_or(_grow4(e, bg), rb_t, -2, col_steps) & bg
        if not bool((_grow4(e, bg) & (1 - e)).any()):
            return (1 - e).to(torch.uint8)


def fill_sweeps_reference(frames: torch.Tensor, contrast_threshold):
    """Plain version of fill_sweeps (every variant)."""
    return sweep_fill_reference(
        label_kernel_reference(frames, contrast_threshold, "pre"))


def _guarded_bg(mask: torch.Tensor, guard: bool) -> torch.Tensor:
    bg = (mask == 0).to(torch.int32)
    if not guard:
        return bg
    rows = torch.ones(bg.shape[:-2] + (GUARD_ROWS, bg.shape[-1]),
                      dtype=torch.int32, device=bg.device)
    return torch.cat([rows, bg, rows], -2)


def run_ids_reference(mask: torch.Tensor, guard: bool = False):
    """Plain version of hd_run_ids: (rb_r int16 [B, Hg, W] along the rows,
    rb_t int16 [B, W, Hg] along the columns) of the background of mask with
    ``guard`` rows of background above and below (Hg = H + 16 with guard)."""
    bg = _guarded_bg(mask, guard)
    return (_run_ids(bg, -1).to(torch.int16),
            _run_ids(bg, -2).transpose(-1, -2).contiguous().to(torch.int16))


def _check_plane(H, W):
    Hg = H + 2 * GUARD_ROWS
    words = -(-W // 32)
    if (W > MAX_LINE or Hg > MAX_LINE
            or 8 * Hg * words + 16 * 4 * max(W, Hg) > SMEM_BYTES):
        raise ValueError(f"the sweep fill takes frames of at most "
                         f"{MAX_LINE} columns and {MAX_LINE - 2 * GUARD_ROWS}"
                         f" rows, got {H}x{W}")


def run_ids(mask: torch.Tensor, guard: bool = False, pack: str = "mxu"):
    """The run ids of the background of mask u8 [B, H, W] (1 = foreground):
    the tensor-core product of the start flags with the triangular matrix
    (pack "mxu" or "ladder": how the start flags are read).  Returns
    run_ids_reference's planes.  ``run_ids.launches`` counts kernel
    launches."""
    if pack not in ("mxu", "ladder"):
        raise ValueError(f"pack must be 'mxu' or 'ladder', got {pack!r}")
    B, H, W = _launch.check_mask(mask)
    _check_plane(H, W)
    if mask.device.type == "cpu":
        return run_ids_reference(mask, guard)
    from heimdall_tpu_torch.ops import _cuda

    _launch.check_cuda(mask, "mask", (torch.uint8,))
    Hg = H + (2 * GUARD_ROWS if guard else 0)
    rb_r = torch.empty((B, Hg, W), dtype=torch.int16, device=mask.device)
    rb_t = torch.empty((B, W, Hg), dtype=torch.int16, device=mask.device)
    err = _cuda.library("fill_sweeps").hd_run_ids(
        mask.data_ptr(), B, H, W, int(guard), ("mxu", "ladder").index(pack),
        rb_r.data_ptr(), rb_t.data_ptr(), _launch.stream(mask))
    _launch.raise_on(err, "run_ids")
    run_ids.launches += 1
    return rb_r, rb_t


run_ids.launches = 0


def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got "
                         f"{variant!r}")


def fill_mask(mask: torch.Tensor, variant: str = "new") -> torch.Tensor:
    """The hole fill (u8 0/1 [B, H, W]) of mask u8 [B, H, W] (nonzero =
    foreground) by the sweep fill of ``variant`` (one of VARIANTS): on a
    CUDA tensor one launch of hd_sweep_fill's (grow, guard) instance,
    INSTANCES[variant], on a CPU tensor the plain version.
    ``fill_mask.launches`` counts kernel launches,
    ``fill_mask.variant_launches`` counts them by variant and
    ``fill_mask.instance`` names the last launch's instance ("plain" on
    the CPU)."""
    _check_variant(variant)
    B, H, W = _launch.check_mask(mask)
    _check_plane(H, W)
    if mask.device.type == "cpu":
        fill_mask.instance = "plain"
        return sweep_fill_reference(mask)
    from heimdall_tpu_torch.ops import _cuda

    _launch.check_cuda(mask, "mask", (torch.uint8,))
    _, _, grow, guard = VARIANTS[variant]
    filled = torch.empty((B, H, W), dtype=torch.uint8, device=mask.device)
    err = _cuda.library("fill_sweeps").hd_sweep_fill(
        mask.data_ptr(), B, H, W, int(guard), ("new", "old").index(grow),
        filled.data_ptr(), _launch.stream(mask))
    _launch.raise_on(err, "fill_sweeps")
    fill_mask.launches += 1
    fill_mask.variant_launches[variant] += 1
    fill_mask.instance = INSTANCES[variant]
    return filled


fill_mask.launches = 0
fill_mask.variant_launches = collections.Counter()
fill_mask.instance = None


def fill_sweeps(frames: torch.Tensor, contrast_threshold,
                variant: str = "new") -> torch.Tensor:
    """The filled mask (u8 0/1 [B, H, W]) of frames [B, 3, H, W] uint8 by
    the sweep fill of ``variant`` (one of VARIANTS): the label kernel's
    "pre" stage, then fill_mask (whose ``instance`` names the instance
    that ran).  ``fill_sweeps.launches`` counts the probe's calls that
    launched (the label kernel and fill_mask count their own launches) and
    ``fill_sweeps.variant_launches`` counts them by variant."""
    _check_variant(variant)
    check_frames(frames)
    _check_plane(*frames.shape[-2:])
    if frames.device.type == "cpu":
        return fill_sweeps_reference(frames, contrast_threshold)
    _launch.check_cuda(frames, "frames", (torch.uint8,))
    filled = fill_mask(label_kernel(frames, contrast_threshold, "pre"),
                       variant)
    fill_sweeps.launches += 1
    fill_sweeps.variant_launches[variant] += 1
    return filled


fill_sweeps.launches = 0
fill_sweeps.variant_launches = collections.Counter()
