"""The labeling probes: the 8-connected labels of a filled mask by row and
column sweeps of run-packed doubling scans to a certificate, with one
ingredient swapped, or by run tables.  Counterpart of the Pallas kernel of
heimdall_tpu's timing probe scripts/profile_ccl_variants.py (S5; its "cur"
is pallas_kernels.py::_ccl_sweeps) and of scripts/check_runtable.py (S7);
the port's profiler heimdall_tpu_torch/scripts/profile_ccl_variants.py runs
it.

Each of SWEEP_VARIANTS is a Sweep, the TPU code's knobs:

* ss: ladder steps of a phase's packed min-scan (reach 2^ss - 1);
* cert: "nb" (one more 3x3 min lowers no label) or "cheap" (the unit
  changed no label);
* guard: 8 rows of background above and below the frame, or none;
* fixed: that many units and no certificate (a timing probe: frames may
  stop short of their labels);
* unit: 3 phases (row, column, row) or 2 (row, column);
* presweep: one unit of whole-line ladders first;
* ss_r: "full" for whole-row ladders in the row phases.

RUNTABLE_VARIANTS are the run-table CCL at R runs per row (scripts/
profile_ccl_variants.py:33-148): per-row run tables [R, H], a min along each
slot's vertical chains of overlapping runs and an 8-overlap exchange
between rows to a certificate; a frame with a row of more than R runs takes
"cur" instead.  On the card the tables come from the mask's bits, and only
the frames that take "cur" get run ids (``ccl_runtable.runid_frames``).
Every variant but "fixed2" gives the labels of the label kernel's "ccl"
stage (the least linear index of the component, background H*W); "fixed2"
gives its own plain version's.

Masks are u8 [B, H, W] (nonzero = foreground) with W <= 1024 and H <= 1008.
On a CUDA tensor ``ccl_mask`` and ``ccl_runtable`` launch
csrc/ccl_sweeps.cu (hd_sweep_ccl, hd_runtable_ccl) and raise if they
cannot; on a CPU tensor they run the plain versions.  ``ccl_variant`` is
the probe as the profiler runs it: the label kernel's "fill" stage on
frames, then ``ccl_mask``.

The sweep kernels (this module's and ops/joint_label.py's) take one of two
paths, chosen from the frame's shape by ``band_layout``: "cluster", a
thread-block cluster per frame with both label planes in the blocks' shared
memory (csrc/sweep_cluster.cuh), wherever a block's band of them fits
(``band_bytes``), and "global", one block per frame over planes in device
memory, for the larger frames.  A ``path`` argument asks for one of them
and raises where it cannot run; ``.last_path`` keeps the last call's path
("cluster", "global", or "plain" on the CPU).
"""

import collections
from typing import NamedTuple, Optional

import torch

from heimdall_tpu_torch.ops import _launch
from heimdall_tpu_torch.ops.fill_sweeps import (GUARD_ROWS, MAX_LINE,
                                                 SMEM_BYTES, ladder_steps,
                                                 run_count, run_min, shift)
from heimdall_tpu_torch.ops.split_kernels import (check_frames, label_kernel,
                                                  label_kernel_reference)


class Sweep(NamedTuple):
    ss: int = 5
    cert: str = "nb"
    guard: bool = True
    fixed: Optional[int] = None
    unit: int = 3
    presweep: bool = False
    ss_r: Optional[str] = None


# scripts/profile_ccl_variants.py:303-322; "cur" is _ccl_sweeps(adaptive=True,
# scan_steps=5)
SWEEP_VARIANTS = {
    "cur": Sweep(),
    "ss4": Sweep(ss=4),
    "ss6": Sweep(ss=6),
    "cheapcert": Sweep(cert="cheap"),
    "noguard": Sweep(guard=False),
    "fixed2": Sweep(fixed=2),
    "presweep": Sweep(presweep=True),
    "unit2": Sweep(unit=2),
    "pre_unit2": Sweep(unit=2, presweep=True),
    "asym_r10": Sweep(ss_r="full"),
    "pre_ss4": Sweep(ss=4, presweep=True),
}
RUNTABLE_VARIANTS = {"runtable": 12, "runtable8": 8, "runtable6": 6,
                     "runtable10": 10}
VARIANTS = tuple(SWEEP_VARIANTS) + tuple(RUNTABLE_VARIANTS)
MAX_RUNS = 16            # run-table slots: one warp per slot
BIGC = 1 << 20           # the run tables' "no run"
# csrc/ccl_sweeps.cu's table block: its shared memory's limit (the
# device's, less its static int)
RUNTABLE_SMEM_MAX = SMEM_BYTES - 16
# The cluster path: blocks a frame (the portable sizes, and 16 with the
# non-portable opt-in), columns a pass of the column phase, and the flags
# (the certificates' two sets of 16 ints, a pass's 32 column flags).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
PASS_COLS = (32, 16, 8)
FLAG_INTS = 2 * 16 + 32
PATHS = ("cluster", "global")


def band_bytes(H: int, W: int, C: int, P: int, mask: bool = False) -> int:
    """Shared memory of a block of the cluster path (csrc/sweep_cluster.cuh
    ::band_bytes) for H x W frames over C blocks: its ceil(H / C) rows of
    both label planes with a halo row above and below, the column phase's
    tile of H x (P + 1) ints, the flags, the frame's row map (an int16 a
    row: which block holds it), and with mask its rows of the mask and their
    halos (the joint fixpoint's exchange reads them)."""
    rows = -(-H // C)
    return (4 * (2 * (rows + 2) * W + H * (P + 1) + FLAG_INTS
                 + (H + 1) // 2) + (rows + 2) * W * bool(mask))


def band_layout(H: int, W: int, mask: bool = False):
    """(C, P) of the cluster path for H x W frames: the fewest blocks a
    frame whose band fits one block's shared memory, with the widest pass
    that fits; None where no cluster holds the planes (the global path)."""
    for C in CLUSTER_SIZES:
        for P in PASS_COLS:
            if band_bytes(H, W, C, P, mask) <= SMEM_BYTES:
                return C, P
    return None


def choose_path(H: int, W: int, mask: bool = False, path=None):
    """(path, (C, P) or None): the path a sweep kernel takes at H x W, by
    shape unless ``path`` names one; raises where the named path cannot
    take the shape."""
    layout = band_layout(H, W, mask)
    if path is None:
        path = "cluster" if layout else "global"
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS} or None, got {path!r}")
    if path == "cluster" and layout is None:
        raise ValueError(f"the cluster path cannot hold {H}x{W} frames: "
                         f"{band_bytes(H, W, 16, 8, mask)} bytes a block at "
                         f"16 blocks, more than {SMEM_BYTES}")
    return path, layout if path == "cluster" else None


def packed_big(sentinel: int) -> int:
    """The run ids' factor in the packed keys: a power of two above every
    value (pallas_kernels.py:358-362)."""
    return 1 << ladder_steps(sentinel + 2)


def nb8(lab: torch.Tensor, sentinel: int) -> torch.Tensor:
    """3x3 min (self included); neighbours outside the frame do not count."""
    row = torch.minimum(lab, torch.minimum(shift(lab, 1, -1, sentinel),
                                           shift(lab, -1, -1, sentinel)))
    return torch.minimum(row, torch.minimum(shift(row, 1, -2, sentinel),
                                            shift(row, -1, -2, sentinel)))


def runtable_bytes(rmax: int, H: int) -> int:
    """Shared memory of csrc/ccl_sweeps.cu's table block (runtable_smem): a
    slot of a row takes an int32 label and int16 first and last columns and
    chain id, a row a byte of run count (rounded up to 16 bytes), and each
    of the 16 warps stages 512 int32 labels."""
    return (rmax * H * (4 + 2 + 2 + 2) + H + 15) // 16 * 16 + 16 * 512 * 4


def sweep_phase_fits(W: int, lines: int) -> bool:
    """Whether common.cuh's sweep_phase fits one block's shared memory:
    a line buffer per warp (16 warps) or a tile of 33 x lines ints."""
    return 4 * max(16 * W, 33 * lines) <= SMEM_BYTES


def _check_mask_plane(H, W, rmax=None):
    Hg = H + 2 * GUARD_ROWS
    big = packed_big(H * W)
    if (W > MAX_LINE or Hg > MAX_LINE or not sweep_phase_fits(W, Hg)
            or (max(W, Hg) // 2 + 2) * big + H * W >= 1 << 30):
        raise ValueError(f"the CCL probes take masks of at most {MAX_LINE} "
                         f"columns and {MAX_LINE - 2 * GUARD_ROWS} rows, got "
                         f"{H}x{W}")
    if rmax is not None and not (
            1 <= rmax <= MAX_RUNS
            and runtable_bytes(rmax, H) <= RUNTABLE_SMEM_MAX
            and (H + 2) * big + H * W < 1 << 30):
        raise ValueError(f"rmax must be in [1, {MAX_RUNS}] with its tables "
                         f"({runtable_bytes(rmax, H)} bytes) in shared "
                         f"memory, got {rmax} at H={H}")


def _sweep_steps(cfg: Sweep, H: int, W: int):
    """(row steps, column steps, whole-row steps, whole-column steps) of a
    sweep variant, as hd_sweep_ccl takes them."""
    full_r = ladder_steps(W)
    full_c = ladder_steps(H + (2 * GUARD_ROWS if cfg.guard else 0))
    return (full_r if cfg.ss_r == "full" else min(cfg.ss, full_r),
            min(cfg.ss, full_c), full_r, full_c)


def _sweep_cfg(variant) -> Sweep:
    """The Sweep of a variant: a name of SWEEP_VARIANTS, or a Sweep."""
    return variant if isinstance(variant, Sweep) else SWEEP_VARIANTS[variant]


def sweep_ccl_reference(mask: torch.Tensor, variant="cur") -> torch.Tensor:
    """Plain version of the sweep CCL of ``variant`` (a name of
    SWEEP_VARIANTS, or a Sweep) on mask [B, H, W]: labels int32 [B, H, W].  The phases of every frame run together until
    the certificate holds on all of them (a unit more changes nothing on a
    frame that is done); "fixed2" runs its two units."""
    cfg = _sweep_cfg(variant)
    fg = mask != 0
    B, H, W = fg.shape
    S = H * W
    big = packed_big(S)
    lin = torch.arange(S, dtype=torch.int32, device=fg.device).view(H, W)
    lab = torch.where(fg, lin, S)
    rb = {-1: run_count(fg, -1) * big, -2: run_count(fg, -2) * big}
    sr, sc, full_r, full_c = _sweep_steps(cfg, H, W)

    def phase(lab, dim, steps):
        t = torch.where(fg, nb8(lab, S), S)
        return torch.where(fg, run_min(t, rb[dim], dim, steps), S)

    def unit(lab, sr, sc, phases):
        lab = phase(phase(lab, -1, sr), -2, sc)
        return phase(lab, -1, sr) if phases == 3 else lab

    if cfg.presweep:
        lab = unit(lab, full_r, full_c, 3)
    n = 0
    while True:
        new = unit(lab, sr, sc, cfg.unit)
        n += 1
        if cfg.fixed is not None:
            lab = new
            if n == cfg.fixed:
                return lab
            continue
        if cfg.cert == "cheap":
            more = bool((new < lab).any())
        else:
            more = bool((torch.where(fg, nb8(new, S), S) < new).any())
        lab = new
        if not more:
            return lab


def _runtable_labels(fg: torch.Tensor, runid: torch.Tensor,
                     rmax: int) -> torch.Tensor:
    """The run-table CCL of frames whose rows have at most rmax runs."""
    F, H, W = fg.shape
    S = H * W
    big = packed_big(S)
    i32 = torch.int32
    start = fg & ~shift(fg, 1, -1, False)
    end = fg & ~shift(fg, -1, -1, False)
    sx = torch.full((F, rmax, H), BIGC, dtype=i32, device=fg.device)
    ex = torch.full_like(sx, -BIGC)
    lab = torch.full_like(sx, S)
    f, y, x = start.nonzero(as_tuple=True)
    k = runid[f, y, x].long() - 1
    sx[f, k, y] = x.to(i32)
    lab[f, k, y] = (y * W + x).to(i32)
    f, y, x = end.nonzero(as_tuple=True)
    ex[f, runid[f, y, x].long() - 1, y] = x.to(i32)
    # chain ids: an entry starts a chain unless it 8-overlaps the same
    # slot's entry of the row above
    chained = ((sx - 1 <= shift(ex, 1, -1, -BIGC))
               & (ex + 1 >= shift(sx, 1, -1, BIGC)))
    pack = (~chained).cumsum(-1, dtype=i32) * big
    steps = ladder_steps(H)
    while True:
        acc = lab
        for k in range(rmax):
            for d in (1, -1):
                ov = ((sx - 1 <= shift(ex[:, k:k + 1], d, -1, -BIGC))
                      & (ex + 1 >= shift(sx[:, k:k + 1], d, -1, BIGC)))
                acc = torch.minimum(acc, torch.where(
                    ov, shift(lab[:, k:k + 1], d, -1, S), S))
        new = run_min(acc, pack, -1, steps)
        more = bool((new < lab).any())
        lab = new
        if not more:
            break
    slot = (runid.long() - 1).clamp(min=0)
    out = torch.gather(lab.transpose(1, 2), 2, slot)
    return torch.where(fg, out, S).to(i32)


def runtable_reference(mask: torch.Tensor, rmax: int = 12):
    """Plain version of the run-table CCL: (labels int32 [B, H, W], fits
    int32 [B]: 1 where every row has at most rmax runs and the tables gave
    the labels, 0 where "cur" did)."""
    fg = mask != 0
    runid = run_count(fg, -1)
    fits = runid[..., -1].amax(-1) <= rmax
    labels = torch.empty(fg.shape, dtype=torch.int32, device=fg.device)
    if bool((~fits).any()):
        labels[~fits] = sweep_ccl_reference(mask[~fits], "cur")
    if bool(fits.any()):
        labels[fits] = _runtable_labels(fg[fits], runid[fits], rmax)
    return labels, fits.to(torch.int32)


def ccl_mask_reference(mask: torch.Tensor, variant="cur"):
    """Plain version of ccl_mask."""
    if isinstance(variant, str) and variant in RUNTABLE_VARIANTS:
        return runtable_reference(mask, RUNTABLE_VARIANTS[variant])[0]
    return sweep_ccl_reference(mask, variant)


def runtable_variant(rmax: int) -> str:
    """The variant name of the run tables at rmax runs per row."""
    return "runtable" if rmax == 12 else f"runtable{rmax}"


def _check_variant(variant):
    if not isinstance(variant, Sweep) and variant not in VARIANTS:
        raise ValueError(f"variant must be a Sweep or one of {VARIANTS}, got "
                         f"{variant!r}")


def _count(variant):
    ccl_mask.launches += 1
    ccl_mask.variant_launches[variant] += 1


def _path_args(layout):
    """(cluster, pass_cols) of the C entry points: (0, 0) for the global
    path."""
    return layout if layout else (0, 0)


def _scratch(mask, path):
    """Run ids, the global path's planes (None on the cluster path) and the
    labels."""
    B, H, W = mask.shape
    n = (B, H + 2 * GUARD_ROWS, W)
    dev = mask.device
    planes = ((torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev))
              if path == "global" else (None, None))
    return (torch.empty(n, dtype=torch.int16, device=dev),
            torch.empty(n, dtype=torch.int16, device=dev), *planes,
            torch.empty((B, H, W), dtype=torch.int32, device=dev))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_sweep(mask, cfg, path, layout, done, out):
    from heimdall_tpu_torch.ops import _cuda

    B, H, W = mask.shape
    rb_r, rb_t, pa, pb, labels = _scratch(mask, path)
    if out is not None:
        labels = out
    ss_r = 0 if cfg.ss_r == "full" else cfg.ss
    err = _cuda.library("ccl_sweeps").hd_sweep_ccl(
        mask.data_ptr(), B, H, W, int(cfg.guard), ss_r, cfg.ss, cfg.unit,
        ("nb", "cheap", "fixed").index("fixed" if cfg.fixed else cfg.cert),
        cfg.fixed or 0, int(cfg.presweep), *_path_args(layout), _ptr(done),
        rb_r.data_ptr(), rb_t.data_ptr(), _ptr(pa), _ptr(pb),
        labels.data_ptr(), _launch.stream(mask))
    _launch.raise_on(err, "ccl_sweeps")
    return labels


def _launch_runtable(mask, rmax, path, layout):
    from heimdall_tpu_torch.ops import _cuda

    B, H, W = mask.shape
    rb_r, rb_t, pa, pb, labels = _scratch(mask, path)
    fits, ran = (torch.empty((n,), dtype=torch.int32, device=mask.device)
                 for n in (B, 1))
    err = _cuda.library("ccl_sweeps").hd_runtable_ccl(
        mask.data_ptr(), B, H, W, rmax, *_path_args(layout),
        rb_r.data_ptr(), rb_t.data_ptr(), _ptr(pa), _ptr(pb),
        fits.data_ptr(), labels.data_ptr(), ran.data_ptr(),
        _launch.stream(mask))
    _launch.raise_on(err, "runtable_ccl")
    ccl_runtable.runid_frames = ran
    return labels, fits


def ccl_mask(mask: torch.Tensor, variant="cur", path=None, done=None,
             out=None) -> torch.Tensor:
    """The 8-connected labels (int32 [B, H, W], background H*W) of mask u8
    [B, H, W] by ``variant`` (one of VARIANTS, or a Sweep), on the path
    ``path`` ("cluster", "global", or None: by shape, choose_path).  With
    ``done`` (int32 [B]; sweep variants only) the frames whose flag is
    nonzero are skipped and their planes of ``out`` (int32 [B, H, W], which
    the labels then go into) are left as they are.  ``ccl_mask.launches``
    counts kernel launches (of this function and of ccl_runtable),
    ``ccl_mask.variant_launches`` counts them by variant and
    ``ccl_mask.last_path`` names the last call's path."""
    _check_variant(variant)
    B, H, W = _launch.check_mask(mask)
    runtable = not isinstance(variant, Sweep) and variant in RUNTABLE_VARIANTS
    _check_mask_plane(H, W, RUNTABLE_VARIANTS[variant] if runtable else None)
    if runtable and (done is not None or out is not None):
        raise ValueError("done and out are for the sweep variants")
    if (done is None) != (out is None):
        raise ValueError("done and out go together")
    path, layout = choose_path(H, W, path=path)
    if mask.device.type == "cpu":
        ccl_mask.last_path = "plain"
        if done is None:
            return ccl_mask_reference(mask, variant)
        _launch.run_plain(lambda m: sweep_ccl_reference(m, variant),
                          done == 0, (mask,), (), (out,))
        return out
    _launch.check_cuda(mask, "mask", (torch.uint8,))
    if done is not None:
        _launch.check_cuda(done, "done", (torch.int32,), (B,))
        _launch.check_cuda(out, "out", (torch.int32,), (B, H, W))
    if runtable:
        labels = _launch_runtable(mask, RUNTABLE_VARIANTS[variant], path,
                                  layout)[0]
    else:
        labels = _launch_sweep(mask, _sweep_cfg(variant), path, layout, done,
                               out)
    _count(variant)
    ccl_mask.last_path = path
    return labels


ccl_mask.launches = 0
ccl_mask.variant_launches = collections.Counter()
ccl_mask.last_path = None


def ccl_runtable(mask: torch.Tensor, rmax: int = 12, path=None):
    """The run-table CCL of mask u8 [B, H, W] at rmax runs per row, with
    its per-frame choice: (labels int32 [B, H, W], fits int32 [B], 1 where
    the frame took the tables, 0 where it took "cur", on ``path`` as
    ccl_mask's).  Counted in ccl_mask's launches as runtable_variant(rmax);
    sets ccl_mask.last_path.  On the card each call (this one's, and
    ccl_mask's of a run-table variant) leaves in ``ccl_runtable.runid_frames``
    an int32 [1] tensor on the card: the frames that its run-id product
    numbered, those that did not fit (read it after the call; no sync)."""
    _, H, W = _launch.check_mask(mask)
    _check_mask_plane(H, W, rmax)
    path, layout = choose_path(H, W, path=path)
    if mask.device.type == "cpu":
        ccl_mask.last_path = "plain"
        return runtable_reference(mask, rmax)
    _launch.check_cuda(mask, "mask", (torch.uint8,))
    out = _launch_runtable(mask, rmax, path, layout)
    _count(runtable_variant(rmax))
    ccl_mask.last_path = path
    return out


ccl_runtable.runid_frames = None


def active_clusters(H: int, W: int, joint: bool = False) -> int:
    """How many clusters of the cluster path's kernel (the sweep CCL's, or
    with joint the joint fixpoint's) the current card runs at once for H x W
    frames (cudaOccupancyMaxActiveClusters).  Needs a card."""
    from heimdall_tpu_torch.ops import _cuda

    layout = band_layout(H, W, joint)
    if layout is None:
        raise ValueError(f"no cluster holds {H}x{W} frames")
    if joint:
        n = _cuda.library("joint_label").hd_joint_label_clusters(H, W,
                                                                 *layout)
    else:
        n = _cuda.library("ccl_sweeps").hd_sweep_ccl_clusters(H, W, *layout)
    _launch.raise_on(max(-n, 0), "active clusters")
    return n


def ccl_variant_reference(frames: torch.Tensor, contrast_threshold,
                          variant: str = "cur") -> torch.Tensor:
    """Plain version of ccl_variant."""
    return ccl_mask_reference(
        label_kernel_reference(frames, contrast_threshold, "fill"), variant)


def ccl_variant(frames: torch.Tensor, contrast_threshold,
                variant: str = "cur") -> torch.Tensor:
    """The probe as scripts/profile_ccl_variants.py runs it: frames [B, 3,
    H, W] uint8 -> the label kernel's "fill" stage -> ccl_mask(variant)."""
    _check_variant(variant)
    check_frames(frames)
    return ccl_mask(label_kernel(frames, contrast_threshold, "fill"),
                    variant)
