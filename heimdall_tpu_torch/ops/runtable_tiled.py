"""Run-table hole fill and connected components (counterpart of
heimdall_tpu/ops/runtable_tiled.py): the route of BGR frames over 400,000
px.

Per row, the runs of a binary plane become tables (the JAX package's
encoding, kept so that each kernel can be held against it on its own):

* ``runid`` uint8 [B, H, W]: the 1-based count of run starts at or before
  the column.  It wraps at 256, so it is read only where the row fits;
* ``S`` / ``E`` int32 [B, H, R]: the first and last column of the row's
  first R runs, +BIGC / -BIGC in the slots past the row's run count.  As
  in the JAX kernel, the last slot of a row with more than R runs ends at
  S + (the row's run pixels from its R-th run on) - 1: such a row is never
  read, since its frame takes the band route;
* ``nrun`` int32 [B, H, 1]: the row's exact run count.

Five wrappers carry the work, each launching its hand-written kernel of
``csrc/runtable_tiled.cu`` on CUDA tensors (and raising if it cannot) and
running its plain PyTorch version on CPU tensors:

* ``run_extract`` (TPU kernel B3a, and B2's table emission): the tables of
  a plane's nonzero (or, with invert, zero) pixels;
* ``flood_fix`` (B3b): per background run, 0 when it is 4-connected to a
  run on the first or last row or touching the first or last column, else
  1 (invalid slots 1);
* ``fill_extract`` (B3c): the filled plane (background whose run is flagged
  1 becomes foreground) and its foreground tables;
* ``label_fix`` (B3d): per foreground run the smallest row * W + S of its
  8-connected component (H*W in invalid slots), the first K roots, the root
  count and the per-band slot incidence (the format of ccl_tiled's
  ``merge_bands``);
* ``writeback`` (B3e): the label plane.

Each counts its launches in ``.launches`` and takes ``active`` as the
wrappers of ops/ccl_tiled.py do.  The two union-finds (``flood_fix``,
``label_fix``) spread each frame over a cluster of blocks with its tables in
shared memory, or, for frames whose tables do not fit, run one block per
frame over global scratch; ``.last_path`` keeps the last call's choice
("cluster", "scratch", or "plain" on the CPU).
``fill_label_runtable_tiled`` composes them with the density guards of
JAX's function, decided per frame on the device: a frame with a
background row of more than r_bg runs, or a filled foreground row of more
than r_fg runs, takes the band route of ops/ccl_tiled.py instead, into the
same outputs.
"""

import ctypes

import torch

from heimdall_tpu_torch.ops.ccl import connected_components, fill_holes
from heimdall_tpu_torch.ops._launch import (active_ptr, alloc, check_cuda,
                                            check_mask, raise_on, run_plain,
                                            stream)
from heimdall_tpu_torch.ops.ccl_tiled import (MAX_SLOTS, band_ccl, first_roots,
                                              flood_fill, merge_bands,
                                              pad_rows, slot_incidence,
                                              unpad_rows)

BIGC = 1 << 20      # |S|, |E| of a slot past the row's runs


def _library():
    from heimdall_tpu_torch.ops import _cuda
    return _cuda.library("runtable_tiled")


def _check_tables(S, E, R: int, shape):
    for name, t in (("S", S), ("E", E)):
        check_cuda(t, name, (torch.int32,), tuple(shape) + (R,))


def _fix_path(in_cluster: ctypes.c_int) -> str:
    return "cluster" if in_cluster.value else "scratch"


# ---------------------------------------------------------- run extraction

def run_extract_reference(plane: torch.Tensor, R: int, invert: bool = False):
    """Plain PyTorch version of hd_run_extract: (runid uint8 [B, H, W],
    S int32 [B, H, R], E int32 [B, H, R], nrun int32 [B, H, 1]) of the runs
    of (plane != 0) != invert along each row."""
    sel = (plane != 0) != invert
    prev = torch.zeros_like(sel)
    prev[..., 1:] = sel[..., :-1]
    starts = sel & ~prev
    runid = torch.cumsum(starts.to(torch.int32), dim=-1, dtype=torch.int32)
    nrun = runid[..., -1:]
    S, E = [], []
    for j in range(1, R + 1):
        s = (runid < j).sum(-1, dtype=torch.int32)
        run = runid == j if j < R else runid >= R
        length = (sel & run).sum(-1, dtype=torch.int32)
        valid = nrun[..., 0] >= j
        S.append(torch.where(valid, s, BIGC))
        E.append(torch.where(valid, s + length - 1, -BIGC))
    return ((runid & 255).to(torch.uint8), torch.stack(S, -1).to(torch.int32),
            torch.stack(E, -1).to(torch.int32), nrun)


def run_extract(plane: torch.Tensor, R: int, invert: bool = False,
                active=None):
    """Run tables of a bool or uint8 plane [B, H, W] (see
    run_extract_reference); R <= BIGC."""
    B, H, W = check_mask(plane)
    if not 1 <= R or W >= BIGC:
        raise ValueError(f"unsupported R={R} W={W}")
    u8, i32 = torch.uint8, torch.int32
    outs = alloc(plane.device, ((B, H, W), u8), ((B, H, R), i32),
                 ((B, H, R), i32), ((B, H, 1), i32))
    if plane.device.type == "cpu":
        run_plain(run_extract_reference, active, (plane,), (R, invert), outs)
        return outs
    check_cuda(plane, "plane", (torch.bool, torch.uint8))
    flags, act = active_ptr(active, B)
    runid, S, E, nrun = outs
    raise_on(_library().hd_run_extract(
        plane.data_ptr(), int(invert), B, H, W, R, act, runid.data_ptr(),
        S.data_ptr(), E.data_ptr(), nrun.data_ptr(), stream(plane)),
        "run_extract")
    run_extract.launches += 1
    return outs


run_extract.launches = 0


def _paint(S: torch.Tensor, E: torch.Tensor, W: int) -> torch.Tensor:
    """bool [B, H, W]: True on the valid runs of the tables."""
    B, H, R = S.shape
    valid = S < BIGC
    step = torch.zeros((B, H, W + 1), dtype=torch.int32, device=S.device)
    one = valid.to(torch.int32)
    step.scatter_add_(2, torch.where(valid, S, W).long(), one)
    step.scatter_add_(2, torch.where(valid, E + 1, W).long(), -one)
    return torch.cumsum(step, dim=-1)[..., :W] > 0


def _at_start(plane: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """plane[b, y, S[b, y, k]] for every slot (invalid slots read column 0)."""
    idx = torch.where(S < BIGC, S, 0).long()
    return plane.gather(2, idx)


# ---------------------------------------------------------- border flood

def flood_fix_reference(S: torch.Tensor, E: torch.Tensor, W: int):
    """Plain PyTorch version of hd_flood_fix: the runs of the tables painted
    as the background of a plane, whose hole fill (ops/ccl.py) says which
    runs the border reaches.  F int32 [B, H, R]."""
    filled = fill_holes(~_paint(S, E, W))
    return torch.where(S < BIGC, _at_start(filled, S).to(torch.int32), 1)


def flood_fix(S: torch.Tensor, E: torch.Tensor, W: int, active=None):
    """Border-reach flags of background run tables S / E int32 [B, H, R]
    (see flood_fix_reference)."""
    B, H, R = S.shape
    F, = alloc(S.device, ((B, H, R), torch.int32))
    if S.device.type == "cpu":
        run_plain(flood_fix_reference, active, (S, E), (W,), (F,))
        flood_fix.last_path = "plain"
        return F
    _check_tables(S, E, R, (B, H))
    flags, act = active_ptr(active, B)
    scratch, marks = alloc(S.device, ((B, H, R), torch.int32),
                           ((B, H, R), torch.uint8))
    in_cluster = ctypes.c_int(0)
    raise_on(_library().hd_flood_fix(
        B, H, W, R, act, S.data_ptr(), E.data_ptr(), scratch.data_ptr(),
        marks.data_ptr(), F.data_ptr(), ctypes.addressof(in_cluster),
        stream(S)), "flood_fix")
    flood_fix.launches += 1
    flood_fix.last_path = _fix_path(in_cluster)
    return F


flood_fix.launches = 0
flood_fix.last_path = None


# ------------------------------------------------- fill + fg extraction

def _lookup(table: torch.Tensor, runid: torch.Tensor) -> torch.Tensor:
    """table[b, y, runid - 1], the index clamped to the table's slots."""
    idx = (runid.long() - 1).clamp(0, table.shape[-1] - 1)
    return table.gather(2, idx)


def fill_extract_reference(binary: torch.Tensor, runid_bg: torch.Tensor,
                           F: torch.Tensor, r_fg: int):
    """Plain PyTorch version of hd_fill_extract: (filled uint8 [B, H, W]
    0/1, runid_fg, S_fg, E_fg, nrun_fg) — the tables of filled."""
    filled = ((binary != 0) | (_lookup(F, runid_bg) != 0)).to(torch.uint8)
    return (filled,) + run_extract_reference(filled, r_fg)


def fill_extract(binary: torch.Tensor, runid_bg: torch.Tensor,
                 F: torch.Tensor, r_fg: int, active=None):
    """The filled plane and its foreground run tables (see
    fill_extract_reference)."""
    B, H, W = check_mask(binary)
    r_bg = F.shape[-1]
    u8, i32 = torch.uint8, torch.int32
    outs = alloc(binary.device, ((B, H, W), u8), ((B, H, W), u8),
                 ((B, H, r_fg), i32), ((B, H, r_fg), i32), ((B, H, 1), i32))
    if binary.device.type == "cpu":
        run_plain(fill_extract_reference, active, (binary, runid_bg, F),
                  (r_fg,), outs)
        return outs
    check_cuda(binary, "binary", (torch.bool, torch.uint8))
    check_cuda(runid_bg, "runid_bg", (u8,), (B, H, W))
    check_cuda(F, "F", (i32,), (B, H, r_bg))
    flags, act = active_ptr(active, B)
    filled, runid, S, E, nrun = outs
    raise_on(_library().hd_fill_extract(
        B, H, W, r_bg, r_fg, act, binary.data_ptr(), runid_bg.data_ptr(),
        F.data_ptr(), filled.data_ptr(), runid.data_ptr(), S.data_ptr(),
        E.data_ptr(), nrun.data_ptr(), stream(binary)), "fill_extract")
    fill_extract.launches += 1
    return outs


fill_extract.launches = 0


# ------------------------------------------------------------ run labels

def label_fix_reference(S: torch.Tensor, E: torch.Tensor, W: int, band: int,
                        max_blobs: int):
    """Plain PyTorch version of hd_label_fix: the runs of the tables painted
    as the foreground of a plane, labeled by ops/ccl.py (8-connected; a
    component's label is its smallest linear index, which is the start of
    a run).  Returns (L int32 [B, H, R], root table int32 [B, K], n_blobs
    int32 [B], slot_list int32 [B, Rb, K], slot_count int32 [B, Rb])."""
    B, H, R = S.shape
    HW = H * W
    valid = S < BIGC
    L = torch.where(valid, _at_start(connected_components(_paint(S, E, W), 8),
                                     S), HW)
    lin = torch.arange(H, device=S.device).view(1, H, 1) * W + S
    is_root = valid & (L == lin)
    rl = first_roots(torch.where(is_root, lin, HW).reshape(B, H * R).long(),
                     max_blobs, HW).to(torch.int32)
    n = is_root.sum((1, 2), dtype=torch.int32)
    return (L.to(torch.int32), rl, n) + slot_incidence(L, rl, n, band)


def label_fix(S: torch.Tensor, E: torch.Tensor, W: int, band: int,
              max_blobs: int, active=None):
    """Run labels, root table, root count and per-band slot incidence of
    foreground run tables S / E int32 [B, H, R] (see label_fix_reference)."""
    B, H, R = S.shape
    K = max_blobs
    Rb = -(-H // band)
    if band < 1 or not 1 <= K <= MAX_SLOTS:
        raise ValueError(f"unsupported band={band} max_blobs={K} "
                         f"(1..{MAX_SLOTS})")
    i32 = torch.int32
    outs = alloc(S.device, ((B, H, R), i32), ((B, K), i32), ((B,), i32),
                 ((B, Rb, K), i32), ((B, Rb), i32))
    if S.device.type == "cpu":
        run_plain(label_fix_reference, active, (S, E), (W, band, K), outs)
        label_fix.last_path = "plain"
        return outs
    _check_tables(S, E, R, (B, H))
    flags, act = active_ptr(active, B)
    L, rl, n, slot_list, slot_count = outs
    scratch, = alloc(S.device, ((B, H, R), i32))
    in_cluster = ctypes.c_int(0)
    raise_on(_library().hd_label_fix(
        B, H, W, R, band, K, act, S.data_ptr(), E.data_ptr(),
        scratch.data_ptr(), L.data_ptr(), rl.data_ptr(), n.data_ptr(),
        slot_list.data_ptr(), slot_count.data_ptr(),
        ctypes.addressof(in_cluster), stream(S)), "label_fix")
    label_fix.launches += 1
    label_fix.last_path = _fix_path(in_cluster)
    return outs


label_fix.launches = 0
label_fix.last_path = None


# -------------------------------------------------------------- writeback

def writeback_reference(filled: torch.Tensor, runid: torch.Tensor,
                        L: torch.Tensor):
    """Plain PyTorch version of hd_writeback: labels int32 [B, H, W], the
    run's label on foreground, H*W on background."""
    B, H, W = filled.shape
    return torch.where(filled != 0, _lookup(L, runid), H * W).to(torch.int32)


def writeback(filled: torch.Tensor, runid: torch.Tensor, L: torch.Tensor,
              active=None):
    """The label plane of the run labels L [B, H, R] (see
    writeback_reference)."""
    B, H, W = check_mask(filled)
    R = L.shape[-1]
    labels, = alloc(filled.device, ((B, H, W), torch.int32))
    if filled.device.type == "cpu":
        run_plain(writeback_reference, active, (filled, runid, L), (),
                  (labels,))
        return labels
    check_cuda(filled, "filled", (torch.bool, torch.uint8))
    check_cuda(runid, "runid", (torch.uint8,), (B, H, W))
    check_cuda(L, "L", (torch.int32,), (B, H, R))
    flags, act = active_ptr(active, B)
    raise_on(_library().hd_writeback(
        B, H, W, R, act, filled.data_ptr(), runid.data_ptr(), L.data_ptr(),
        labels.data_ptr(), stream(filled)), "writeback")
    writeback.launches += 1
    return labels


writeback.launches = 0


# -------------------------------------------------------------- the route

def _rows(t: torch.Tensor, H: int) -> torch.Tensor:
    """The first H rows of a table or plane given padded."""
    return t if t.shape[1] == H else t[:, :H].contiguous()


def fill_label_runtable_tiled(binary: torch.Tensor, band: int, frame_h=None,
                              max_blobs: int = 64, r_bg: int = 12,
                              r_fg: int = 10, pre_extracted=None):
    """Hole fill and 8-connected labels of a binary batch through the run
    tables (counterpart of the JAX function; the same outputs as
    fill_holes_tiled + connected_components_tiled(return_roots=max_blobs,
    band_slots=True)).

    binary: bool or uint8 [B, H, W] (nonzero = foreground); with frame_h,
    [B, Hp, W] padded to whole bands of ``band`` rows (pad rows background),
    and the planes come back padded the same way.  pre_extracted: the
    background tables (runid, S, E, nrun) of binary, as
    run_extract(binary, r_bg, invert=True) or the B2 preprocess give them.

    A frame with a background row of more than r_bg runs, or a filled
    foreground row of more than r_fg runs, takes the band route instead;
    ``fill_label_runtable_tiled.last_route`` keeps the last call's choice
    (bool [B] on the device: True = run tables).

    Returns (filled bool [B, H, W], labels int32 [B, H, W], root_table
    int32 [B, K], n_blobs int32 [B], slot_list int32 [B, Rb, K],
    slot_count int32 [B, Rb])."""
    real = unpad_rows(binary, band, frame_h)
    B, H, W = check_mask(real)
    K = max_blobs
    if pre_extracted is None:
        pre_extracted = run_extract(real, r_bg, invert=True)
    runid_bg, S_bg, E_bg, nrun_bg = (_rows(t, H) for t in pre_extracted)
    fits_bg = nrun_bg.amax(dim=(1, 2)) <= r_bg
    F = flood_fix(S_bg, E_bg, W, active=fits_bg)
    filled, runid_fg, S_fg, E_fg, nrun_fg = fill_extract(
        real, runid_bg, F, r_fg, active=fits_bg)
    flood_fill(real, active=~fits_bg, out=filled.view(torch.bool))
    fits = fits_bg & (nrun_fg.amax(dim=(1, 2)) <= r_fg)
    L, rl, n, slot_list, slot_count = label_fix(S_fg, E_fg, W, band, K,
                                                active=fits)
    labels = writeback(filled, runid_fg, L, active=fits)
    lab, roots, counts = band_ccl(filled, band, 8, max(K, 128),
                                  active=~fits, out=labels)
    merge_bands(labels, roots, counts, band, 8, K, active=~fits,
                out=(rl, n, slot_list, slot_count))
    fill_label_runtable_tiled.last_route = fits
    Hp = binary.shape[1]
    return (pad_rows(filled.view(torch.bool), Hp, False),
            pad_rows(labels, Hp, H * W), rl, n, slot_list, slot_count)


fill_label_runtable_tiled.last_route = None
