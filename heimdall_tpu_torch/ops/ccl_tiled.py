"""Band-tiled hole fill and connected components for frames of any size
(counterpart of heimdall_tpu/ops/ccl_tiled.py).

The contract is the JAX package's, not its TPU structure:

* ``fill_holes_tiled``: background 4-connected to the frame border stays
  background; every other pixel is foreground (equal to ops/ccl.py's
  ``fill_holes``).
* ``connected_components_tiled``: every foreground pixel holds the linear
  index of its component's minimal pixel, background H*W (equal to
  ``connected_components``); with ``return_roots=K`` also the first K roots
  in raster order (padded with H*W) and the root count, and with
  ``band_slots`` the per-band slot incidence (slot_list [B, R, K]: the slots
  with a pixel in band r ascending, then the others ascending; slot_count
  [B, R]), R = ceil(H / band).

Three wrappers carry the work, each launching the hand-written kernels of
``csrc/ccl_tiled.cu`` on a CUDA tensor (and raising if it cannot) and
running its plain PyTorch version on a CPU tensor:

* ``flood_fill`` (TPU kernel B5b and its round loop): the filled mask, by
  a block union-find — tiles labelled in shared memory, their perimeter
  components merged in a small per-frame table (no plane of scratch), no
  rounds, no host sync;
* ``band_ccl`` (B5a): labels within bands of ``band`` rows, with global
  indices, and each band's first ``roots_cap`` roots and root count;
* ``merge_bands`` (the XLA merge between the TPU kernels): joins the bands
  (in place on the card), then the root table, the root count and the slot
  incidence.

On a shard of a frame's rows (one rank's rows on a multi-device mesh,
parallel/tiled_sp.py), two more wrappers take the frame's geometry:

* ``flood_fill_sp`` (B5b-sp): one round of the fill, with the frame's
  border and the neighbouring shards' reached edge rows as halos, in one
  launch on a thread-block cluster a frame-shard (bit-parallel passes over
  the shard held in shared memory) where it fits, else by flood_fill's
  tile union-find;
* ``band_ccl_sp`` (B5a on a shard): the band labels and root tables in the
  frame's linear indices, and each band's first and last label rows.

Each counts its kernel launches in ``.launches``.  Planes are [B, H, W]
and unpadded: the last band may be shorter than ``band``.  Each also takes
``active`` (int32 or bool [B] on the planes' device), to compute only the
frames it marks and leave the others' outputs as they were, and ``out``,
buffers to write into: the run-table route (ops/runtable_tiled.py) sends
the frames that overflow its tables here, into its own outputs, with no
host sync.
"""

import torch

from heimdall_tpu_torch.ops._launch import (active_ptr, alloc, check_cuda,
                                            check_mask, raise_on, run_plain,
                                            stream)
from heimdall_tpu_torch.ops.ccl import (_global_labels, connected_components,
                                        fill_holes)

# Static shared-memory tables of hd_merge_bands hold at most this many slots.
MAX_SLOTS = 1024


# ---------------------------------------------------------------- hole fill

def flood_reference(mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of hd_flood_fill: the filled bool mask."""
    return fill_holes(mask.to(torch.bool))


def flood_fill(mask: torch.Tensor, active=None, out=None) -> torch.Tensor:
    """Filled mask (bool [B, H, W]) of a bool or uint8 (nonzero = fg) mask;
    ``out``: a bool [B, H, W] buffer to write it into."""
    B, H, W = check_mask(mask)
    filled = alloc(mask.device, ((B, H, W), torch.bool))[0] if out is None \
        else out
    if mask.device.type == "cpu":
        run_plain(flood_reference, active, (mask,), (), (filled,))
        return filled
    from heimdall_tpu_torch.ops import _cuda

    check_cuda(mask, "mask", (torch.bool, torch.uint8))
    check_cuda(filled, "out", (torch.bool,), (B, H, W))
    flags, act = active_ptr(active, B)
    lib = _cuda.library("ccl_tiled")
    table, = alloc(mask.device, ((B, lib.hd_flood_entries(H, W)),
                                 torch.int32))
    raise_on(lib.hd_flood_fill(mask.data_ptr(), B, H, W, act,
                               table.data_ptr(), filled.data_ptr(),
                               stream(mask)), "flood_fill")
    flood_fill.launches += 1
    return filled


flood_fill.launches = 0


def flood_sp_reference(mask: torch.Tensor, row_off: int, H: int,
                       halo_top=None, halo_bot=None) -> torch.Tensor:
    """Plain PyTorch version of hd_flood_fill_sp: the filled bool mask of
    a shard [B, Hl, W] holding rows row_off .. row_off + Hl - 1 of frames of
    H rows.  Background reaches the border through the frame's edge, or
    through a cut row's pixel whose halo pixel (u8 [B, W], nonzero =
    reached; None at the frame's edge) is reached."""
    m = mask.to(torch.bool)
    B, Hl, W = m.shape
    bg = ~m
    seed = torch.zeros_like(bg)
    seed[:, :, 0] = seed[:, :, -1] = True
    if row_off == 0:
        seed[:, 0] = True
    if row_off + Hl == H:
        seed[:, -1] = True
    if halo_top is not None:
        seed[:, 0] |= halo_top.to(torch.bool)
    if halo_bot is not None:
        seed[:, -1] |= halo_bot.to(torch.bool)
    lab = _global_labels(bg, 4)
    reached = torch.zeros(B * Hl * W + 1, dtype=torch.bool, device=m.device)
    reached[lab[bg & seed]] = True
    return ~(bg & reached[lab])


def flood_fill_sp(mask: torch.Tensor, row_off: int, H: int, halo_top=None,
                  halo_bot=None) -> torch.Tensor:
    """One round of the hole fill on a shard (see flood_sp_reference):
    filled bool [B, Hl, W].  halo_top / halo_bot: u8 [B, W] rows of the
    shards above and below (reached = nonzero), None where the shard's row
    is the frame's first or last.

    On the card a call is one launch on a thread-block cluster a
    frame-shard (the shard as bits in shared memory, flooded by
    bit-parallel row and column passes) where the shard fits one
    (``flood_fill_sp.last_path`` "cluster": W <= 4096 and the rows fit 16
    blocks' shared memory), else the tile union-find of flood_fill
    ("tiles", 3 launches); "plain" on the CPU."""
    B, Hl, W = check_mask(mask)
    if not (0 <= row_off and row_off + Hl <= H and H * W < 2**31 - 1):
        raise ValueError(f"rows {row_off}..{row_off + Hl} of a frame of "
                         f"{H}x{W}")
    if mask.device.type == "cpu":
        flood_fill_sp.last_path = "plain"
        return flood_sp_reference(mask, row_off, H, halo_top, halo_bot)
    from heimdall_tpu_torch.ops import _cuda

    check_cuda(mask, "mask", (torch.bool, torch.uint8))
    for h in (halo_top, halo_bot):
        if h is not None:
            check_cuda(h, "halo", (torch.uint8,), (B, W))
    lib = _cuda.library("ccl_tiled")
    cluster = lib.hd_flood_fill_sp_cluster(Hl, W)
    raise_on(max(-cluster, 0), "flood_fill_sp")
    filled, table = alloc(mask.device, ((B, Hl, W), torch.bool),
                          ((B, 0 if cluster else lib.hd_flood_entries(Hl, W)),
                           torch.int32))
    raise_on(lib.hd_flood_fill_sp(
        mask.data_ptr(), B, Hl, W, row_off, H,
        None if halo_top is None else halo_top.data_ptr(),
        None if halo_bot is None else halo_bot.data_ptr(), None,
        table.data_ptr(), filled.data_ptr(), stream(mask)), "flood_fill_sp")
    flood_fill_sp.launches += 1
    flood_fill_sp.last_path = "cluster" if cluster else "tiles"
    return filled


flood_fill_sp.launches = 0
flood_fill_sp.last_path = None


# ------------------------------------------------------- band-local labels

def first_roots(keys: torch.Tensor, cap: int, sentinel: int) -> torch.Tensor:
    """The `cap` smallest keys of each row, ascending, padded with
    sentinel ([..., N] -> [..., cap])."""
    n = min(cap, keys.shape[-1])
    first = torch.topk(keys, n, dim=-1, largest=False, sorted=True).values
    pad = keys.new_full(keys.shape[:-1] + (cap - n,), sentinel)
    return torch.cat([first, pad], dim=-1)


def band_ccl_reference(mask: torch.Tensor, band: int, connectivity: int = 8,
                       roots_cap: int = 128):
    """Plain PyTorch version of hd_band_ccl.

    Returns (labels int32 [B, H, W]: the band-local component minimum as a
    global linear index, background H*W; band roots int32 [B, R, cap];
    counts int32 [B, R])."""
    B, H, W = check_mask(mask)
    R = -(-H // band)
    HW = H * W
    m = torch.zeros((B, R * band, W), dtype=torch.bool, device=mask.device)
    m[:, :H] = mask.to(torch.bool)
    local = connected_components(m.reshape(B * R, band, W), connectivity)
    local = local.reshape(B, R, band * W).to(torch.int64)
    base = torch.arange(R, device=mask.device).view(1, R, 1) * band * W
    lab = torch.where(local < band * W, local + base, HW)
    lab = lab.reshape(B, R * band, W)[:, :H]
    lin = torch.arange(R * band * W, device=mask.device).view(1, R, band * W)
    keys = torch.full((B, R * band * W), -1, dtype=torch.int64,
                      device=mask.device)          # pad rows hold no root
    keys[:, :HW] = lab.reshape(B, HW)
    keys = keys.view(B, R, band * W)
    is_root = keys == lin
    roots = first_roots(torch.where(is_root, lin, HW), roots_cap, HW)
    return (lab.to(torch.int32), roots.to(torch.int32),
            is_root.sum(-1).to(torch.int32))


def band_ccl(mask: torch.Tensor, band: int, connectivity: int = 8,
             roots_cap: int = 128, active=None, out=None):
    """Band-local labels, band root tables and counts of a bool or uint8
    mask [B, H, W] (see band_ccl_reference); ``out``: an int32 [B, H, W]
    buffer for the labels."""
    B, H, W = check_mask(mask)
    if connectivity not in (4, 8) or band < 1 or roots_cap < 1:
        raise ValueError(f"unsupported connectivity={connectivity} "
                         f"band={band} roots_cap={roots_cap}")
    R = -(-H // band)
    labels = alloc(mask.device, ((B, H, W), torch.int32))[0] \
        if out is None else out
    roots, counts = alloc(mask.device, ((B, R, roots_cap), torch.int32),
                          ((B, R), torch.int32))
    if mask.device.type == "cpu":
        run_plain(band_ccl_reference, active, (mask,),
                  (band, connectivity, roots_cap), (labels, roots, counts))
        return labels, roots, counts
    from heimdall_tpu_torch.ops import _cuda

    check_cuda(mask, "mask", (torch.bool, torch.uint8))
    check_cuda(labels, "out", (torch.int32,), (B, H, W))
    if R > 65535:
        raise ValueError(f"{R} bands exceed the kernel's grid")
    flags, act = active_ptr(active, B)
    raise_on(_cuda.library("ccl_tiled").hd_band_ccl(
        mask.data_ptr(), B, H, W, band, connectivity, roots_cap, act,
        labels.data_ptr(), roots.data_ptr(), counts.data_ptr(),
        stream(mask)), "band_ccl")
    band_ccl.launches += 1
    return labels, roots, counts


band_ccl.launches = 0


def edge_rows(labels: torch.Tensor, band: int) -> torch.Tensor:
    """The first and last label rows of each band, int32 [B, R, 2, W]
    (the TPU kernel's edge rows), of labels [B, R * band, W]."""
    B, H, W = labels.shape
    v = labels.view(B, H // band, band, W)
    return torch.stack([v[:, :, 0], v[:, :, band - 1]], dim=2)


def band_ccl_sp_reference(mask: torch.Tensor, band: int, base: int,
                          sentinel: int, connectivity: int = 8,
                          roots_cap: int = 128):
    """Plain PyTorch version of hd_band_ccl_sp: band_ccl_reference with
    every label and root moved by base and the background sentinel.
    Returns (labels, roots, counts) as band_ccl_reference."""
    B, Hl, W = check_mask(mask)
    lab, roots, counts = band_ccl_reference(mask, band, connectivity,
                                            roots_cap)

    def glob(t):
        return torch.where(t < Hl * W, t + base, sentinel).to(torch.int32)

    return glob(lab), glob(roots), counts


def band_ccl_sp(mask: torch.Tensor, band: int, base: int, sentinel: int,
                connectivity: int = 8, roots_cap: int = 128):
    """Band labels of a shard [B, Hl, W] (Hl a multiple of band) in the
    frame's linear indices: (labels int32 [B, Hl, W], band roots int32
    [B, R, cap], counts int32 [B, R], edge rows int32 [B, R, 2, W]) with
    each label base + its shard index, background and padding sentinel."""
    B, Hl, W = check_mask(mask)
    if Hl % band or connectivity not in (4, 8) or roots_cap < 1:
        raise ValueError(f"unsupported band={band} for {Hl} rows, "
                         f"connectivity={connectivity}, "
                         f"roots_cap={roots_cap}")
    if not (0 <= base and base + Hl * W <= sentinel < 2**31 - 1):
        raise ValueError(f"base {base} and sentinel {sentinel} do not hold "
                         f"a shard of {Hl}x{W}")
    if mask.device.type == "cpu":
        lab, roots, counts = band_ccl_sp_reference(
            mask, band, base, sentinel, connectivity, roots_cap)
        return lab, roots, counts, edge_rows(lab, band)
    from heimdall_tpu_torch.ops import _cuda

    check_cuda(mask, "mask", (torch.bool, torch.uint8))
    R = Hl // band
    if R > 65535:
        raise ValueError(f"{R} bands exceed the kernel's grid")
    labels, roots, counts = alloc(mask.device, ((B, Hl, W), torch.int32),
                                  ((B, R, roots_cap), torch.int32),
                                  ((B, R), torch.int32))
    raise_on(_cuda.library("ccl_tiled").hd_band_ccl_sp(
        mask.data_ptr(), B, Hl, W, band, connectivity, roots_cap, base,
        sentinel, None, labels.data_ptr(), roots.data_ptr(),
        counts.data_ptr(), stream(mask)), "band_ccl_sp")
    band_ccl_sp.launches += 1
    return labels, roots, counts, edge_rows(labels, band)


band_ccl_sp.launches = 0


# ------------------------------------------------------------------- merge

def _root_table(labels: torch.Tensor, max_blobs: int):
    """(first K roots in raster order, padded with H*W, int32 [B, K];
    root count int32 [B]) of a label plane [B, H, W]."""
    B, H, W = labels.shape
    HW = H * W
    lab = labels.reshape(B, HW).to(torch.int64)
    lin = torch.arange(HW, device=labels.device)
    is_root = lab == lin
    rl = first_roots(torch.where(is_root, lin, HW), max_blobs, HW)
    return rl.to(torch.int32), is_root.sum(-1).to(torch.int32)


def label_slots(labels: torch.Tensor, rl: torch.Tensor,
                n_blobs: torch.Tensor) -> torch.Tensor:
    """Slot of each pixel's label in the root table rl [B, K] (ascending,
    min(n_blobs, K) real roots), K where it has none; [B, H*W] int64."""
    B, H, W = labels.shape
    K = rl.shape[-1]
    lab = labels.reshape(B, H * W).to(torch.int64)
    rl64 = rl.to(torch.int64).contiguous()
    idx = torch.searchsorted(rl64, lab).clamp(max=K - 1)
    n_use = n_blobs.to(torch.int64).clamp(max=K)[:, None]
    hit = (idx < n_use) & (rl64.gather(1, idx) == lab)
    return torch.where(hit, idx, K)


def slot_incidence(labels: torch.Tensor, rl: torch.Tensor,
                   n_blobs: torch.Tensor, band: int):
    """(slot_list int32 [B, R, K], slot_count int32 [B, R]): per band, the
    slots of the root table rl [B, K] with a pixel there, ascending, then
    the others ascending."""
    B, H, W = labels.shape
    K = rl.shape[-1]
    R = -(-H // band)
    slot = label_slots(labels, rl, n_blobs)
    r = (torch.arange(H * W, device=labels.device) // (band * W))
    flat = (torch.arange(B, device=labels.device)[:, None] * R + r) * K + slot
    present = torch.zeros(B * R * K, dtype=torch.bool, device=labels.device)
    present[flat[slot < K]] = True
    present = present.view(B, R, K)
    order = torch.argsort((~present).to(torch.uint8), dim=-1, stable=True)
    return order.to(torch.int32), present.sum(-1).to(torch.int32)


def merge_reference(labels: torch.Tensor, band_roots: torch.Tensor,
                    counts: torch.Tensor, band: int, connectivity: int = 8,
                    max_blobs: int = 64):
    """Plain PyTorch version of hd_merge_bands: relabels the foreground of
    the band-local labels as whole frames.

    Returns (labels int32 [B, H, W], root table int32 [B, K], n_blobs int32
    [B], slot_list int32 [B, R, K], slot_count int32 [B, R])."""
    del band_roots, counts       # the plain version needs only the plane
    B, H, W = labels.shape
    lab = connected_components(labels != H * W, connectivity)
    rl, n = _root_table(lab, max_blobs)
    return (lab, rl, n) + slot_incidence(lab, rl, n, band)


def merge_bands(labels: torch.Tensor, band_roots: torch.Tensor,
                counts: torch.Tensor, band: int, connectivity: int = 8,
                max_blobs: int = 64, active=None, out=None):
    """Join band_ccl's outputs across bands (see merge_reference).
    ``labels`` is updated in place and returned; ``out``: buffers for
    (root table, n_blobs, slot_list, slot_count)."""
    B, H, W = check_mask(labels)
    R = -(-H // band)
    K = max_blobs
    if connectivity not in (4, 8) or band < 1 or not 1 <= K <= MAX_SLOTS:
        raise ValueError(f"unsupported connectivity={connectivity} "
                         f"band={band} max_blobs={K} (1..{MAX_SLOTS})")
    rl, n, slot_list, slot_count = out if out is not None else alloc(
        labels.device, ((B, K), torch.int32), ((B,), torch.int32),
        ((B, R, K), torch.int32), ((B, R), torch.int32))
    if labels.device.type == "cpu":
        run_plain(merge_reference, active, (labels, band_roots, counts),
                  (band, connectivity, K),
                  (labels, rl, n, slot_list, slot_count))
        return labels, rl, n, slot_list, slot_count
    from heimdall_tpu_torch.ops import _cuda

    cap = band_roots.shape[-1]
    check_cuda(labels, "labels", (torch.int32,))
    check_cuda(band_roots, "band_roots", (torch.int32,), (B, R, cap))
    check_cuda(counts, "counts", (torch.int32,), (B, R))
    for name, t, shape in (("root table", rl, (B, K)), ("n_blobs", n, (B,)),
                           ("slot_list", slot_list, (B, R, K)),
                           ("slot_count", slot_count, (B, R))):
        check_cuda(t, name, (torch.int32,), shape)
    flags, act = active_ptr(active, B)
    raise_on(_cuda.library("ccl_tiled").hd_merge_bands(
        B, H, W, band, connectivity, cap, K, act, labels.data_ptr(),
        band_roots.data_ptr(), counts.data_ptr(), rl.data_ptr(),
        n.data_ptr(), slot_list.data_ptr(), slot_count.data_ptr(),
        stream(labels)), "merge_bands")
    merge_bands.launches += 1
    return labels, rl, n, slot_list, slot_count


merge_bands.launches = 0


# -------------------------------------------------------------- public API

def unpad_rows(mask: torch.Tensor, band: int, frame_h):
    """The real rows of a mask given in the padded layout of frame_h."""
    if frame_h is None:
        return mask
    if mask.shape[1] != -(-frame_h // band) * band:
        raise ValueError(f"a padded mask of {frame_h} rows has "
                         f"{-(-frame_h // band) * band} rows at band {band}, "
                         f"got {mask.shape[1]}")
    return mask[:, :frame_h].contiguous()


def pad_rows(x: torch.Tensor, rows: int, value) -> torch.Tensor:
    if x.shape[1] == rows:
        return x
    pad = x.new_full((x.shape[0], rows - x.shape[1], x.shape[2]), value)
    return torch.cat([x, pad], dim=1)


def fill_holes_tiled(mask: torch.Tensor, band: int = 256, frame_h=None):
    """Drop-in for ops.ccl.fill_holes on [B, H, W] (or [H, W]) masks.

    ``band`` is accepted for the JAX signature: the fill has no bands.
    ``frame_h``: the mask is given padded to whole bands ([B, Hp, W], pad
    rows background) with true height frame_h; the filled mask comes back
    padded the same way (pad rows background)."""
    squeeze = mask.dim() == 2
    m = mask[None] if squeeze else mask
    filled = flood_fill(unpad_rows(m, band, frame_h))
    filled = pad_rows(filled, m.shape[1], False)
    return filled[0] if squeeze else filled


def connected_components_tiled(mask: torch.Tensor, connectivity: int = 8,
                               band: int = 256, return_roots: int = 0,
                               band_slots: bool = False, frame_h=None):
    """Drop-in for ops.ccl.connected_components on [B, H, W] (or [H, W])
    masks: int32 labels; with return_roots = K also (root_table [B, K],
    n_blobs [B]), and with band_slots also (slot_list [B, R, K],
    slot_count [B, R]).  ``frame_h``: padded layout as in fill_holes_tiled;
    labels come back padded with H*W rows."""
    if band_slots and not return_roots:
        raise ValueError("band_slots=True requires return_roots > 0 "
                         "(slot tables are recovered from the root table)")
    squeeze = mask.dim() == 2
    m = mask[None] if squeeze else mask
    real = unpad_rows(m, band, frame_h)
    K = max(return_roots, 1)
    lab, roots, counts = band_ccl(real, band, connectivity, max(K, 128))
    lab, rl, n, sl, sc = merge_bands(lab, roots, counts, band, connectivity,
                                     K)
    lab = pad_rows(lab, m.shape[1], real.shape[1] * real.shape[2])
    out = (lab,)
    if return_roots:
        out += (rl, n) + ((sl, sc) if band_slots else ())
    if squeeze:
        out = tuple(t[0] for t in out)
    return out[0] if len(out) == 1 else out
