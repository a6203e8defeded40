"""Spatially-sharded band-tiled detection: the band kernels across devices
(port of heimdall_tpu/parallel/tiled_sp.py).

Each rank holds an H-shard of its data group's frames and runs the
hand-written kernels on it with the frame's geometry (one process per rank;
the steps are called by every rank of the mesh):

* the hole fill (``flood_fill_sp``, B5b on a shard): rounds of the
  shard's fill seeded from the frame's border and from the neighbouring
  shards' reached edge rows, until an all-reduce over the whole mesh finds
  that no shard's edge rows changed (the JAX package's global fixpoint);
* the labels (``band_ccl_sp``, B5a on a shard) in the frame's linear
  indices, whose edge rows are gathered over "spatial" and merged by one
  replicated union-find on the small interface domain (the JAX package's
  XLA merge; here PyTorch ops), each rank remapping its own shard;
* the statistics (``banded_stats_sp``, B4a on a shard, with the mask rows
  across the cuts as halos; then B4b on the shard's rows), moved to the
  frame's rows and combined by all-reduce SUM / MIN / MAX.

Exact by construction, as in the JAX package: the flood runs to the global
fixpoint, the merged labels are each component's minimum, and the
statistics are linear reductions.  Every rank agrees on the number of
flood rounds and on the table-or-top-K branch of the root table (both
reduced over the whole mesh, so ranks of different data groups meet in
the same collectives).
"""

import torch

from heimdall_tpu_torch.ops import blobs as blobs_mod
from heimdall_tpu_torch.ops.blobs import S_ONES, S_Y, table_from_sums
from heimdall_tpu_torch.ops.ccl_tiled import (band_ccl_sp, first_roots,
                                              flood_fill_sp)
from heimdall_tpu_torch.ops.stats_tiled import (banded_stats_sp, bbox_sums,
                                                check_sum_bound)
from heimdall_tpu_torch.parallel import collectives
from heimdall_tpu_torch.parallel.inspect_step import (
    sp_contamination_preprocess)
from heimdall_tpu_torch.parallel.mesh import axis, mesh_group, mesh_shape

# Distinct interface pairs a frame may have for the root table to come from
# the band tables (the JAX package's _MAX_CHANGED); past it, or with more
# roots in a band than its table holds, the top-K fallback runs.
MAX_CHANGED = 1024


def pick_band(h_local: int, request: int = 128) -> int:
    """Band size for an Hl-row shard: the largest divisor of Hl <= the
    request that Mosaic can BLOCK on — band % 8 == 0 (the TPU lowering
    requires block sublane dims divisible by 8) or band == Hl (a block
    equal to the array dimension is always legal).

    The r5 1-device hardware check caught the old form: 1080 over 4
    chips gives Hl = 270, whose only divisors <= 128 are 8-unaligned
    (90, 54, ...) — Mosaic REJECTED the (1, 90, W) BlockSpec that every
    CPU interpret run had happily executed.  270 = 2 * 3^3 * 5 has no
    8-aligned divisor at all, so such shards run as one full-height
    band (R = 1), which the flood/CCL kernels handle exactly (their
    cross-band machinery just sees nothing to exchange locally)."""
    for b in range(min(request, h_local), 0, -1):
        if h_local % b == 0 and b % 8 == 0:
            return b
    return h_local


def _sync_group(mesh, axis_name, sync_axes):
    return mesh_group(mesh, axis_name if sync_axes is None else sync_axes)


def _agree(flag: torch.Tensor, op: str, group) -> int:
    """A one-word all-reduce, read on the host."""
    return int(collectives.all_reduce(flag.to(torch.int32).reshape(1), op,
                                      group).item())


# ---------------------------------------------------------------------------
# flood fill across devices
# ---------------------------------------------------------------------------

def fill_holes_tiled_sp(mask_l, band: int, H: int, mesh,
                        axis_name: str = "spatial", sync_axes=None):
    """Sharded ops.ccl_tiled.fill_holes_tiled on a [B, Hl, W] H-shard.

    Each round fills the shard whole (flood_fill_sp), its background seeded
    from the frame's border and from the neighbours' reached edge rows of
    the round before, exchanged over ``axis_name``; the rounds end when an
    all-reduce finds that no shard's edge rows changed.  The number of
    rounds of the last call is in ``fill_holes_tiled_sp.last_rounds``.

    ``sync_axes`` (default: just ``axis_name``): the mesh dims the round
    counter reduces over.  Pass both dims when the mesh has others: each
    round exchanges rows, so every rank must run as many rounds."""
    B, Hl, W = mask_l.shape
    assert Hl % band == 0, (Hl, band)
    ax = axis(mesh, axis_name)
    group = _sync_group(mesh, axis_name, sync_axes)
    m = mask_l.to(torch.uint8).contiguous()
    none = m.new_zeros((B, W))
    halos = [none if ax.index > 0 else None,
             none if ax.index < ax.size - 1 else None]
    rounds = 0
    while True:
        filled = flood_fill_sp(m, ax.index * Hl, H, *halos)
        rounds += 1
        up, down = collectives.exchange(
            ax, (~filled[:, 0]).to(torch.uint8),
            (~filled[:, -1]).to(torch.uint8))
        new = [up if halos[0] is not None else None,
               down if halos[1] is not None else None]
        changed = torch.zeros((), dtype=torch.bool, device=m.device)
        for old, cur in zip(halos, new):
            if old is not None:
                changed = changed | (old != cur).any()
        if not _agree(changed, "max", group):
            break
        halos = new
    fill_holes_tiled_sp.last_rounds = rounds
    return filled


fill_holes_tiled_sp.last_rounds = 0


# ---------------------------------------------------------------------------
# band CCL across devices
# ---------------------------------------------------------------------------

def _interface_pairs(edges, sentinel: int, connectivity: int):
    """Label pairs (a, b) adjacent across the band boundaries of the
    gathered edge rows [B, Rt, 2, W] (int64 [B, E] each) and which of them
    join two labels."""
    B, Rt, _, W = edges.shape
    top = edges[:, :-1, 1].to(torch.int64)     # last row of band r
    bot = edges[:, 1:, 0].to(torch.int64)      # first row of band r + 1
    pa, pb = [], []
    for s in ((-1, 0, 1) if connectivity == 8 else (0,)):
        pad = top.new_full((B, Rt - 1, abs(s)), sentinel)
        a = (top if s == 0 else torch.cat([top[..., s:], pad], -1) if s > 0
             else torch.cat([pad, top[..., :s]], -1))
        pa.append(a.reshape(B, -1))
        pb.append(bot.reshape(B, -1))
    a, b = torch.cat(pa, -1), torch.cat(pb, -1)
    return a, b, (a < sentinel) & (b < sentinel) & (a != b)


def _union_find(ka: torch.Tensor, kb: torch.Tensor):
    """(domain u, sorted; index of each member's root in u) of the graph
    whose edges join keys ka[i] and kb[i]; a root is its component's least
    key (hooks go from the larger root to the smaller, then pointers jump
    to their roots, until no edge joins two roots)."""
    u = torch.unique(torch.cat([ka, kb]))
    ia = torch.searchsorted(u, ka)
    ib = torch.searchsorted(u, kb)
    parent = torch.arange(u.numel(), device=u.device)
    while True:
        pa, pb = parent[ia], parent[ib]
        new = parent.clone()
        new.scatter_reduce_(0, torch.maximum(pa, pb), torch.minimum(pa, pb),
                            reduce="amin")
        while True:
            nxt = new[new]
            if torch.equal(nxt, new):
                break
            new = nxt
        if torch.equal(new, parent):
            return u, parent
        parent = new


def _lookup(old: torch.Tensor, new: torch.Tensor, keys: torch.Tensor):
    """keys mapped through the sorted table old -> new (others kept)."""
    if old.numel() == 0:
        return keys
    idx = torch.searchsorted(old, keys).clamp(max=old.numel() - 1)
    return torch.where(old[idx] == keys, new[idx], keys)


def merge_edge_tables(edges, sentinel: int, connectivity: int = 8):
    """The replicated merge of the gathered edge rows [B, Rt, 2, W]:
    (old keys, new keys: each label that the merge changes and its
    component's minimum, as frame * (sentinel + 1) + label, sorted;
    n_changed int64 [B]; distinct joining pairs int64 [B])."""
    B = edges.shape[0]
    S1 = sentinel + 1
    dev = edges.device
    a, b, keep = _interface_pairs(edges, sentinel, connectivity)
    frame = torch.arange(B, device=dev)[:, None].expand_as(a)
    lo, hi = torch.minimum(a, b)[keep], torch.maximum(a, b)[keep]
    f = frame[keep]
    n_pairs = torch.zeros(B, dtype=torch.int64, device=dev)
    if f.numel():
        pairs = torch.unique(torch.stack([f, lo, hi], 1), dim=0)
        n_pairs = torch.bincount(pairs[:, 0], minlength=B)
    u, parent = _union_find(f * S1 + lo, f * S1 + hi)
    changed = parent != torch.arange(u.numel(), device=dev)
    old, new = u[changed], u[parent[changed]]
    n_changed = torch.bincount(old // S1, minlength=B)
    return old, new, n_changed, n_pairs


def compact_incidence(presence):
    """[B, R, K] bool -> (slot_list [B, R, K] int32, present slots
    ascending then the others; slot_count [B, R] int32)."""
    order = torch.argsort((~presence).to(torch.uint8), dim=-1, stable=True)
    return order.to(torch.int32), presence.sum(-1).to(torch.int32)


def connected_components_tiled_sp(mask_l, band: int, H: int, mesh,
                                  max_blobs: int, connectivity: int = 8,
                                  axis_name: str = "spatial",
                                  sync_axes=None):
    """Sharded connected_components_tiled(return_roots=K, band_slots=True).

    Each rank labels its bands (band_ccl_sp, the frame's indices), the
    gathered edge tables drive one replicated interface merge, and each
    rank remaps its own shard.  Returns (labels_l, root_table [B, K],
    n_blobs [B], slot_list [B, R_local, K], slot_count [B, R_local]), the
    root table and counts replicated over the axis.

    ``sync_axes``: as in fill_holes_tiled_sp; here it makes every rank take
    the same branch, the band tables or the top-K fallback (which has
    collectives of its own), forcing the fallback everywhere when any rank
    needs it (exact either way).  The last call's branch is in
    ``connected_components_tiled_sp.last_branch``."""
    B, Hl, W = mask_l.shape
    assert Hl % band == 0, (Hl, band)
    R = Hl // band
    ax = axis(mesh, axis_name)
    n = ax.size
    assert n * R >= 2, ("connected_components_tiled_sp needs >= 2 global "
                        "bands (n_devices * bands_per_shard)", n, R)
    K = max_blobs
    cap_b = max(K, 128)
    sentinel = H * W
    S1 = sentinel + 1
    base = ax.index * Hl * W
    dev = mask_l.device

    lab, band_roots, counts, edges = band_ccl_sp(
        mask_l.to(torch.uint8).contiguous(), band, base, sentinel,
        connectivity, cap_b)
    # the small per-band tables of every shard (Hl % band == 0 makes the
    # gathered tables the single-device ones)
    edges_g = collectives.all_gather(edges, ax.group, dim=1)
    roots_g = collectives.all_gather(band_roots, ax.group, dim=1)
    counts_g = collectives.all_gather(counts, ax.group, dim=1)
    Rt = n * R

    old, new, n_changed, n_pairs = merge_edge_tables(edges_g, sentinel,
                                                     connectivity)
    fkey = torch.arange(B, device=dev) * S1
    merged = (_lookup(old, new, lab.to(torch.int64) + fkey[:, None, None])
              - fkey[:, None, None]).to(torch.int32)

    table_ok = (n_pairs.max() <= MAX_CHANGED) & (counts_g.max() <= cap_b)
    if _agree(table_ok, "min", _sync_group(mesh, axis_name, sync_axes)):
        flat = roots_g.reshape(B, -1).to(torch.int64)
        mapped = (_lookup(old, new, flat + fkey[:, None])
                  - fkey[:, None])
        survivors = torch.where(mapped != flat, sentinel, flat)
        rl = torch.sort(survivors, dim=-1).values[:, :K]
        n_blobs = counts_g.sum(-1) - n_changed
        slot = torch.searchsorted(rl.contiguous(), mapped).clamp(max=K - 1)
        hit = (rl.gather(1, slot) == mapped) & (mapped < sentinel)
        presence = torch.zeros((B, Rt * cap_b, K + 1), dtype=torch.bool,
                               device=dev)
        presence.scatter_(2, torch.where(hit, slot, K)[..., None], True)
        presence = presence.view(B, Rt, cap_b, K + 1)[..., :K].any(2)
        branch = "table"
    else:
        # adversarial fallback (more roots in a band than its table
        # holds, or too many interface pairs): local top-K roots, gathered
        # and sorted again — exact, with every slot in every band
        lin = base + torch.arange(Hl * W, device=dev)
        flat_l = merged.reshape(B, Hl * W)
        is_root = (flat_l == lin) & (flat_l != sentinel)
        keys = torch.where(is_root, flat_l, sentinel)
        rl_all = collectives.all_gather(first_roots(keys, K, sentinel),
                                        ax.group, dim=-1)
        rl = torch.sort(rl_all, dim=-1).values[:, :K]
        n_blobs = collectives.all_reduce(is_root.sum(-1), "sum", ax.group)
        presence = (rl < sentinel)[:, None, :].expand(B, Rt, K)
        branch = "topk"
    connected_components_tiled_sp.last_branch = branch
    slot_list, slot_count = compact_incidence(
        presence[:, ax.index * R:(ax.index + 1) * R])
    return (merged, rl.to(torch.int32), n_blobs.to(torch.int32), slot_list,
            slot_count)


connected_components_tiled_sp.last_branch = None


# ---------------------------------------------------------------------------
# per-blob statistics across devices
# ---------------------------------------------------------------------------

def blob_stats_tiled_sp(labels_l, mask_l, gray_l, color_l, band: int,
                        H: int, mesh, rl, n_blobs, slot_list, slot_count,
                        use_color: bool, axis_name: str = "spatial",
                        channel_major: bool = False):
    """Sharded blob_stats_tiled: the banded stats kernels on each rank,
    their linear reductions combined by all-reduce SUM / MIN / MAX over the
    axis.

    labels_l hold the frame's labels for the local H-shard; rl / n_blobs
    are the replicated root table; slot_list / slot_count the local bands'
    incidence rows.  color_l: uint8 [B, Hl, W, 3] ([B, 3, Hl, W] with
    channel_major) or None.  Returns the replicated BlobTable."""
    B, Hl, W = labels_l.shape
    ax = axis(mesh, axis_name)
    row_off = ax.index * Hl
    K = rl.shape[-1]
    color = color_l if use_color and color_l is not None else None
    m = mask_l.to(torch.uint8).contiguous()

    # the mask rows across the cuts (none at the frame's edges, which the
    # stats count as background, as the single-device zero pad)
    up, down = collectives.exchange(ax, m[:, 0].contiguous(),
                                    m[:, -1].contiguous())
    sums_l, bbox_l = banded_stats_sp(
        labels_l, m, gray_l, color, rl.to(torch.int32),
        n_blobs.to(torch.int32), H * W, K,
        up if ax.index > 0 else None,
        down if ax.index < ax.size - 1 else None, channel_major)

    # to the frame's rows BEFORE the reduction: sum(row) = sum(local row) +
    # row_off * count, bbox y += row_off (the kernel's neutrals: y0 = Hl,
    # y1 = -1)
    sums_l[:, S_Y] += row_off * sums_l[:, S_ONES]
    sums = collectives.all_reduce(sums_l, "sum", ax.group)
    y0 = torch.where(bbox_l[:, 1] >= Hl, H, bbox_l[:, 1] + row_off)
    y1 = torch.where(bbox_l[:, 3] < 0, -1, bbox_l[:, 3] + row_off)
    lo = collectives.all_reduce(torch.stack([bbox_l[:, 0], y0], 1), "min",
                                ax.group)
    hi = collectives.all_reduce(torch.stack([bbox_l[:, 2], y1], 1), "max",
                                ax.group)
    bbox = torch.stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]], 1)

    # the bbox-window sums need the final bbox: back in the shard's rows
    # (rows outside the shard lie outside its bands and are not read)
    local = torch.stack([bbox[:, 0], bbox[:, 1] - row_off, bbox[:, 2],
                         bbox[:, 3] - row_off], 1).to(torch.int32)
    box_l = bbox_sums(local.contiguous(), slot_list.to(torch.int32),
                      slot_count.to(torch.int32), band, gray_l, color,
                      channel_major)
    box = collectives.all_reduce(box_l, "sum", ax.group)
    return table_from_sums(sums, bbox, box, n_blobs.to(torch.int32),
                           use_color=color is not None)


# ---------------------------------------------------------------------------
# the full sharded step
# ---------------------------------------------------------------------------

def make_tiled_spatial_step(mesh, band: int = 128, max_blobs: int = 64,
                            use_color: bool = True, formula: str = "python",
                            interpret: bool = None):
    """This rank's multi-device single-frame-latency step over the band
    kernels.

    Input: the rank's block [Nl, Hl, W, 3] uint8 of frames sharded N over
    "data" and H over "spatial" (``shard_batch(mesh, frames, True)``; H
    divides by the spatial size).  The preprocess runs on the halo-extended
    shard (parallel/inspect_step.py); flood, labels and stats on the band
    kernels, bands spread over "spatial".  ``interpret`` is the TPU build's
    knob, accepted and unused.

    Returns (BlobTable, confidence [Nl, K], accepted [Nl, K]) of the rank's
    data group — equal to contamination_program(tiled_band=...) on the
    whole frames."""
    del interpret
    n_sp = mesh_shape(mesh)["spatial"]
    axes = ("data", "spatial")

    def step(frames, contrast, min_size, max_size, min_conf):
        Hl, W = frames.shape[1], frames.shape[2]
        H = Hl * n_sp
        check_sum_bound(H, W)
        b = pick_band(Hl, band)
        gray_l, binary_l = sp_contamination_preprocess(frames, contrast,
                                                       mesh)
        mask_l = fill_holes_tiled_sp(binary_l > 0, b, H, mesh,
                                     sync_axes=axes)
        labels_l, rl, n_blobs, slot_list, slot_count = (
            connected_components_tiled_sp(mask_l, b, H, mesh, max_blobs,
                                          sync_axes=axes))
        table = blob_stats_tiled_sp(
            labels_l, mask_l, gray_l, frames if use_color else None, b, H,
            mesh, rl, n_blobs, slot_list, slot_count, use_color)
        conf = (blobs_mod.confidence_native(table) if formula == "native"
                else blobs_mod.confidence_python(table))

        def f32(v):
            return torch.full((), v, dtype=torch.float32, device=conf.device)

        size_ok = ((table.area >= f32(min_size))
                   & (table.area <= f32(max_size))
                   & table.valid & (table.area_px > 0))
        accepted = size_ok & (conf >= f32(min_conf))
        return table, conf, accepted

    return step
