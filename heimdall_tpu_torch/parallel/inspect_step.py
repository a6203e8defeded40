"""Multi-device inspection steps: one process per rank, halo exchange and
collectives (port of heimdall_tpu/parallel/inspect_step.py).

The frame batch shards over the "data" dim of the mesh (stations x bottles)
and the image's H axis over "spatial".  Every step is built once per rank
and called by every rank of the mesh on its own block (what ``shard_map``
runs on each device), with the block that ``sharding.shard_batch`` gives it.

* The stencil phase (gray -> blur5 -> adaptive threshold -> open -> close)
  runs on an H-shard extended by the rows its stencils reach across each
  cut: the JAX package exchanges halo rows once per stencil op; here one
  exchange of ``PRE_HALO`` = 11 frame rows a side (blur5 2 + mean11 5 +
  open and close 4) feeds the port's whole-frame preprocess
  (ops/fused_kernels.py::preprocess, ``hd_preprocess`` on the card), whose
  result is then cut back to the shard.  A side that is the frame's edge
  gets no rows, so it keeps the border of each op: the result equals the
  single-device preprocess bit for bit.
* The labeling phase gathers the planes over "spatial" and re-splits the
  batch among the spatial members (each labels whole frames through the
  band route's kernels), then gathers the small blob tables.

Outputs: the spatial steps return the rows of the rank's data group
(replicated over "spatial", JAX's ``P("data")``); the data-parallel steps
return the rank's own block of a flat mesh (JAX's ``P("data_all")``).
"""

import torch

from heimdall_tpu_torch.ops import blobs as blobs_mod
from heimdall_tpu_torch.ops.ccl_tiled import fill_holes_tiled
from heimdall_tpu_torch.ops.fused_kernels import fused_detect, gate, \
    preprocess
from heimdall_tpu_torch.ops.stats_tiled import label_and_table
from heimdall_tpu_torch.parallel import collectives
from heimdall_tpu_torch.parallel.mesh import axis, mesh_group, mesh_shape

# Frame rows the stencil phase reads across a cut: blur5 (2) + mean11 (5)
# + open (2) + close (2).
PRE_HALO = 11
# Band of the whole-frame labeling in the sharded inspection step.
LABEL_BAND = 128


def sp_contamination_preprocess(frames, contrast_threshold, mesh,
                                axis_name: str = "spatial"):
    """The stencil phase on an H-shard [B, Hl, W(, 3)]: (gray uint8
    [B, Hl, W], closed binary uint8 [B, Hl, W], 1 = foreground), bit-equal
    to the single-device preprocess of the whole frames."""
    ax = axis(mesh, axis_name)
    Hl = frames.shape[1]
    if ax.size > 1 and Hl < PRE_HALO:
        raise ValueError(f"a shard of {Hl} rows is shorter than the "
                         f"preprocess's reach of {PRE_HALO} rows")
    # PRE_HALO rows from the previous and the next shard (zeros at the
    # axis's ends, which are not used)
    top, bot = collectives.exchange(
        ax, frames[:, :PRE_HALO].contiguous(),
        frames[:, Hl - PRE_HALO:].contiguous())
    parts = [frames]
    lo = 0
    if ax.index > 0:
        parts.insert(0, top)
        lo = PRE_HALO
    if ax.index < ax.size - 1:
        parts.append(bot)
    ext = torch.cat(parts, dim=1) if len(parts) > 1 else frames
    gray, binary = preprocess(ext.contiguous(), contrast_threshold)
    if len(parts) == 1:
        return gray, binary
    return (gray[:, lo:lo + Hl].contiguous(),
            binary[:, lo:lo + Hl].contiguous())


def make_sharded_inspection_step(mesh, max_blobs: int = 64,
                                 use_color: bool = True,
                                 formula: str = "python"):
    """Build this rank's multi-device contamination-inspection step.

    Input: the rank's block [Nl, Hl, W, 3] uint8 of frames sharded N over
    "data" and H over "spatial" (``shard_batch(mesh, frames, True)``).

    Returns a function (frames, contrast, min_size, max_size, min_conf) ->
    (BlobTable, confidence [Nl, K], accepted [Nl, K]) for the rank's data
    group's Nl frames."""
    sp = axis(mesh, "spatial")
    n_sp = sp.size

    def step(frames, contrast, min_size, max_size, min_conf):
        gray_l, binary_l = sp_contamination_preprocess(frames, contrast,
                                                       mesh)
        # gather whole-frame planes, then re-split the batch over "spatial"
        gray = collectives.all_gather(gray_l, sp.group, dim=1)
        binary = collectives.all_gather(binary_l, sp.group, dim=1)
        color = (collectives.all_gather(frames, sp.group, dim=1)
                 if use_color else None)
        nl = frames.shape[0]
        # ceil-split: when the data group's batch is smaller than the
        # spatial axis, pad it with all-zero planes (empty blob tables),
        # trimmed after the row gather below
        chunk = -(-nl // n_sp)

        def mine(a):
            if chunk * n_sp != nl:
                pad = a.new_zeros((chunk * n_sp - nl,) + tuple(a.shape[1:]))
                a = torch.cat([a, pad])
            return a[sp.index * chunk:(sp.index + 1) * chunk].contiguous()

        gray_c, binary_c = mine(gray), mine(binary)
        color_c = mine(color) if color is not None else None
        mask = fill_holes_tiled(binary_c > 0)
        _, table = label_and_table(mask, gray_c, color_c,
                                   band=min(LABEL_BAND, mask.shape[1]),
                                   max_blobs=max_blobs, use_color=use_color)
        conf, accepted = gate(table, min_size, max_size, min_conf, formula)

        # the data group's whole batch of tables on every spatial member
        def gather_rows(a):
            return collectives.all_gather(a, sp.group, dim=0)[:nl]

        table = blobs_mod.BlobTable(*(gather_rows(f) for f in table))
        return table, gather_rows(conf), gather_rows(accepted)

    return step


def make_line_step(mesh, max_blobs: int = 64, use_color: bool = True):
    """Inspection step + line-level statistics reduction.

    Returns (table, conf, accepted, stats) where stats holds the line
    totals (frames, defects, rejects at the confidence reject_threshold;
    int32 scalars, the same on every rank) summed over the whole mesh —
    the multi-device equivalent of the per-station counters of
    core/system.py."""
    base = make_sharded_inspection_step(mesh, max_blobs, use_color)
    n_sp = mesh_shape(mesh)["spatial"]
    group = mesh_group(mesh, ("data", "spatial"))

    def step(frames, contrast, min_size, max_size, min_conf,
             reject_threshold):
        table, conf, accepted = base(frames, contrast, min_size, max_size,
                                     min_conf)
        thr = torch.full((), reject_threshold, dtype=torch.float32,
                         device=conf.device)
        rejects = (accepted.any(dim=-1)
                   & (torch.where(accepted, conf, 0.0).max(dim=-1).values
                      >= thr)).sum()
        local = torch.stack([
            torch.tensor(accepted.shape[0], device=conf.device),
            accepted.sum(), rejects]).to(torch.int32)
        # the sum over "data" and "spatial" counts each data group's rows
        # once per spatial member: divide it out
        f, d, r = (collectives.all_reduce(local, "sum", group)
                   // n_sp).unbind(0)
        return table, conf, accepted, {"frames": f, "defects": d,
                                       "rejects": r}

    return step


def _flat_block(mesh, frames):
    """The rank's block of a flat "data_all" mesh, from its data group's
    rows (what ``shard_batch(mesh, frames, spatial=False)`` gives)."""
    sp = axis(mesh, "spatial")
    n = frames.shape[0]
    if n % sp.size:
        raise ValueError(f"{n} frames of a data group do not divide over "
                         f"{sp.size} spatial ranks")
    step = n // sp.size
    return frames[sp.index * step:(sp.index + 1) * step].contiguous()


def make_pallas_data_parallel_step(mesh, max_blobs: int = 64,
                                   use_color: bool = True,
                                   formula: str = "python",
                                   sweeps: int = 1, adaptive: bool = True,
                                   interpret: bool = False):
    """Data-parallel step over the fused kernel (B1): each rank detects its
    own frames with no collective.  ``sweeps``, ``adaptive`` and
    ``interpret`` are the TPU build's knobs, accepted and unused.

    Input: the data group's rows (``shard_batch(mesh, frames,
    spatial=False)``); returns (BlobTable, confidence, accepted) of the
    rank's block of the flat mesh over every rank."""
    del sweeps, adaptive, interpret

    def step(frames, contrast, min_size, max_size, min_conf):
        return fused_detect(_flat_block(mesh, frames), contrast, min_size,
                            max_size, min_conf, max_blobs, use_color,
                            formula)

    return step


def make_tiled_data_parallel_step(mesh, max_blobs: int = 64,
                                  use_color: bool = True,
                                  formula: str = "python", sweeps: int = 6,
                                  band: int = 256):
    """Data-parallel step over the band-tiled route: each rank runs
    ``contamination_program(tiled_band=band)`` on its own frames (the 2 MP
    production layout), no collective.  ``sweeps`` is the TPU build's knob,
    accepted and unused.  Input and outputs as in
    make_pallas_data_parallel_step."""
    from heimdall_tpu_torch.detectors.contamination_detector import (
        contamination_program)
    del sweeps

    def step(frames, contrast, min_size, max_size, min_conf):
        return contamination_program(
            _flat_block(mesh, frames), contrast, min_size, max_size,
            min_conf, max_blobs=max_blobs, use_color=use_color,
            formula=formula, tiled_band=band)

    return step
