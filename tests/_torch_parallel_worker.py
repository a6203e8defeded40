"""Rank functions of the port's parallel tests, run in worlds started by
heimdall_tpu_torch.parallel.launch (one process per rank, gloo, CPU).
This module imports torch and numpy only (never jax), so the ranks do too.

Each function runs the steps on every mesh it is given and returns, per
mesh, the rank's coordinate and its outputs as numpy arrays; the tests put
the shards back together and compare them with the JAX package's."""

import torch

MESHES = ((2, 2), (1, 4))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _np(v) for f, v in zip(x._fields, x)}
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x


def _meshes():
    from heimdall_tpu_torch.parallel.mesh import make_mesh
    return {(d, s): make_mesh(data=d, spatial=s) for d, s in MESHES}


def step_world(frames, band, max_blobs):
    """make_tiled_spatial_step on every mesh."""
    from heimdall_tpu_torch.parallel.sharding import shard_batch
    from heimdall_tpu_torch.parallel.tiled_sp import (
        fill_holes_tiled_sp, make_tiled_spatial_step)

    out = {}
    for key, mesh in _meshes().items():
        x = shard_batch(mesh, frames, spatial=True)
        step = make_tiled_spatial_step(mesh, band=band, max_blobs=max_blobs)
        table, conf, accepted = step(x, 15, 0.0, 1e9, 0.0)
        out[key] = {"coord": tuple(mesh.get_coordinate()),
                    "table": _np(table), "conf": _np(conf),
                    "accepted": _np(accepted),
                    "rounds": fill_holes_tiled_sp.last_rounds}
    return out


def preprocess_world(frames):
    """sp_contamination_preprocess on every mesh (contrast 15 and -15)."""
    from heimdall_tpu_torch.parallel.inspect_step import (
        sp_contamination_preprocess)
    from heimdall_tpu_torch.parallel.sharding import shard_batch

    out = {}
    for key, mesh in _meshes().items():
        x = shard_batch(mesh, frames, spatial=True)
        for ct in (15, -15):
            gray, binary = sp_contamination_preprocess(x, ct, mesh)
            out[key, ct] = {"coord": tuple(mesh.get_coordinate()),
                            "gray": _np(gray), "binary": _np(binary)}
    return out


def parts_world(batches, band, max_blobs):
    """fill_holes_tiled_sp, connected_components_tiled_sp and
    blob_stats_tiled_sp on each batch (name: (mask, gray, color)) and
    every mesh."""
    from heimdall_tpu_torch.parallel.sharding import shard_batch
    from heimdall_tpu_torch.parallel.tiled_sp import (
        blob_stats_tiled_sp, connected_components_tiled_sp,
        fill_holes_tiled_sp)

    axes = ("data", "spatial")
    out = {}
    for key, mesh in _meshes().items():
        for name, (mask, gray, color) in batches.items():
            m, g, c = (shard_batch(mesh, a, spatial=True)
                       for a in (mask, gray, color))
            H = mask.shape[1]
            filled = fill_holes_tiled_sp(m, band, H, mesh, sync_axes=axes)
            rounds = fill_holes_tiled_sp.last_rounds
            lab, rl, nb, sl, sc = connected_components_tiled_sp(
                filled, band, H, mesh, max_blobs, sync_axes=axes)
            table = blob_stats_tiled_sp(lab, filled, g, c, band, H, mesh,
                                        rl, nb, sl, sc, True)
            out[key, name] = {
                "coord": tuple(mesh.get_coordinate()),
                "filled": _np(filled), "labels": _np(lab), "rl": _np(rl),
                "n_blobs": _np(nb), "table": _np(table), "rounds": rounds,
                "branch": connected_components_tiled_sp.last_branch}
    return out


def steps_world(frames, max_blobs, train_params, patches, labels):
    """The line step, the sharded inspection step (on a batch smaller than
    the spatial axis), the fused-kernel data-parallel step and the sharded
    train step (one step from train_params on the global batch, then a
    batch that does not divide over the mesh) on every mesh, line_totals of
    per-rank counters, and the dry run's small shapes (parallel/dryrun.py,
    its train step included)."""
    import torch.distributed as dist

    from heimdall_tpu_torch.models import make_sharded_train_step
    from heimdall_tpu_torch.parallel import dryrun, multihost
    from heimdall_tpu_torch.parallel.inspect_step import (
        make_line_step, make_pallas_data_parallel_step,
        make_sharded_inspection_step)
    from heimdall_tpu_torch.parallel.mesh import mesh_info
    from heimdall_tpu_torch.parallel.sharding import shard_batch

    rank = dist.get_rank()
    out = {"totals": multihost.line_totals({"frames": 8.0 + rank,
                                            "defects": float(rank)}),
           "dryrun": dryrun._worker(dist.get_world_size(), False)}
    for key, mesh in _meshes().items():
        line = make_line_step(mesh, max_blobs=max_blobs)
        insp = make_sharded_inspection_step(mesh, max_blobs=max_blobs)
        pallas = make_pallas_data_parallel_step(mesh, max_blobs=max_blobs)
        # two frames: fewer than each data group's spatial members on the
        # 1x4 mesh, one a group on the 2x2: the ceil-split pads them
        out[key] = {
            "coord": tuple(mesh.get_coordinate()), "info": mesh_info(mesh),
            "line": _np(line(shard_batch(mesh, frames, spatial=True), 15,
                             10.0, 3000.0, 0.25, 0.7)),
            "inspect_small": _np(insp(shard_batch(mesh, frames[:2],
                                                  spatial=True),
                                      15, 10.0, 3000.0, 0.25)),
            "pallas_dp": _np(pallas(shard_batch(mesh, frames), 15, 10.0,
                                    3000.0, 0.25)),
            "train": _train(make_sharded_train_step(mesh), train_params,
                            patches, labels)}
    return out


def _train(train, params, patches, labels):
    """One step of a sharded train step from params: the loss, the
    parameters after it, the optimizer's count, and the error that a batch
    of 2 fewer patches raises."""
    train.state["params"].load_state_dict(params)
    loss = train(patches, labels)
    out = {"loss": float(loss), "device": str(loss.device),
           "params": _np(train.state["params"].state_dict()),
           "count": train.state["opt"].param_groups[0]["count"]}
    try:
        train(patches[:-2], labels[:-2])
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def dp_world(frames, max_blobs, band):
    """The band-route data-parallel step on every mesh."""
    from heimdall_tpu_torch.parallel.inspect_step import (
        make_tiled_data_parallel_step)
    from heimdall_tpu_torch.parallel.sharding import shard_batch

    out = {}
    for key, mesh in _meshes().items():
        step = make_tiled_data_parallel_step(mesh, max_blobs=max_blobs,
                                             band=band)
        out[key] = {"coord": tuple(mesh.get_coordinate()),
                    "tiled_dp": _np(step(shard_batch(mesh, frames), 15,
                                         10.0, 3000.0, 0.25))}
    return out


def failing_world():
    """Rank 2 raises; the others wait in a collective it never joins."""
    import torch.distributed as dist

    if dist.get_rank() == 2:
        raise ValueError("rank 2 fails on purpose")
    dist.barrier()
    return dist.get_rank()


def card_world(frames, max_blobs, band):
    """The spatially-sharded step on the card (gloo, staged collectives),
    with the shard entries' launches counted from 0 around it."""
    from heimdall_tpu_torch.ops import ccl_tiled, stats_tiled
    from heimdall_tpu_torch.parallel.mesh import make_mesh
    from heimdall_tpu_torch.parallel.sharding import shard_batch
    from heimdall_tpu_torch.parallel.tiled_sp import make_tiled_spatial_step

    wrappers = (ccl_tiled.flood_fill_sp, ccl_tiled.band_ccl_sp,
                stats_tiled.banded_stats_sp)
    mesh = make_mesh(data=1, spatial=4)
    x = shard_batch(mesh, frames, spatial=True)
    step = make_tiled_spatial_step(mesh, band=band, max_blobs=max_blobs)
    for w in wrappers:
        w.launches = 0
    out = _np(step(x, 15, 10.0, 3000.0, 0.25))
    torch.cuda.synchronize()
    return {"out": out, "device": str(x.device),
            "launches": [w.launches for w in wrappers]}


def nccl_world(frames, max_blobs):
    """A 1-rank world on the card: both data-parallel steps and the line
    step."""
    import torch.distributed as dist

    from heimdall_tpu_torch.parallel.inspect_step import (
        make_line_step, make_pallas_data_parallel_step,
        make_tiled_data_parallel_step)
    from heimdall_tpu_torch.parallel.mesh import make_mesh
    from heimdall_tpu_torch.parallel.sharding import shard_batch

    mesh = make_mesh(data=1, spatial=1)
    x = shard_batch(mesh, frames)
    args = (15, 10.0, 3000.0, 0.25)
    return {"backend": dist.get_backend(),
            "pallas_dp": _np(make_pallas_data_parallel_step(
                mesh, max_blobs=max_blobs)(x, *args)),
            "tiled_dp": _np(make_tiled_data_parallel_step(
                mesh, max_blobs=max_blobs, band=32)(x, *args)),
            "line": _np(make_line_step(mesh, max_blobs=max_blobs)(
                x, *args, 0.7)[:3])}


def card_train_world(patches, labels):
    """The sharded train step on the card over every rank (1 x n): the
    loss, the parameters after one step and the world's backend."""
    import torch.distributed as dist

    from heimdall_tpu_torch.models import make_sharded_train_step
    from heimdall_tpu_torch.parallel.mesh import make_mesh

    train = make_sharded_train_step(make_mesh(data=1,
                                              spatial=dist.get_world_size()))
    loss = train(patches, labels)
    torch.cuda.synchronize()
    return {"loss": float(loss), "device": str(loss.device),
            "backend": dist.get_backend(),
            "params": _np(train.state["params"].state_dict())}
