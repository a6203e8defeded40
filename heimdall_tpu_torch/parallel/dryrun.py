"""One run of every multi-device step on an n-rank world (the port's
analog of ``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``).

    python -m heimdall_tpu_torch.parallel.dryrun N_RANKS [cpu]

starts a world of N_RANKS ranks on this machine (parallel/launch.py; on
the card unless "cpu" is given) and runs, on a (data, spatial) mesh of
spatial 2 where N_RANKS is even: the line step, the fused-kernel and the
band-route data-parallel steps and the spatially-sharded band step at
small shapes, then the 2 MP shapes (1920x1080): the band-route
data-parallel step with one frame a rank and the spatial step with one
frame's bands over every rank; then, as the JAX entry does, one step of
the classifier's sharded train step on random patches and labels drawn
from the same generator.
"""

import sys

import numpy as np


def _worker(n_ranks: int, two_mp: bool) -> dict:
    import torch

    from heimdall_tpu_torch.parallel.inspect_step import (
        make_line_step, make_pallas_data_parallel_step,
        make_tiled_data_parallel_step)
    from heimdall_tpu_torch.parallel.mesh import make_mesh
    from heimdall_tpu_torch.parallel.sharding import shard_batch
    from heimdall_tpu_torch.parallel.tiled_sp import make_tiled_spatial_step

    spatial = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    data = n_ranks // spatial
    mesh = make_mesh(data=data, spatial=spatial)
    out = {}

    # inspection step: dp over frames + sp over image rows
    N = data * spatial * 2
    H, W = 64 * spatial, 96
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (N, H, W, 3), dtype=np.uint8)
    step = make_line_step(mesh, max_blobs=16)
    _, _, accepted, stats = step(shard_batch(mesh, frames, spatial=True),
                                 15, 10.0, 3000.0, 0.25, 0.7)
    if int(stats["frames"]) != N:
        raise AssertionError((int(stats["frames"]), N))
    out["line_frames"] = int(stats["frames"])
    frames_dp = shard_batch(mesh, frames, spatial=False)
    pstep = make_pallas_data_parallel_step(mesh, max_blobs=16)
    out["pallas_dp_accepted"] = int(pstep(frames_dp, 15, 10.0, 3000.0,
                                          0.25)[2].sum())
    tstep = make_tiled_data_parallel_step(mesh, max_blobs=16, band=16)
    out["tiled_dp_accepted"] = int(tstep(frames_dp, 15, 10.0, 3000.0,
                                         0.25)[2].sum())
    sp_step = make_tiled_spatial_step(mesh, band=16, max_blobs=16)
    out["spatial_accepted"] = int(sp_step(
        shard_batch(mesh, frames, spatial=True), 15, 10.0, 3000.0,
        0.25)[2].sum())

    if two_mp and n_ranks >= 2:
        # the 2 MP shapes: one frame a rank on the band route, and one
        # frame's bands spread over every rank
        frames_2mp = rng.randint(0, 256, (n_ranks, 1080, 1920, 3),
                                 dtype=np.uint8)
        dp = make_mesh(data=n_ranks, spatial=1)
        tstep2 = make_tiled_data_parallel_step(dp, max_blobs=16, band=128)
        out["tiled_dp_2mp_accepted"] = int(tstep2(
            shard_batch(dp, frames_2mp, spatial=False), 15, 10.0, 3000.0,
            0.25)[2].sum())
        sp = make_mesh(data=1, spatial=n_ranks)
        sp_step2 = make_tiled_spatial_step(sp, band=128, max_blobs=16)
        out["spatial_2mp_accepted"] = int(sp_step2(
            shard_batch(sp, frames_2mp[:2], spatial=True), 15, 10.0,
            3000.0, 0.25)[2].sum())

    # the model train step, data-parallel over the inspection mesh
    from heimdall_tpu_torch.models import make_sharded_train_step
    train = make_sharded_train_step(mesh)
    patches = rng.randint(0, 256, (N, 32, 32, 1), dtype=np.uint8)
    labels = rng.randint(0, 2, (N,), dtype=np.int32)
    out["train_loss"] = float(train(patches, labels))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out


def dryrun_multichip(n_ranks: int, device=None, two_mp: bool = True,
                     timeout: float = 900.0) -> list:
    """Run every multi-device step once on an n_ranks world (on the card
    unless device="cpu"); returns each rank's summary."""
    from heimdall_tpu_torch.parallel.launch import launch
    return launch("heimdall_tpu_torch.parallel.dryrun:_worker", n_ranks,
                  args=(n_ranks, two_mp), device=device, timeout=timeout)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dev = sys.argv[2] if len(sys.argv) > 2 else None
    for rank, summary in enumerate(dryrun_multichip(n, dev)):
        print(rank, summary)
