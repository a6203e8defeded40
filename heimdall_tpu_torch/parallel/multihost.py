"""Multi-host inspection lines: per-host feeders -> one world (port of
heimdall_tpu/parallel/multihost.py).

One process per rank, each feeding its own device; the processes of all
hosts form one ``torch.distributed`` world.  Single-process lines degrade
gracefully (``initialize`` does nothing, ``line_totals`` returns its input),
so the same line code runs on a workstation, one card or many hosts.
"""

import logging
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from heimdall_tpu_torch.parallel import collectives
from heimdall_tpu_torch.parallel.mesh import (init_world, make_mesh,
                                             rank_device)
from heimdall_tpu_torch.parallel.sharding import (NamedSharding, local_block,
                                                  shard_batch,
                                                  to_rank_device)

logger = logging.getLogger("heimdall.multihost")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """Join the line's world (no-op for single-process lines).

    coordinator_address: "host:port" where process 0 listens; device: CUDA
    unless "cpu" (rank r takes cuda:r % device_count; NCCL when each rank
    has a card of its own, else gloo)."""
    if num_processes is None or num_processes <= 1:
        logger.info("single-process line; skipping distributed init")
        return
    init_world(coordinator_address, num_processes, process_id, device)


def global_mesh(data: int = -1, spatial: int = 1):
    """A mesh over ALL ranks of the (possibly multi-host) world."""
    return make_mesh(data=data, spatial=spatial)


def host_batch_to_global(mesh, local_frames, spatial: bool = False):
    """This rank's block of the global batch.

    Every rank passes the [N_local, H, W, C] frames of its data group (its
    own cameras' frames); the global batch is their concatenation over
    "data" (the multi-host generalization of FrameSet.to_batch() +
    shard_batch()).  Returns them on the rank's device, cut to the rank's
    rows with spatial=True.  In a single process this is shard_batch."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return shard_batch(mesh, local_frames, spatial)
    rows = NamedSharding(mesh, (Replicate(), Shard(1) if spatial
                                else Replicate()))
    return to_rank_device(local_block(rows, local_frames))


def line_totals(per_host_counts: dict) -> dict:
    """All-reduce host-side counters across the world (frames, defects,
    ...): each key's sum over every process, the same on every process
    (float32, as JAX sums them).  Single-process jobs return the input
    unchanged."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return dict(per_host_counts)
    keys = sorted(per_host_counts)
    vec = torch.tensor([per_host_counts[k] for k in keys],
                       dtype=torch.float32)
    if dist.get_backend() == "nccl":
        vec = vec.to(rank_device())
    out = collectives.all_reduce(vec, "sum").cpu()
    return {k: float(v) for k, v in zip(keys, out)}
