"""Sharding helpers: frame batches over the inspection mesh (port of
heimdall_tpu/parallel/sharding.py).

A placement is the JAX ``NamedSharding``'s content: the mesh and, per mesh
dim, how it cuts the tensor (``torch.distributed.tensor`` placements:
``Shard(0)`` = the batch over "data", ``Shard(1)`` = the rows over
"spatial", ``Replicate()``).  ``shard_batch`` hands each rank its block of
a host batch on its device: the one host-to-device copy of the step.
"""

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

from heimdall_tpu_torch.parallel.mesh import AXES, rank_device


class NamedSharding(NamedTuple):
    mesh: object
    placements: tuple


def batch_sharding(mesh, spatial: bool = False) -> NamedSharding:
    """Sharding for [N, H, W, C] frame batches: N over "data", optionally
    H over "spatial"."""
    return NamedSharding(mesh, (Shard(0), Shard(1) if spatial
                                else Replicate()))


def replicated_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, (Replicate(), Replicate()))


def local_block(sharding: NamedSharding, frames):
    """This rank's block of a host batch under ``sharding`` (a view)."""
    coord = sharding.mesh.get_coordinate()
    for dim, (place, name) in enumerate(zip(sharding.placements, AXES)):
        if not isinstance(place, Shard):
            continue
        n, i, size = sharding.mesh.size(dim), coord[dim], frames.shape[
            place.dim]
        if size % n:
            raise ValueError(f"dim {place.dim} of size {size} does not "
                             f"divide over {n} ranks of {name!r}")
        step = size // n
        index = [slice(None)] * frames.ndim
        index[place.dim] = slice(i * step, (i + 1) * step)
        frames = frames[tuple(index)]
    return frames


def to_rank_device(block) -> torch.Tensor:
    """A host block (numpy or tensor), contiguous on the rank's device."""
    if isinstance(block, np.ndarray):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.contiguous().to(rank_device())


def shard_batch(mesh, frames, spatial: bool = False) -> torch.Tensor:
    """This rank's [N/data, H/spatial (or H), ...] block of the host batch
    ``frames`` (numpy or tensor), contiguous on the rank's device."""
    return to_rank_device(local_block(batch_sharding(mesh, spatial), frames))
