"""Device meshes for multi-device inspection lines (port of
heimdall_tpu/parallel/mesh.py).

The JAX package shards over a 2-D ``jax.sharding.Mesh``: ``data`` (frames,
the batched replacement for thread-per-station) by ``spatial`` (the image's
H axis, for the stencil and band phases).  Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same two dims over
the ranks of a ``torch.distributed`` world, one process per rank, each on
its own device: ``cuda:rank % device_count`` on the card, the CPU with
``device="cpu"``.  Where ``shard_map`` runs a function on every device, here
every rank calls it on its own block.

The world's backend is NCCL when each rank has a card of its own, and gloo
on the CPU or when ranks share a card (NCCL refuses two ranks on one
device); parallel/collectives.py then stages the CUDA tensors of each
collective through pinned host buffers, and every kernel still runs on the
card.
"""

import logging
import socket
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger("heimdall.parallel")

AXES = ("data", "spatial")

# This process's compute device, set when its world starts.
_RANK_DEVICE = {"device": None}


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(address: str, world_size: int, rank: int,
               device=None) -> torch.device:
    """Join a world of world_size processes whose rank 0 listens at
    address ("host:port") on ``device`` (CUDA unless "cpu"; rank r takes
    cuda:r % device_count); returns this rank's compute device.  The
    backend is NCCL when every rank has a card of its own, else gloo."""
    from heimdall_tpu_torch.detectors.contamination_detector import (
        resolve_device)
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if world_size <= torch.cuda.device_count():
            backend = "nccl"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world_size, rank=rank, **kwargs)
    _RANK_DEVICE["device"] = dev
    logger.info("rank %d of %d on %s over %s", rank, world_size, dev,
                backend)
    return dev


def rank_device() -> torch.device:
    """This rank's compute device."""
    if _RANK_DEVICE["device"] is None:
        raise RuntimeError("no world: start one with parallel.launch, "
                           "multihost.initialize or make_mesh")
    return _RANK_DEVICE["device"]


def _ensure_world(device) -> None:
    """A one-process line needs no launcher: start a world of one rank."""
    if not dist.is_initialized():
        init_world(f"127.0.0.1:{free_port()}", 1, 0, device)


def make_mesh(data: int = -1, spatial: int = 1,
              devices: Optional[Sequence] = None, device=None):
    """Build a ("data", "spatial") mesh over the world's ranks.

    data=-1 uses all remaining ranks after the spatial split.  ``devices``:
    the ranks to build it from (default every rank of the world; the first
    data * spatial of them form the mesh).  In a process with no world a
    world of one rank is started on ``device`` (CUDA unless "cpu")."""
    ranks = list(devices) if devices is not None else (
        list(range(dist.get_world_size())) if dist.is_initialized()
        else [0])
    n = len(ranks)
    if spatial <= 0:
        spatial = 1
    if data == -1:
        if n % spatial:
            raise ValueError(f"{n} devices not divisible by spatial={spatial}")
        data = n // spatial
    if data * spatial > n:
        raise ValueError(
            f"mesh {data}x{spatial} needs {data*spatial} devices, have {n}")
    _ensure_world(device)
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.tensor(ranks[:data * spatial]).view(data, spatial)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(kind, grid, mesh_dim_names=AXES)
    if grid.numel() != dist.get_world_size():
        # every rank of the world takes part in making a group
        mesh._hd_all_group = dist.new_group([int(r) for r in grid.flatten()])
    return mesh


def mesh_shape(mesh) -> dict:
    """{"data": d, "spatial": s}, as a JAX mesh's ``shape``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def mesh_info(mesh) -> dict:
    shape = mesh_shape(mesh)
    return {
        "axis_names": list(mesh.mesh_dim_names),
        "shape": shape,
        "n_devices": int(mesh.mesh.numel()),
        "devices": [f"rank {int(r)}" for r in mesh.mesh.flatten()],
    }


class Axis(NamedTuple):
    """One dim of a mesh as this rank sees it: its process group, its size,
    this rank's index along it and the global ranks of its members (in
    order).  What ``jax.lax.axis_index`` / ``axis_size`` and a
    ``ppermute`` along ``axis_name`` need."""
    name: str
    group: object
    size: int
    index: int
    ranks: tuple


def axis(mesh, name: str = "spatial") -> Axis:
    dim = mesh.mesh_dim_names.index(name)
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    idx = list(coord)
    members = []
    for i in range(mesh.size(dim)):
        idx[dim] = i
        members.append(int(mesh.mesh[tuple(idx)]))
    return Axis(name, mesh.get_group(name), mesh.size(dim), coord[dim],
                tuple(members))


def mesh_group(mesh, names):
    """The process group over the mesh dims ``names`` (one name or a
    tuple): the dim's own group, or for both dims the world's (the mesh
    spans it) or a group of the mesh's ranks."""
    if isinstance(names, str):
        return mesh.get_group(names)
    if tuple(sorted(names)) != tuple(sorted(mesh.mesh_dim_names)):
        raise ValueError(f"unsupported axes {names}")
    return getattr(mesh, "_hd_all_group", dist.group.WORLD)
