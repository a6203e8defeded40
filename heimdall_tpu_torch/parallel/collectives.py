"""The collectives of the multi-device steps, over ``torch.distributed``.

What ``shard_map`` code in the JAX package calls, one process per rank:

* ``psum`` / ``pmin`` / ``pmax``  -> ``all_reduce`` with SUM / MIN / MAX;
* ``all_gather(..., tiled=True)`` -> ``all_gather``
  (``all_gather_into_tensor``);
* ``ppermute`` of boundary rows   -> ``exchange`` (P2P ``batch_isend_irecv``
  with the previous and the next rank along a mesh axis).

Over NCCL the CUDA tensors go as they are.  Over gloo (the CPU, or several
ranks on one card, which NCCL refuses) a CUDA tensor is staged through a
pinned host buffer: copied down, reduced or sent on the host, and copied
back; the kernels around it still run on the card.
"""

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (the copy waits for it)."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """A reduced copy of t over the group ("sum", "min" or "max")."""
    out = t.contiguous().clone()
    if dist.get_world_size(group) == 1:
        return out
    if _staged(out, group):
        buf = _host(out)
        dist.all_reduce(buf, _OPS[op], group=group)
        return out.copy_(buf)
    dist.all_reduce(out, _OPS[op], group=group)
    return out


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group members' t concatenated along dim, in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.contiguous()
    if t.dtype == torch.bool:       # gathered as bytes
        return all_gather(t.to(torch.uint8), group, dim).to(torch.bool)
    src = t.contiguous().reshape((-1,) + tuple(t.shape[1:]))
    shape = (n * src.shape[0],) + tuple(src.shape[1:])
    if _staged(src, group):
        buf = torch.empty(shape, dtype=src.dtype, pin_memory=True)
        dist.all_gather_into_tensor(buf, _host(src), group=group)
        out = buf.to(src.device)
    else:
        out = torch.empty(shape, dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
    return torch.cat(out.view((n,) + tuple(t.shape)).unbind(0), dim=dim)


def exchange(ax, to_prev: torch.Tensor, to_next: torch.Tensor):
    """Swap rows with the neighbours along mesh axis ``ax``
    (mesh.Axis): this rank sends to_prev to the previous member and to_next
    to the next, and returns (from_prev, from_next), zeros where there is
    no neighbour (the axis's ends; no wrap-around)."""
    from_prev = torch.zeros_like(to_next)
    from_next = torch.zeros_like(to_prev)
    if ax.size == 1:
        return from_prev, from_next
    staged = _staged(to_prev, ax.group)
    bufs = [_host(t) if staged else t.contiguous()
            for t in (to_prev, to_next, from_prev, from_next)]
    ops = []
    if ax.index > 0:
        prev = ax.ranks[ax.index - 1]
        ops += [dist.P2POp(dist.isend, bufs[0], prev, ax.group),
                dist.P2POp(dist.irecv, bufs[2], prev, ax.group)]
    if ax.index < ax.size - 1:
        nxt = ax.ranks[ax.index + 1]
        ops += [dist.P2POp(dist.isend, bufs[1], nxt, ax.group),
                dist.P2POp(dist.irecv, bufs[3], nxt, ax.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        from_prev.copy_(bufs[2])
        from_next.copy_(bufs[3])
        return from_prev, from_next
    return bufs[2], bufs[3]
