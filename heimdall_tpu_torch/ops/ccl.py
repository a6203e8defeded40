"""Connected-component labeling and hole filling in plain PyTorch
(port of heimdall_tpu/ops/ccl.py).

The contract is the JAX package's fixpoint, not its sweep structure:

* ``connected_components``: every foreground pixel holds the linear index
  (y*W + x) of its component's first raster pixel; background holds H*W.
* ``fill_holes``: background that is 4-connected to the frame border stays
  background; everything else (holes, and components nested in them) is
  foreground.

The labeling loop is neighbour-min propagation with min-hooking and pointer
jumping: labels only decrease and always name a pixel of the same
component, so the loop stops exactly when the neighbour minimum no longer
changes any label, i.e. at the component minimum.  Labels are computed as
global indices over the flattened batch (int64) and made frame-local at the
end.  This is the plain version the fused CUDA kernel is held against.

With ``sweeps`` or ``max_iters``, ``connected_components`` runs JAX's sweeps
instead (heimdall_tpu/ops/ccl.py:74-125): the 3x3 neighbour min, then the
masked segmented min-scans along the rows forward and back and along the
columns forward and back, which together give each foreground run of a row
(then of a column) its least label.  ``sweeps > 0`` runs exactly that many
with no fixpoint check, as JAX's segmentation detector does, and may leave
components split; ``max_iters > 0`` repeats them until none changes a label
or max_iters have run.  These are the counterparts of JAX's XLA ops, not
the plain version of a kernel.
"""

import torch

_OFFSETS8 = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)
             if (di, dj) != (0, 0)]
_OFFSETS4 = [(-1, 0), (1, 0), (0, -1), (0, 1)]


def _neighbor_min(lab: torch.Tensor, sentinel: int,
                  connectivity: int) -> torch.Tensor:
    """Minimum over each pixel and its neighbours; [B, H, W] int64."""
    B, H, W = lab.shape
    lp = torch.full((B, H + 2, W + 2), sentinel, dtype=lab.dtype,
                    device=lab.device)
    lp[:, 1:H + 1, 1:W + 1] = lab
    out = lab
    for di, dj in (_OFFSETS8 if connectivity == 8 else _OFFSETS4):
        out = torch.minimum(out, lp[:, 1 + di:1 + di + H, 1 + dj:1 + dj + W])
    return out


def _global_labels(mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    """[B, H, W] bool -> int64 labels as indices into the flattened batch;
    background holds B*H*W."""
    B, H, W = mask.shape
    N = B * H * W
    gidx = torch.arange(N, device=mask.device).view(B, H, W)
    lab = torch.where(mask, gidx, N)
    # one extra slot so that background labels (N) index into it
    flat = torch.cat([lab.reshape(-1), lab.new_full((1,), N)])
    while True:
        cur = flat[:N].view(B, H, W)
        nm = torch.where(mask, _neighbor_min(cur, N, connectivity), N)
        new = flat.clone()
        # hook: the pixel a label names takes the smaller neighbour label
        new.scatter_reduce_(0, flat[:N], nm.reshape(-1), reduce="amin")
        new[:N] = torch.minimum(new[:N], nm.reshape(-1))
        for _ in range(2):                      # pointer jumping
            new[:N] = new[new[:N]]
        if torch.equal(new, flat):
            return cur
        flat = new


def _as_batch(mask: torch.Tensor):
    lead = mask.shape[:-2]
    H, W = mask.shape[-2], mask.shape[-1]
    return mask.reshape(-1, H, W).to(torch.bool), lead


def _run_min(lab: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each foreground run of a row of lab [B, H, W] takes its least label
    (JAX's forward and backward segmented min-scans, whose resets are the
    background); background holds lab's value there."""
    flat_m = mask.reshape(-1)
    prev = torch.zeros_like(mask)
    prev[..., 1:] = mask[..., :-1]
    # a run never crosses a row: a row's first foreground pixel starts one
    run = (mask & ~prev).reshape(-1).cumsum(0)
    sentinel = lab.new_full((), torch.iinfo(lab.dtype).max)
    vals = torch.where(flat_m, lab.reshape(-1), sentinel)
    # one slot a pixel and one more: no host read of the run count
    least = torch.full((run.numel() + 1,), torch.iinfo(lab.dtype).max,
                       dtype=lab.dtype, device=lab.device)
    least.scatter_reduce_(0, run, vals, reduce="amin")
    return torch.where(mask, least[run].view(lab.shape), lab)


def _sweep(lab: torch.Tensor, mask: torch.Tensor, sentinel: int,
           connectivity: int) -> torch.Tensor:
    """One of JAX's sweeps: the neighbour min, then the run minima along
    the rows and along the columns, background held at the sentinel."""
    lab = torch.where(mask, _neighbor_min(lab, sentinel, connectivity),
                      sentinel)
    lab = _run_min(lab, mask)
    cols = _run_min(lab.transpose(1, 2).contiguous(),
                    mask.transpose(1, 2).contiguous())
    return cols.transpose(1, 2).contiguous()


def _sweep_labels(m: torch.Tensor, connectivity: int, max_iters: int,
                  sweeps: int) -> torch.Tensor:
    """JAX's sweep labeling of m [B, H, W]: exactly ``sweeps`` sweeps, or
    sweeps until none changes a label or ``max_iters`` have run."""
    B, H, W = m.shape
    S = H * W
    lin = torch.arange(S, dtype=torch.int32, device=m.device).view(H, W)
    lab = torch.where(m, lin, S)
    if sweeps > 0:
        for _ in range(sweeps):
            lab = _sweep(lab, m, S, connectivity)
        return lab
    for _ in range(max_iters):
        new = _sweep(lab, m, S, connectivity)
        if torch.equal(new, lab):
            break
        lab = new
    return lab


def connected_components(mask: torch.Tensor, connectivity: int = 8,
                         max_iters: int = 0,
                         sweeps: int = 0) -> torch.Tensor:
    """Label connected components of a boolean mask [..., H, W].

    Returns int32 labels [..., H, W]: foreground pixels hold the linear
    index of their component's minimal pixel, background holds H*W.  With
    ``sweeps > 0``, exactly that many of JAX's sweeps and no fixpoint check
    (a component may stay split, each part labelled by a pixel of it); with
    ``max_iters > 0``, sweeps until a fixpoint or max_iters of them.
    """
    m, lead = _as_batch(mask)
    B, H, W = m.shape
    HW = H * W
    if sweeps > 0 or max_iters > 0:
        out = _sweep_labels(m, connectivity, max_iters, sweeps)
        return out.reshape(lead + (H, W))
    lab = _global_labels(m, connectivity)
    base = torch.arange(B, device=m.device).view(B, 1, 1) * HW
    out = torch.where(m, lab - base, HW).to(torch.int32)
    return out.reshape(lead + (H, W))


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill interior holes of foreground components, batched [..., H, W].

    Reproduces findContours(RETR_EXTERNAL) + drawContours(filled):
    background not 4-connected to the frame border becomes foreground,
    including components nested inside another component's hole.
    """
    m, lead = _as_batch(mask)
    B, H, W = m.shape
    bg = ~m
    lab = _global_labels(bg, 4)
    border = torch.zeros((H, W), dtype=torch.bool, device=m.device)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    reached = torch.zeros(B * H * W + 1, dtype=torch.bool, device=m.device)
    reached[lab[bg & border]] = True
    ext = bg & reached[lab]
    return (~ext).reshape(lead + (H, W))
