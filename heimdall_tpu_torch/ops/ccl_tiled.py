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
  one background union-find over the frame — no rounds, no host sync;
* ``band_ccl`` (B5a): labels within bands of ``band`` rows, with global
  indices, and each band's first ``roots_cap`` roots and root count;
* ``merge_bands`` (the XLA merge between the TPU kernels): joins the bands
  (in place on the card), then the root table, the root count and the slot
  incidence.

Each counts its kernel launches in ``.launches``.  Planes are [B, H, W]
and unpadded: the last band may be shorter than ``band``.
"""

import torch

from heimdall_tpu_torch.ops.ccl import connected_components, fill_holes

# Static shared-memory tables of hd_merge_bands hold at most this many slots.
MAX_SLOTS = 1024


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(t: torch.Tensor, name: str, dtypes, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {dtypes}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_mask(mask: torch.Tensor):
    """(B, H, W) of a plane batch within the kernels' index range."""
    if mask.dim() != 3:
        raise ValueError(f"planes must be [B, H, W], got {tuple(mask.shape)}")
    B, H, W = mask.shape
    if not (1 <= B <= 65535 and H >= 1 and W >= 1 and H * W < 2**31 - 1):
        raise ValueError(f"unsupported shape B={B} H={H} W={W}")
    return B, H, W


def _raise_on(err: int, what: str):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------- hole fill

def flood_reference(mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of hd_flood_fill: the filled bool mask."""
    return fill_holes(mask.to(torch.bool))


def flood_fill(mask: torch.Tensor) -> torch.Tensor:
    """Filled mask (bool [B, H, W]) of a bool or uint8 (nonzero = fg) mask."""
    B, H, W = _check_mask(mask)
    if mask.device.type == "cpu":
        return flood_reference(mask)
    from heimdall_tpu_torch.ops import _cuda

    _check_cuda(mask, "mask", (torch.bool, torch.uint8))
    dev = mask.device
    parent = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    reach = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    filled = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    _raise_on(_cuda.library("ccl_tiled").hd_flood_fill(
        mask.data_ptr(), B, H, W, parent.data_ptr(), reach.data_ptr(),
        filled.data_ptr(), _stream(mask)), "flood_fill")
    flood_fill.launches += 1
    return filled


flood_fill.launches = 0


# ------------------------------------------------------- band-local labels

def _first_roots(keys: torch.Tensor, cap: int, sentinel: int) -> torch.Tensor:
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
    B, H, W = _check_mask(mask)
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
    roots = _first_roots(torch.where(is_root, lin, HW), roots_cap, HW)
    return (lab.to(torch.int32), roots.to(torch.int32),
            is_root.sum(-1).to(torch.int32))


def band_ccl(mask: torch.Tensor, band: int, connectivity: int = 8,
             roots_cap: int = 128):
    """Band-local labels, band root tables and counts of a bool or uint8
    mask [B, H, W] (see band_ccl_reference)."""
    B, H, W = _check_mask(mask)
    if connectivity not in (4, 8) or band < 1 or roots_cap < 1:
        raise ValueError(f"unsupported connectivity={connectivity} "
                         f"band={band} roots_cap={roots_cap}")
    if mask.device.type == "cpu":
        return band_ccl_reference(mask, band, connectivity, roots_cap)
    from heimdall_tpu_torch.ops import _cuda

    _check_cuda(mask, "mask", (torch.bool, torch.uint8))
    R = -(-H // band)
    if R > 65535:
        raise ValueError(f"{R} bands exceed the kernel's grid")
    dev = mask.device
    labels = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    roots = torch.empty((B, R, roots_cap), dtype=torch.int32, device=dev)
    counts = torch.empty((B, R), dtype=torch.int32, device=dev)
    _raise_on(_cuda.library("ccl_tiled").hd_band_ccl(
        mask.data_ptr(), B, H, W, band, connectivity, roots_cap,
        labels.data_ptr(), roots.data_ptr(), counts.data_ptr(),
        _stream(mask)), "band_ccl")
    band_ccl.launches += 1
    return labels, roots, counts


band_ccl.launches = 0


# ------------------------------------------------------------------- merge

def _root_table(labels: torch.Tensor, max_blobs: int):
    """(first K roots in raster order, padded with H*W, int32 [B, K];
    root count int32 [B]) of a label plane [B, H, W]."""
    B, H, W = labels.shape
    HW = H * W
    lab = labels.reshape(B, HW).to(torch.int64)
    lin = torch.arange(HW, device=labels.device)
    is_root = lab == lin
    rl = _first_roots(torch.where(is_root, lin, HW), max_blobs, HW)
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


def _slot_incidence(labels: torch.Tensor, rl: torch.Tensor,
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
    return (lab, rl, n) + _slot_incidence(lab, rl, n, band)


def merge_bands(labels: torch.Tensor, band_roots: torch.Tensor,
                counts: torch.Tensor, band: int, connectivity: int = 8,
                max_blobs: int = 64):
    """Join band_ccl's outputs across bands (see merge_reference).  On the
    card ``labels`` is updated in place and returned."""
    B, H, W = _check_mask(labels)
    R = -(-H // band)
    K = max_blobs
    if connectivity not in (4, 8) or band < 1 or not 1 <= K <= MAX_SLOTS:
        raise ValueError(f"unsupported connectivity={connectivity} "
                         f"band={band} max_blobs={K} (1..{MAX_SLOTS})")
    if labels.device.type == "cpu":
        return merge_reference(labels, band_roots, counts, band,
                               connectivity, K)
    from heimdall_tpu_torch.ops import _cuda

    cap = band_roots.shape[-1]
    _check_cuda(labels, "labels", (torch.int32,))
    _check_cuda(band_roots, "band_roots", (torch.int32,), (B, R, cap))
    _check_cuda(counts, "counts", (torch.int32,), (B, R))
    dev = labels.device
    rl = torch.empty((B, K), dtype=torch.int32, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    slot_list = torch.empty((B, R, K), dtype=torch.int32, device=dev)
    slot_count = torch.empty((B, R), dtype=torch.int32, device=dev)
    _raise_on(_cuda.library("ccl_tiled").hd_merge_bands(
        B, H, W, band, connectivity, cap, K, labels.data_ptr(),
        band_roots.data_ptr(), counts.data_ptr(), rl.data_ptr(),
        n.data_ptr(), slot_list.data_ptr(), slot_count.data_ptr(),
        _stream(labels)), "merge_bands")
    merge_bands.launches += 1
    return labels, rl, n, slot_list, slot_count


merge_bands.launches = 0


# -------------------------------------------------------------- public API

def _unpad(mask: torch.Tensor, band: int, frame_h):
    """The real rows of a mask given in the padded layout of frame_h."""
    if frame_h is None:
        return mask
    if mask.shape[1] != -(-frame_h // band) * band:
        raise ValueError(f"a padded mask of {frame_h} rows has "
                         f"{-(-frame_h // band) * band} rows at band {band}, "
                         f"got {mask.shape[1]}")
    return mask[:, :frame_h].contiguous()


def _pad(x: torch.Tensor, rows: int, value) -> torch.Tensor:
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
    filled = flood_fill(_unpad(m, band, frame_h))
    filled = _pad(filled, m.shape[1], False)
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
    real = _unpad(m, band, frame_h)
    K = max(return_roots, 1)
    lab, roots, counts = band_ccl(real, band, connectivity, max(K, 128))
    lab, rl, n, sl, sc = merge_bands(lab, roots, counts, band, connectivity,
                                     K)
    lab = _pad(lab, m.shape[1], real.shape[1] * real.shape[2])
    out = (lab,)
    if return_roots:
        out += (rl, n) + ((sl, sc) if band_slots else ())
    if squeeze:
        out = tuple(t[0] for t in out)
    return out[0] if len(out) == 1 else out
