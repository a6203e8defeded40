"""The joint probe: hole fill and 8-connected labels from one dual-class
fixpoint over one value plane.  Counterpart of the Pallas kernel of
heimdall_tpu's timing probe scripts/profile_joint_variants.py (S6; the
labeling is pallas_kernels.py::_label_flood_joint); the port's profiler
heimdall_tpu_torch/scripts/profile_joint_variants.py runs it.

The plane v holds on foreground its label, on background 0 once reached
from the frame border, OFFSET + L in a hole (L the least label next to it)
and INF0 = OFFSET + H*W when nothing has reached it.  A phase is the
exchange (each class takes the min of its candidates: foreground over its
foreground 8-neighbours; background over its background 4-neighbours and
OFFSET + its foreground 4-neighbours), then the min over each class run of
the row or column by packed doubling scans.  Loop 1 runs row, column, row
units until one exchange lowers nothing; loop 2 then lets foreground read
hole-carried labels, which merges islands in holes with their enclosing
component.  The labels are the label kernel's "ccl" stage and the filled
mask its "fill" stage, for every variant.

VARIANTS are (row ladder steps or None for whole rows, column ladder
steps), scripts/profile_joint_variants.py:134-139.  Masks are u8 [B, H, W]
(nonzero = foreground) with H, W <= 1024 and H*W < 2^19.  On a CUDA tensor
``joint_mask`` launches csrc/joint_label.cu (hd_joint_label) and raises if
it cannot, on the cluster path wherever a block's band of the planes and
mask rows fits its shared memory and on the global path elsewhere
(ops/ccl_sweeps.py::choose_path; ``path`` asks for one, ``.last_path``
names the last call's); on a CPU tensor it runs the plain version.  ``joint_label`` is
the probe as the profiler runs it: the label kernel's "pre" stage, then
``joint_mask``.  ``classic_label`` is the probe's "classic": the sweep fill
then the sweep CCL "cur"; ``joint_detect`` is its full detect with the
joint labels.
"""

import collections

import torch

from heimdall_tpu_torch.ops import _launch
from heimdall_tpu_torch.ops.blobs import table_from_sums
from heimdall_tpu_torch.ops.ccl_sweeps import (ccl_mask, choose_path,
                                               packed_big, sweep_phase_fits)
from heimdall_tpu_torch.ops.fill_sweeps import (MAX_LINE, fill_sweeps,
                                                ladder_steps, run_min, shift)
from heimdall_tpu_torch.ops.fused_kernels import gate
from heimdall_tpu_torch.ops.split_kernels import (check_frames, label_kernel,
                                                  label_kernel_reference,
                                                  stats_kernel)

VARIANTS = {
    "rowFull_col5": (None, 5),
    "rowFull_col4": (None, 4),
    "rowFull_col6": (None, 6),
    "row7_col5": (7, 5),
}
OFFSET = 1 << 19
CPEN = 1 << 26           # class penalty: above every value, 2^26 + 2^30 < 2^31
_PEN = 1 << 30           # a neighbour outside the frame


def class_run_count(cls: torch.Tensor, dim: int) -> torch.Tensor:
    """Number of class runs (maximal stretches of one class) that start at
    or before each position along dim, int32; position 0 starts one."""
    start = cls != shift(cls, 1, dim, -1)
    return start.cumsum(dim, dtype=torch.int32)


def _check_plane(H, W):
    inf0 = OFFSET + H * W
    if (H > MAX_LINE or W > MAX_LINE or H * W >= OFFSET
            or max(W, H) * packed_big(inf0) + inf0 >= 1 << 30
            or not sweep_phase_fits(W, H)):
        raise ValueError(f"the joint probe takes masks of fewer than 2^19 "
                         f"px and at most {MAX_LINE} px a side, got {H}x{W}")


def joint_mask_reference(mask: torch.Tensor, variant: str = "rowFull_col5"):
    """Plain version of joint_mask: (labels int32 [B, H, W], filled u8
    [B, H, W]).  Every frame runs the loops until all of them are done."""
    ss_row, ss_col = VARIANTS[variant]
    fg = mask != 0
    B, H, W = fg.shape
    S = H * W
    inf0 = OFFSET + S
    big = packed_big(inf0)
    c = fg.to(torch.int32)
    lin = torch.arange(S, dtype=torch.int32, device=fg.device).view(H, W)
    border = torch.zeros((H, W), dtype=torch.bool, device=fg.device)
    border[0] = border[-1] = True
    border[:, 0] = border[:, -1] = True
    v = torch.where(fg, lin, torch.where(border, 0, inf0)).to(torch.int32)
    rb = {-1: class_run_count(c, -1) * big, -2: class_run_count(c, -2) * big}
    steps = {-1: min(ss_row or W, ladder_steps(W)),
             -2: min(ss_col, ladder_steps(H))}

    def lane3(x):
        return torch.minimum(x, torch.minimum(shift(x, 1, -1, _PEN),
                                              shift(x, -1, -1, _PEN)))

    def vert(x):
        return torch.minimum(shift(x, 1, -2, _PEN), shift(x, -1, -2, _PEN))

    def exchange(v, feedback):
        vf = v + (1 - c) * CPEN
        lm = lane3(vf)
        c_fg = torch.minimum(lm, vert(lm))
        c_bg = torch.minimum(torch.minimum(lm, vert(vf)) + OFFSET,
                             vert(v + c * CPEN))
        if feedback:
            lh = lane3(torch.where(~fg & (v >= OFFSET), v, CPEN))
            c_fg = torch.minimum(c_fg, torch.minimum(lh, vert(lh)) - OFFSET)
        return torch.minimum(v, torch.where(fg, c_fg, c_bg))

    def unit(v, feedback):
        for dim in (-1, -2, -1):
            v = run_min(exchange(v, feedback), rb[dim], dim, steps[dim])
        return v

    def more(v, feedback):
        return bool((exchange(v, feedback) < v).any())

    v = unit(v, False)
    while more(v, False):
        v = unit(v, False)
    while more(v, True):
        v = unit(v, True)
    hole = ~fg & (v >= OFFSET)
    labels = torch.where(fg, v, torch.where(hole, v - OFFSET, S))
    return labels.to(torch.int32), (fg | hole).to(torch.uint8)


def joint_mask(mask: torch.Tensor, variant: str = "rowFull_col5",
               path=None):
    """(labels int32 [B, H, W], filled u8 [B, H, W]) of mask u8 [B, H, W]
    by the joint fixpoint of ``variant`` (one of VARIANTS), on the path
    ``path`` ("cluster", "global", or None: by shape).
    ``joint_mask.launches`` counts kernel launches,
    ``joint_mask.variant_launches`` counts them by variant and
    ``joint_mask.last_path`` names the last call's path."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got "
                         f"{variant!r}")
    B, H, W = _launch.check_mask(mask)
    _check_plane(H, W)
    path, layout = choose_path(H, W, mask=True, path=path)
    if mask.device.type == "cpu":
        joint_mask.last_path = "plain"
        return joint_mask_reference(mask, variant)
    from heimdall_tpu_torch.ops import _cuda

    _launch.check_cuda(mask, "mask", (torch.uint8,))
    ss_row, ss_col = VARIANTS[variant]
    dev = mask.device
    rb_r, rb_t = (torch.empty((B, H, W), dtype=torch.int16, device=dev)
                  for _ in range(2))
    pa, pb = ((torch.empty((B, H, W), dtype=torch.int32, device=dev)
               for _ in range(2)) if path == "global" else (None, None))
    labels = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    filled = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    err = _cuda.library("joint_label").hd_joint_label(
        mask.data_ptr(), B, H, W, ss_row or 0, ss_col,
        *(layout or (0, 0)), rb_r.data_ptr(), rb_t.data_ptr(),
        pa if pa is None else pa.data_ptr(),
        pb if pb is None else pb.data_ptr(), labels.data_ptr(),
        filled.data_ptr(), _launch.stream(mask))
    _launch.raise_on(err, "joint_label")
    joint_mask.launches += 1
    joint_mask.variant_launches[variant] += 1
    joint_mask.last_path = path
    return labels, filled


joint_mask.launches = 0
joint_mask.variant_launches = collections.Counter()
joint_mask.last_path = None


def joint_label_reference(frames: torch.Tensor, contrast_threshold,
                          variant: str = "rowFull_col5"):
    """Plain version of joint_label."""
    return joint_mask_reference(
        label_kernel_reference(frames, contrast_threshold, "pre"), variant)


def joint_label(frames: torch.Tensor, contrast_threshold,
                variant: str = "rowFull_col5"):
    """The probe as scripts/profile_joint_variants.py runs it: frames [B, 3,
    H, W] uint8 -> the label kernel's "pre" stage -> joint_mask(variant):
    (labels, filled)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got "
                         f"{variant!r}")
    check_frames(frames)
    return joint_mask(label_kernel(frames, contrast_threshold, "pre"),
                      variant)


def classic_label(frames: torch.Tensor, contrast_threshold):
    """The probe's "classic": the sweep fill (fill_sweeps "new"), then the
    sweep CCL "cur": (labels, filled)."""
    filled = fill_sweeps(frames, contrast_threshold, "new")
    return ccl_mask(filled, "cur"), filled


def joint_detect(frames: torch.Tensor, contrast_threshold, min_size,
                 max_size, min_confidence, max_blobs: int = 64,
                 variant: str = "rowFull_col5"):
    """The full detect with the joint labels (profile_joint_variants.py
    :147-167): joint_label -> stats_kernel -> table_from_sums -> the
    gates.  Returns (BlobTable, confidence [B, K], accepted [B, K]), as
    fused_detect does on channel-major frames."""
    labels, _ = joint_label(frames, contrast_threshold, variant)
    table = table_from_sums(*stats_kernel(frames, labels, max_blobs))
    return (table,) + gate(table, min_size, max_size, min_confidence)

