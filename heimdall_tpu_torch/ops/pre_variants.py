"""The preprocess probes: the label kernel's preprocess with one ingredient
swapped.  Counterpart of the Pallas kernels of heimdall_tpu's timing probes
scripts/profile_preprocess.py (its "_roll" stages, S2-roll) and
scripts/profile_pre_variants.py (S3); the port's profilers
(heimdall_tpu_torch/scripts/profile_preprocess.py, profile_pre_variants.py)
run them.

* ``roll_stage``: blur5_roll / mean11_roll / full_roll, the blur5 and f32
  mean11 correlations with wrap-around borders (x[(i + j - r) mod n]:
  deliberately wrong near the edge, a timing probe) and the exact
  morphology; hd_label's encodings (blur5 u8, mean11 0/255, full 0/1).
* ``pre_variant``: the "pre" plane (0/1) of VARIANTS: cur (the exact
  preprocess), roll_conv (rolled interior, exact border band), pair_sym
  (paired Q8 taps), roll_pair (both) and mxu_conv (paired blur, then the f32
  mean11 as two banded matrix products).  All but mxu_conv equal the label
  kernel's "pre" exactly; mxu_conv rounds its mean otherwise, so its
  threshold may flip where the mean lies near a half-integer.
* ``mxu_mean``: mxu_conv's f32 mean11 alone (the two products);
  ``flip_reach`` bounds where mxu_conv's "pre" may differ from its plain
  version's.

Frames are BGR planes [B, 3, H, W] uint8 with H, W >= 6.  On a CUDA tensor
each wrapper launches csrc/pre_variants.cu (hd_pre_variant, hd_mxu_mean) and
raises if it cannot; on a CPU tensor it runs its plain version, below.  A
roll stage or variant is one launch of the one-pass tile preprocess
(csrc/preprocess_tile.cuh), mxu_conv two (its band tables first):
``launches_per_call``.  In that design roll_conv and roll_pair (a rolled
interior with an exact border band) run cur's and pair_sym's instances.
"""

import collections

import torch

from heimdall_tpu_torch.ops import _launch
from heimdall_tpu_torch.ops.color import gray_from_planes
from heimdall_tpu_torch.ops.filters import border_index
from heimdall_tpu_torch.ops.fused_kernels import kernel_taps, preprocess_stage
from heimdall_tpu_torch.ops.morphology import morphology_ex
from heimdall_tpu_torch.ops.split_kernels import check_frames

ROLL_STAGES = ("blur5_roll", "mean11_roll", "full_roll")
# hd_pre_variant's stage of each roll stage (hd_label's numbering)
_ROLL_STAGE_IDS = {"blur5_roll": 1, "mean11_roll": 2, "full_roll": 3}
# name: (border: 0 exact, 1 wrap, 2 unchecked interior + exact border band;
#        paired blur taps; mean as banded tensor-core products)
VARIANTS = {
    "cur": (0, False, False),
    "roll_conv": (2, False, False),
    "pair_sym": (0, True, False),
    "roll_pair": (2, True, False),
    "mxu_conv": (0, True, True),
}


def _taps():
    q8, k11 = kernel_taps()
    return list(q8), list(k11)


def conv_axis(x: torch.Tensor, taps, dim: int, border: str) -> torch.Tensor:
    """Correlation of x with taps along dim, summed in tap order (one
    multiply and one add per tap): border "reflect101" or "replicate" (the
    exact borders), "wrap" (rolls), or "split_reflect101" /
    "split_replicate" (rolls, with the exact sum spliced in where a tap
    leaves the axis, as profile_pre_variants.py's conv_roll does)."""
    n, r = x.shape[dim], len(taps) // 2
    if border.startswith("split_"):
        exact = conv_axis(x, taps, dim, border[len("split_"):])
        rolled = conv_axis(x, taps, dim, "wrap")
        idx = torch.arange(n, device=x.device)
        edge = ((idx < r) | (idx >= n - r)).view(
            (n,) + (1,) * (x.dim() - 1 - dim % x.dim()))
        return torch.where(edge, exact, rolled)
    if border == "wrap":
        terms = (torch.roll(x, r - i, dim) for i in range(len(taps)))
    else:
        xp = x.index_select(dim, border_index(n, r, border, x.device))
        terms = (xp.narrow(dim, i, n) for i in range(len(taps)))
    out = None
    for t, s in zip(taps, terms):
        out = t * s if out is None else out + t * s
    return out


def paired_blur_axis(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """The Q8 blur along dim with paired taps, t2*c + t1*(a+b) + t0*(a'+b')
    (reflect-101; exact in int: equal to conv_axis)."""
    n = x.shape[dim]
    xp = x.index_select(dim, border_index(n, 2, "reflect101", x.device))
    s = [xp.narrow(dim, i, n) for i in range(5)]
    return taps[2] * s[2] + taps[1] * (s[1] + s[3]) + taps[0] * (s[0] + s[4])


def band_matrix(n: int, taps, device="cpu") -> torch.Tensor:
    """T [n, n] float32 of an odd correlation with replicate border, out[c] =
    sum_k x[k] T[k, c]: T[k, c] sums, in tap order, the taps i with
    clamp(c + i - r, 0, n - 1) == k (profile_pre_variants.py:89-96)."""
    r = len(taps) // 2
    T = torch.zeros((n, n), dtype=torch.float32, device=device)
    c = torch.arange(n, device=device)
    for i, t in enumerate(taps):
        k = (c + i - r).clamp(0, n - 1)
        T.index_put_((k, c), torch.full((n,), t, dtype=torch.float32,
                                        device=device), accumulate=True)
    return T


def mxu_mean_reference(blurred: torch.Tensor) -> torch.Tensor:
    """Plain version of hd_mxu_mean: the f32 mean11 of blurred [B, H, W] as
    x @ Tw, then Th^T @ (x @ Tw), with float32 matrix products."""
    H, W = blurred.shape[-2:]
    k11 = _taps()[1]
    x = blurred.to(torch.float32)
    rows = torch.matmul(x, band_matrix(W, k11, x.device))
    return torch.matmul(band_matrix(H, k11, x.device).T, rows)


def flip_reach(mean: torch.Tensor, tol: float) -> torch.Tensor:
    """Where the "pre" planes of two means that lie within tol of ``mean``
    may differ: within 4 pixels (the open's and the close's four 3x3 passes)
    of a pixel whose mean lies within tol of a half-integer, where rint may
    go either way.  mean float32 [B, H, W] -> bool [B, H, W]."""
    near = ((mean - mean.floor() - 0.5).abs() <= tol).to(torch.float32)
    return torch.nn.functional.max_pool2d(near[:, None], 9, 1, 4)[:, 0] > 0


def _threshold_morph(blurred, mf, contrast_threshold, stage):
    binary = torch.where(blurred.to(torch.int32)
                         <= torch.round(mf).to(torch.int32)
                         - int(contrast_threshold), 255, 0).to(torch.uint8)
    if stage == "mean11":
        return binary
    binary = morphology_ex(binary, "open", 3)
    binary = morphology_ex(binary, "close", 3)
    return (binary > 0).to(torch.uint8)


def _blurred(acc):
    return ((acc + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)


def roll_stage_reference(frames: torch.Tensor, contrast_threshold,
                         stage: str) -> torch.Tensor:
    """Plain version of a roll stage: torch.roll correlations."""
    q8, k11 = _taps()
    gray = gray_from_planes(frames[:, 0], frames[:, 1],
                            frames[:, 2]).to(torch.int32)
    blurred = _blurred(conv_axis(conv_axis(gray, q8, -1, "wrap"), q8, -2,
                                 "wrap"))
    if stage == "blur5_roll":
        return blurred
    x = blurred.to(torch.float32)
    mf = conv_axis(conv_axis(x, k11, -1, "wrap"), k11, -2, "wrap")
    return _threshold_morph(blurred, mf, contrast_threshold,
                            "mean11" if stage == "mean11_roll" else "pre")


def pre_variant_reference(frames: torch.Tensor, contrast_threshold,
                          name: str) -> torch.Tensor:
    """Plain version of a variant's "pre" plane (u8 0/1)."""
    border, pair, mma = VARIANTS[name]
    gray = gray_from_planes(frames[:, 0], frames[:, 1], frames[:, 2])
    if name == "cur":
        return preprocess_stage(gray, contrast_threshold)
    gray = gray.to(torch.int32)
    q8, k11 = _taps()
    split = "split_" if border == 2 else ""
    if pair:
        acc = paired_blur_axis(paired_blur_axis(gray, q8, -1), q8, -2)
    else:
        acc = conv_axis(conv_axis(gray, q8, -1, split + "reflect101"), q8,
                        -2, split + "reflect101")
    blurred = _blurred(acc)
    if mma:
        mf = mxu_mean_reference(blurred)
    else:
        x = blurred.to(torch.float32)
        mf = conv_axis(conv_axis(x, k11, -1, split + "replicate"), k11, -2,
                       split + "replicate")
    return _threshold_morph(blurred, mf, contrast_threshold, "pre")


def _check(frames):
    B, H, W = check_frames(frames)
    if H < 6 or W < 6:
        raise ValueError(f"the preprocess probes take frames of at least "
                         f"6x6, got {H}x{W}")
    return B, H, W


def launches_per_call(name: str) -> int:
    """CUDA kernels one call of a roll stage or variant launches: the tile
    preprocess, and for mxu_conv its band tables first."""
    return 2 if VARIANTS.get(name, (0, False, False))[2] else 1


def _launch_variant(frames, contrast_threshold, stage_id, border, pair, mma):
    from heimdall_tpu_torch.ops import _cuda

    _launch.check_cuda(frames, "frames", (torch.uint8,))
    B, _, H, W = frames.shape
    dev = frames.device
    out = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    band = (torch.empty((11 * (H + W),), dtype=torch.float32, device=dev)
            if mma else None)
    q8, k11 = kernel_taps()
    err = _cuda.library("pre_variants").hd_pre_variant(
        frames.data_ptr(), B, H, W, int(contrast_threshold), stage_id,
        border, int(pair), int(mma), q8, k11, out.data_ptr(),
        None if band is None else band.data_ptr(), _launch.stream(frames))
    _launch.raise_on(err, "pre_variant")
    return out


def roll_stage(frames: torch.Tensor, contrast_threshold,
               stage: str) -> torch.Tensor:
    """A roll stage of ROLL_STAGES: frames [B, 3, H, W] uint8 -> [B, H, W]
    uint8 (blur5_roll: the blur; mean11_roll: 0/255; full_roll: 0/1).
    ``roll_stage.launches`` counts kernel launches and
    ``roll_stage.stage_launches`` counts them by stage."""
    if stage not in ROLL_STAGES:
        raise ValueError(f"stage must be one of {ROLL_STAGES}, got {stage!r}")
    _check(frames)
    if frames.device.type == "cpu":
        return roll_stage_reference(frames, contrast_threshold, stage)
    out = _launch_variant(frames, contrast_threshold, _ROLL_STAGE_IDS[stage],
                          1, False, False)
    roll_stage.launches += 1
    roll_stage.stage_launches[stage] += 1
    return out


roll_stage.launches = 0
roll_stage.stage_launches = collections.Counter()


def pre_variant(frames: torch.Tensor, contrast_threshold,
                name: str) -> torch.Tensor:
    """The "pre" plane (u8 0/1 [B, H, W]) of the variant ``name`` of
    VARIANTS.  ``pre_variant.launches`` counts kernel launches and
    ``pre_variant.variant_launches`` counts them by variant."""
    if name not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got "
                         f"{name!r}")
    _check(frames)
    if frames.device.type == "cpu":
        return pre_variant_reference(frames, contrast_threshold, name)
    out = _launch_variant(frames, contrast_threshold, 3, *VARIANTS[name])
    pre_variant.launches += 1
    pre_variant.variant_launches[name] += 1
    return out


pre_variant.launches = 0
pre_variant.variant_launches = collections.Counter()


def mxu_mean(blurred: torch.Tensor) -> torch.Tensor:
    """mxu_conv's f32 mean11 of blurred uint8 [B, H, W] (H, W >= 6), the two
    banded products -> float32 [B, H, W].  ``mxu_mean.launches`` counts
    kernel launches."""
    if (blurred.dtype != torch.uint8 or blurred.dim() != 3
            or min(blurred.shape[1:]) < 6):
        raise ValueError(f"blurred must be uint8 [B, H, W] with H, W >= 6, "
                         f"got {blurred.dtype} {tuple(blurred.shape)}")
    if blurred.device.type == "cpu":
        return mxu_mean_reference(blurred)
    from heimdall_tpu_torch.ops import _cuda

    _launch.check_cuda(blurred, "blurred", (torch.uint8,))
    B, H, W = _launch.check_mask(blurred)
    work, mean = (torch.empty((B, H, W), dtype=torch.float32,
                              device=blurred.device) for _ in range(2))
    band = torch.empty((11 * (H + W),), dtype=torch.float32,
                       device=blurred.device)
    err = _cuda.library("pre_variants").hd_mxu_mean(
        blurred.data_ptr(), B, H, W, kernel_taps()[1], band.data_ptr(),
        work.data_ptr(), mean.data_ptr(), _launch.stream(blurred))
    _launch.raise_on(err, "mxu_mean")
    mxu_mean.launches += 1
    return mean


mxu_mean.launches = 0
