"""The port's split kernels (ops/split_kernels.py) against heimdall_tpu's.

1. label_kernel_reference and stats_kernel_reference (the plain PyTorch
   versions of hd_label and hd_stats_from_labels) against the Pallas label
   kernel (_make_label_kernel, B6b) and stats kernel (_make_stats_kernel,
   B6a), built here with pl.pallas_call(..., interpret=True) as
   scripts/profile_fused.py builds them, at 64x128 on 16 frames: the bench
   cases of tests/test_torch_fused.py plus the geometry of
   scripts/check_joint_label.py (nested islands in holes, a spiral,
   border-touching blobs, a U beside an O, a dark frame edge, an empty
   frame; and a uniform frame at contrast -15, whose foreground is full).
   B6b at the shipped settings, at profile_fused's rt_fill=12 / rt_ccl=8
   and with joint=True: the port takes none of these TPU settings and gives
   the same labels for all of them.  B6a also on label planes whose
   labels need not name a root (scene.non_root_labels): a pixel takes the
   slot of the root its label names, or none; and on
   scene.stats_case_labels at 24x32, 13x17 and 3x3 with K 1 and 5 (the
   K-th root mid-row, roots past K, every pixel a root, ...).
2. The label kernel's stages against the profilers' truncated kernels,
   built as scripts/profile_fused.py (pre / fill / ccl) and
   scripts/profile_preprocess.py (gray / blur5 / mean11 / full) build them.
3. At 640x480 on the bench scene, the stages against the XLA ops, and
   stats(label(x)) against the fused kernel's plain version and the XLA
   program's table.

Everything compared is an integer plane, a label plane or an integer
table: tolerance 0 (the XLA table's float fields within 1e-6, as in
tests/test_torch_fused.py).  The CUDA kernels are held against these plain
versions on the card by tests/test_torch_split_cuda.py and chip_smoke.py.
JAX outputs are computed once per file (cached).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from heimdall_tpu import ops as jops
from heimdall_tpu.detectors.contamination_detector import (
    contamination_program)
from heimdall_tpu.ops import filters as jfilters
from heimdall_tpu.ops import pallas_kernels as pk
from heimdall_tpu.ops.pallas_kernels import contamination_pallas

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import split_kernels as sk
from heimdall_tpu_torch.ops.blobs import table_from_sums
from heimdall_tpu_torch.ops.fused_kernels import (
    MAX_FRAME_PX, contamination_fused_reference, kernel_taps)

from test_torch_fused import CASES as FUSED_CASES

CT = 15
SETTINGS = {
    "shipped": dict(sweeps=2, adaptive=True, scan_steps=5, rt_ccl=6,
                    rt_fill=10),
    "profile_fused": dict(sweeps=2, adaptive=True, scan_steps=5, rt_ccl=8,
                          rt_fill=12),
    "joint": dict(sweeps=2, adaptive=True, scan_steps=5, joint=True),
}


def _geometry(H=64, W=128):
    """The masks of scripts/check_joint_label.py at 64x128, by name."""
    yy, xx = np.mgrid[0:H, 0:W]

    def disc(cy, cx, r2):
        return (yy - cy) ** 2 + (xx - cx) ** 2 <= r2

    def ring(cy, cx, r0, r1):
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        return (d2 >= r0 * r0) & (d2 <= r1 * r1)

    nested = (ring(32, 40, 18, 21) | ring(32, 40, 8, 11) | disc(32, 40, 9)
              | disc(20, 100, 36))
    spiral = np.zeros((H, W), bool)
    t = np.linspace(0, 6 * np.pi, 3000)
    r = 2 + t * 1.4
    sy = np.clip((32 + r * np.sin(t)).astype(int), 0, H - 1)
    sx = np.clip((64 + r * np.cos(t)).astype(int), 0, W - 1)
    spiral[sy, sx] = spiral[sy, np.clip(sx + 1, 0, W - 1)] = True
    borders = np.zeros((H, W), bool)
    borders[0:6, 20:40] = borders[-6:, 60:90] = True
    borders[25:40, 0:6] = borders[10:26, -5:] = True
    borders[44:56, 30:54] = np.indices((12, 24)).sum(0) % 2 == 1
    u_o = np.zeros((H, W), bool)
    u_o[12:52, 10:13] = u_o[12:52, 38:41] = u_o[49:52, 10:41] = True
    u_o[12:52, 70:73] = u_o[12:52, 100:103] = True
    u_o[12:15, 70:103] = u_o[49:52, 70:103] = True
    ring = np.zeros((H, W), bool)          # a dark frame edge
    ring[:3] = ring[-3:] = True
    ring[:, :3] = ring[:, -3:] = True
    return {"nested": nested, "spiral": spiral, "borders_checker": borders,
            "u_beside_o": u_o, "frame_edge": ring,
            "empty": np.zeros((H, W), bool)}


GEOMETRY = _geometry()
NAMES = [f"{case}{i}" for case in sorted(FUSED_CASES) for i in range(2)] + \
    list(GEOMETRY)
FRAMES = np.ascontiguousarray(np.concatenate(
    [FUSED_CASES[c] for c in sorted(FUSED_CASES)]
    + [scene.mask_frames(list(GEOMETRY.values()))]).transpose(0, 3, 1, 2))
B, _, H, W = FRAMES.shape


def _pallas(kernel, n_in, outs, dtype=jnp.int32):
    """pallas_call of a per-frame kernel over FRAMES (and, with n_in = 2,
    the label planes), in interpret mode, as scripts/profile_fused.py
    launches its kernels; every output of ``dtype``."""
    in_specs = [pl.BlockSpec((1, 3, H, W), lambda i, c: (i, 0, 0, 0),
                             memory_space=pltpu.VMEM)]
    if n_in == 2:
        in_specs.append(pl.BlockSpec((1, H, W), lambda i, c: (i, 0, 0),
                                     memory_space=pltpu.VMEM))
    out_specs = [pl.BlockSpec((1,) + s, lambda i, c, n=len(s): (i,) +
                              (0,) * n, memory_space=pltpu.VMEM)
                 for s in outs]
    gs = pltpu.PrefetchScalarGridSpec(num_scalar_prefetch=1, grid=(B,),
                                      in_specs=in_specs, out_specs=out_specs)
    return pl.pallas_call(
        kernel, grid_spec=gs,
        out_shape=tuple(jax.ShapeDtypeStruct((B,) + s, dtype)
                        for s in outs),
        interpret=True)


def _ct():
    return jnp.asarray(CT, jnp.int32).reshape(1)


@functools.lru_cache(maxsize=None)
def _jax_labels(setting):
    kernel = pk._make_label_kernel(H, W, 64, **SETTINGS[setting])
    return np.asarray(_pallas(kernel, 1, [(H, W)])(_ct(),
                                                   jnp.asarray(FRAMES))[0])


def _pallas_stats(labels, k):
    """The Pallas stats kernel (B6a) on FRAMES and label planes ``labels``."""
    call = _pallas(pk._make_stats_kernel(H, W, k), 2,
                   [(pk.N_SUMS, k), (4, k), (4, k), (1, 1)])
    out = call(_ct(), jnp.asarray(FRAMES), jnp.asarray(labels))
    sums, bbox, bgsum, meta = (np.asarray(o) for o in out)
    return sums, bbox, bgsum, meta[:, 0, 0]


@functools.lru_cache(maxsize=None)
def _jax_stats(k):
    return _pallas_stats(_jax_labels("shipped"), k)


_TAPS5 = jfilters._q8_taps(jfilters.gaussian_kernel_1d(5, 0.0))
_K11 = [float(t) for t in jfilters.gaussian_kernel_1d(11, 0.0)]


def _gray_of(frame_ref):
    b = frame_ref[0, 0].astype(jnp.int32)
    g = frame_ref[0, 1].astype(jnp.int32)
    r = frame_ref[0, 2].astype(jnp.int32)
    return (b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15


def _s2_planes(ct_ref, frame_ref, stage):
    """scripts/profile_preprocess.py's exact stages (int32 planes)."""
    gray = _gray_of(frame_ref)
    if stage == "gray":
        return gray
    acc = pk._conv_axis(pk._conv_axis(gray, _TAPS5, 1, "reflect101"),
                        _TAPS5, 0, "reflect101")
    blurred = jnp.clip((acc + (1 << 15)) >> 16, 0, 255)
    if stage == "blur5":
        return blurred
    mf = pk._conv_axis(pk._conv_axis(blurred.astype(jnp.float32), _K11, 1,
                                     "replicate"), _K11, 0, "replicate")
    mean = jnp.rint(mf).astype(jnp.int32)
    binary = jnp.where(blurred <= mean - ct_ref[0], 255, 0)
    if stage == "mean11":
        return binary
    binary = pk._minmax3(pk._minmax3(binary, True), False)
    return pk._minmax3(pk._minmax3(binary, False), True)


def _s1_planes(ct_ref, frame_ref, stage):
    """scripts/profile_fused.py's truncations (run-table fill and CCL at
    rt_fill=12, rt_ccl=8)."""
    row_idx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    col_idx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    fg0 = (_s2_planes(ct_ref, frame_ref, "full") > 0).astype(jnp.int32)
    if stage == "pre":
        return fg0
    border = ((row_idx == 0) | (row_idx == H - 1) | (col_idx == 0)
              | (col_idx == W - 1)).astype(jnp.int32)
    fg = pk._fill_runtable(fg0, border, Rmax=12)
    if stage == "fill":
        return fg
    lin = row_idx * W + col_idx
    return pk._ccl_runtable(jnp.where(fg > 0, lin, H * W), fg, H * W, Rmax=8)


@functools.lru_cache(maxsize=None)
def _jax_stage(script, stage):
    body = _s1_planes if script == "profile_fused" else _s2_planes

    def kernel(ct_ref, frame_ref, out_ref):
        out_ref[0] = body(ct_ref, frame_ref, stage)

    return np.asarray(_pallas(kernel, 1, [(H, W)])(_ct(),
                                                   jnp.asarray(FRAMES))[0])


@functools.lru_cache(maxsize=None)
def _port(stage):
    return sk.label_kernel_reference(torch.from_numpy(FRAMES), CT,
                                     stage).numpy()


def _assert_frames_equal(want, got):
    for i, name in enumerate(NAMES):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_label_kernel_matches_pallas(setting):
    got = _port("ccl")
    assert got.dtype == np.int32
    _assert_frames_equal(_jax_labels(setting), got)


@pytest.mark.parametrize("script,stage", [
    ("profile_fused", "pre"), ("profile_fused", "fill"),
    ("profile_fused", "ccl"), ("profile_preprocess", "gray"),
    ("profile_preprocess", "blur5"), ("profile_preprocess", "mean11"),
    ("profile_preprocess", "full")])
def test_stages_match_profiler_kernels(script, stage):
    got = _port("pre" if stage == "full" else stage)
    assert got.dtype == (np.int32 if stage == "ccl" else np.uint8)
    if stage == "full":                 # the profiler keeps 255 for fg
        got = got.astype(np.int32) * 255
    _assert_frames_equal(_jax_stage(script, stage), got)


@pytest.mark.parametrize("k", [64, 4])
def test_stats_kernel_matches_pallas(k):
    want = _jax_stats(k)
    x = torch.from_numpy(FRAMES)
    for labels in (torch.from_numpy(_jax_labels("shipped").copy()),
                   sk.label_kernel(x, CT)):
        got = sk.stats_kernel(x, labels, k)
        for name, a, b in zip(("sums", "bbox", "bgsum", "n"), want, got):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert (want[3] > 4).any()          # K = 4 drops blobs past the 4th


@pytest.mark.parametrize("k", [64, 4])
def test_stats_kernel_on_non_root_labels_matches_pallas(k):
    """A label plane whose labels need not name a root (relabelled to a
    background pixel's index, to a non-root pixel, a root moved into
    another slot, members above their root's row): a pixel takes the slot
    of the root its label names or none, y0 is the root's row."""
    labels = scene.non_root_labels(
        torch.from_numpy(_jax_labels("shipped").copy()))
    assert not np.array_equal(labels.numpy(), _jax_labels("shipped"))
    want = _pallas_stats(labels.numpy(), k)
    got = sk.stats_kernel(torch.from_numpy(FRAMES), labels, k)
    for name, a, b in zip(("sums", "bbox", "bgsum", "n"), want, got):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert not np.array_equal(want[0], _jax_stats(k)[0])


def _pallas_stats_small(frames, labels, k):
    """The Pallas stats kernel (B6a) in interpret mode on BGR planes
    [n, 3, h, w] and label planes [n, h, w] of any small size."""
    n, _, h, w = frames.shape
    in_specs = [pl.BlockSpec((1, 3, h, w), lambda i, c: (i, 0, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, h, w), lambda i, c: (i, 0, 0),
                             memory_space=pltpu.VMEM)]
    outs = [(pk.N_SUMS, k), (4, k), (4, k), (1, 1)]
    out_specs = [pl.BlockSpec((1,) + s, lambda i, c, d=len(s): (i,) +
                              (0,) * d, memory_space=pltpu.VMEM)
                 for s in outs]
    gs = pltpu.PrefetchScalarGridSpec(num_scalar_prefetch=1, grid=(n,),
                                      in_specs=in_specs, out_specs=out_specs)
    call = pl.pallas_call(
        pk._make_stats_kernel(h, w, k), grid_spec=gs,
        out_shape=tuple(jax.ShapeDtypeStruct((n,) + s, jnp.int32)
                        for s in outs),
        interpret=True)
    sums, bbox, bgsum, meta = (np.asarray(o) for o in call(
        _ct(), jnp.asarray(frames), jnp.asarray(labels)))
    return sums, bbox, bgsum, meta[:, 0, 0]


@pytest.mark.parametrize("size", [(24, 32), (13, 17), (3, 3)],
                         ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("k", [1, 5])
def test_stats_kernel_on_stats_cases_matches_pallas(size, k):
    """B6a on scene.stats_case_labels: the K-th root in the middle of a
    row with the (K+1)-th beside it, more roots than K, a root in the last
    row, every pixel a root, labels naming non-roots and roots ranked K or
    later, empty and full planes; against the Pallas stats kernel."""
    labels = np.stack(list(scene.stats_case_labels(*size, k, seed=1)
                           .values()))
    frames = scene.stats_case_frames(len(labels), *size, seed=2)
    want = _pallas_stats_small(frames, labels, k)
    got = sk.stats_kernel(torch.from_numpy(frames), torch.from_numpy(labels),
                          k)
    for name, a, b in zip(("sums", "bbox", "bgsum", "n"), want, got):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert (want[3] > k).any()            # slots past K dropped


def test_label_stats_bytes_counts_the_windows():
    """B6a's byte bound (scripts/profile_stats_fill.py, also chip_smoke.py's
    phase 5d): the label plane, 3 frame bytes of each pixel in the union of
    the used slots' bbox windows (an overlap once, no slot past min(n, K))
    and the tables."""
    from heimdall_tpu_torch.scripts.profile_stats_fill import (
        label_stats_bytes)
    labels = torch.zeros((2, 6, 8), dtype=torch.int32)
    bbox = torch.zeros((2, 4, 3), dtype=torch.int32)
    # frame 0, x0 y0 x1 y1: 3x3 and 4x4 sharing 2x2, then one pixel
    bbox[0] = torch.tensor([[1, 2, 7], [0, 1, 5], [3, 5, 7], [2, 4, 5]])
    bbox[1] = 1                          # frame 1 has no blob
    n = torch.tensor([4, 0], dtype=torch.int32)
    assert label_stats_bytes(labels, (None, bbox, None, n)) == (
        2 * 6 * 8 * 4 + (9 + 16 - 4 + 1) * 3 + 2 * (16 * 3 + 1) * 4)


def test_profile_stats_fill_needs_a_card(monkeypatch):
    from heimdall_tpu_torch.scripts import profile_stats_fill
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_stats_fill.main([])
    with pytest.raises(SystemExit, match="usage"):
        profile_stats_fill.main(["x"])


@pytest.mark.parametrize("k", [64, 4])
def test_split_equals_fused_kernel(k):
    """B6a(B6b(x)) is B1(x): in the port, and against the Pallas B1."""
    x = torch.from_numpy(FRAMES)
    got = sk.stats_kernel(x, sk.label_kernel(x, CT), k)
    fused = contamination_fused_reference(x, CT, k, channel_major=True)
    pallas = contamination_pallas(jnp.asarray(FRAMES), CT, max_blobs=k,
                                  channel_major=True, interpret=True,
                                  **SETTINGS["shipped"])
    for name, a, b, c in zip(("sums", "bbox", "bgsum", "n"), got, fused,
                             pallas):
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=name)


def test_empty_and_full_frames():
    """A uniform frame has no foreground at contrast 15 and is all
    foreground at contrast -15 (blurred <= mean + 15 everywhere): no blob
    and all-zero slots, then one blob rooted at 0 that covers the frame."""
    x = torch.from_numpy(FRAMES[NAMES.index("empty")][None])
    sums, bbox, bgsum, n = sk.stats_kernel(x, sk.label_kernel(x, CT), 64)
    assert int(n[0]) == 0
    assert not (sums.any() or bbox.any() or bgsum.any())
    assert sk.label_kernel(x, -CT, "fill").all()
    assert not sk.label_kernel(x, -CT).any()
    got = sk.stats_kernel(x, sk.label_kernel(x, -CT), 64)
    assert int(got[3][0]) == 1 and int(got[0][0, 0, 0]) == H * W
    assert int(got[0][0, 1, 0]) == 2 * (H + W) - 4      # the frame edge
    assert got[1][0, :, 0].tolist() == [0, 0, W - 1, H - 1]
    want = contamination_pallas(jnp.asarray(x.numpy()), -CT, max_blobs=64,
                                channel_major=True, interpret=True,
                                **SETTINGS["shipped"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_q8_taps_and_paired_blur_agree():
    """B6b blurs with _q8_taps and _conv_axis_pair_int, the profilers with
    _q8_taps and _conv_axis, the port with the cumulative-rounding taps:
    for ksize 5 the taps are equal and both integer sums are exact."""
    k5 = jfilters.gaussian_kernel_1d(5, 0.0)
    assert jfilters._q8_taps(k5) == jfilters._q8_taps_bitexact(k5)
    assert list(kernel_taps()[0]) == jfilters._q8_taps(k5)
    rng = np.random.RandomState(3)
    plane = jnp.asarray(rng.randint(0, 256, (37, 53)), jnp.int32)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            np.asarray(pk._conv_axis(plane, _TAPS5, axis, "reflect101")),
            np.asarray(pk._conv_axis_pair_int(plane, _TAPS5, axis,
                                              "reflect101")))


# ------------------------------------------------------------ 640x480

@functools.lru_cache(maxsize=None)
def _bench():
    """Two 640x480 bench frames: the XLA ops' stages (eagerly, as
    tests/test_torch_ops.py runs the f32 mean) and the XLA program's table
    and labels."""
    frames = scene.make_frames(2)
    gray = jops.bgr_to_gray(jnp.asarray(frames))
    blurred = jops.gaussian_blur(gray, 5, 0)
    binary = jops.adaptive_threshold(blurred, 255, "gaussian", "binary_inv",
                                     11, CT)
    se3 = np.ones((3, 3), np.uint8)
    closed = jops.morphology_ex(jops.morphology_ex(binary, "open", se3),
                                "close", se3)
    table, _, _, labels = contamination_program(
        jnp.asarray(frames), jnp.int32(CT), jnp.float32(10.0),
        jnp.float32(3000.0), jnp.float32(0.25), max_blobs=64,
        return_labels=True)
    labels = np.asarray(labels)
    stages = {"gray": gray, "blur5": blurred, "mean11": binary,
              "pre": np.asarray(closed) > 0,
              "fill": labels != 480 * 640, "ccl": labels}
    return (np.ascontiguousarray(frames.transpose(0, 3, 1, 2)),
            {s: np.asarray(v) for s, v in stages.items()},
            {f: np.asarray(getattr(table, f)) for f in table._fields})


@pytest.mark.parametrize("stage", sk.STAGES)
def test_stages_match_xla_ops_640x480(stage):
    cm, stages, _ = _bench()
    got = sk.label_kernel(torch.from_numpy(cm), CT, stage).numpy()
    want = stages[stage]
    if want.dtype == bool:
        want = want.astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_split_matches_fused_and_xla_table_640x480():
    cm, _, table = _bench()
    x = torch.from_numpy(cm)
    raw = sk.stats_kernel(x, sk.label_kernel(x, CT), 64)
    for a, b in zip(raw, contamination_fused_reference(x, CT, 64, True)):
        assert torch.equal(a, b)
    got = table_from_sums(*raw)
    for f, want in table.items():
        if want.dtype == np.float32:
            np.testing.assert_allclose(getattr(got, f).numpy(), want,
                                       atol=1e-6, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(), want,
                                          err_msg=f)
    np.testing.assert_array_equal(raw[3].numpy(), [9, 10])


# ------------------------------------------------------------ wrappers

def test_cpu_wrappers_run_plain_versions():
    x = torch.from_numpy(FRAMES[:2])
    before = (sk.label_kernel.launches, sk.stats_kernel.launches)
    for stage in sk.STAGES:
        assert torch.equal(sk.label_kernel(x, CT, stage),
                           sk.label_kernel_reference(x, CT, stage))
    labels = sk.label_kernel(x, CT)
    for a, b in zip(sk.stats_kernel(x, labels),
                    sk.stats_kernel_reference(x, labels)):
        assert torch.equal(a, b)
    assert (sk.label_kernel.launches, sk.stats_kernel.launches) == before


@pytest.mark.parametrize("case", [
    "nhwc", "mono8", "int32_frames", "too_large", "bad_stage",
    "labels_shape", "labels_dtype", "k_zero"])
def test_wrappers_reject_other_forms(case):
    x = torch.from_numpy(FRAMES[:2])
    labels = torch.full((2, H, W), H * W, dtype=torch.int32)
    big = torch.zeros((1, 3, 640, 640), dtype=torch.uint8)
    assert 640 * 640 > MAX_FRAME_PX
    calls = {
        "nhwc": lambda: sk.label_kernel(x.permute(0, 2, 3, 1), CT),
        "mono8": lambda: sk.label_kernel(x[:, 0], CT),
        "int32_frames": lambda: sk.stats_kernel(x.to(torch.int32), labels),
        "too_large": lambda: sk.label_kernel(big, CT, "gray"),
        "bad_stage": lambda: sk.label_kernel(x, CT, "blur"),
        "labels_shape": lambda: sk.stats_kernel(x, labels[:, :-1]),
        "labels_dtype": lambda: sk.stats_kernel(x, labels.to(torch.int64)),
        "k_zero": lambda: sk.stats_kernel(x, labels, 0),
    }
    with pytest.raises(ValueError):
        calls[case]()
