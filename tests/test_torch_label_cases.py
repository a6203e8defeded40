"""The cases that attack the foreground labeling's tiles, on the CPU: the
plain versions of the labels against heimdall_tpu (JAX on the CPU).

The masks come from heimdall_tpu_torch/scene.py (``label_case_masks``): a
foreground corridor snaking across every tile edge and corner, a spiral
corridor and its walls, pixels meeting only diagonally at tile corners
(both diagonals), a component whose least pixel lies in a later tile than
its first rows' tiles and a U joined only in the next tile row, all
foreground, all background, and noise at 0.5 (more roots a band than a
root table holds).  They are held here:

1. the plain ``connected_components`` (8 and 4) against JAX
   ``ops.ccl.connected_components`` at 64x256 (two rows and two columns of
   the 32x128 tiles) and odd sizes down to 3x3;
2. ``band_ccl_reference`` (the plain version of hd_band_ccl) against JAX's
   band kernel, and the port's ``connected_components_tiled`` against
   ``connected_components_tiled(..., interpret=True)``, at 64x256 with
   bands 16 and 32;
3. the plain fused detect against the XLA program on
   ``scene.tile_case_frames(480, 640)`` and the label cases drawn as
   frames, as tests/test_torch_fused.py does on the bench frames.

The same cases hold the CUDA kernels against these plain versions on the
card (tests/test_torch_tiled_cuda.py, tests/test_torch_fused_cuda.py,
chip_smoke.py phases 3 and 3b), so they guard parity with JAX as well.
Equality is exact, but for the XLA program's float table fields (1e-6:
jitted XLA rewrites x / 30 as x * (1/30)).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heimdall_tpu.detectors.contamination_detector import (
    contamination_program)
from heimdall_tpu.ops import ccl as jccl
from heimdall_tpu.ops import ccl_tiled as jtiled

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import ccl_tiled
from heimdall_tpu_torch.ops.ccl import connected_components
from heimdall_tpu_torch.ops.fused_kernels import fused_blob_table

SIZES = [(64, 256), (13, 17), (3, 3), (3, 17), (17, 3)]
K = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions run many small ops: with one intra-op thread
    each, none waits on threads that the other test workers keep off the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(h, w):
    return np.stack(list(scene.label_case_masks(h, w).values()))


@functools.lru_cache(maxsize=None)
def _jax_labels(h, w, connectivity):
    return np.asarray(jccl.connected_components(jnp.asarray(_stack(h, w)),
                                                connectivity))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("connectivity", [8, 4])
def test_plain_labels_match_jax(size, connectivity):
    got = connected_components(torch.from_numpy(_stack(*size)),
                               connectivity)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_labels(*size, connectivity))


def test_label_cases_are_what_they_claim():
    m = scene.label_case_masks(64, 256)
    HW = 64 * 256

    def count(name, conn):
        lab = connected_components(torch.from_numpy(m[name])[None], conn)
        return int((lab == torch.arange(HW).view(1, 64, 256)).sum())

    assert count("snake", 4) == 1 and count("spiral", 4) == 1
    # the one corner (32, 128) of a 64x256 frame: two pixels, diagonal
    for name in ("diagonal_corners", "antidiagonal_corners"):
        assert int(m[name].sum()) == 2
        assert count(name, 8) == 1 and count(name, 4) == 2
    assert m["diagonal_corners"][31, 127] and m["diagonal_corners"][32, 128]
    assert m["antidiagonal_corners"][31, 128]
    assert m["antidiagonal_corners"][32, 127]
    # the hook: one component whose least pixel (3, 254) lies in the last
    # tile column, though the first tile column holds it from row 10; the U
    # (arms at columns 10 and 20 of the first tile) joins below row 31
    lab = connected_components(torch.from_numpy(m["hook"])[None], 8)[0]
    assert int(lab[10, 5]) == 3 * 256 + 254 == int(lab[40, 254])
    assert int(lab[2, 10]) == int(lab[2, 20]) == 2 * 256 + 10
    assert count("hook", 8) == 2
    # noise: more roots in a band of 16 than a root table of 128 holds
    # under 4-connectivity here (under 8 too at 1920x1080 with band 128)
    _, _, counts = ccl_tiled.band_ccl_reference(
        torch.from_numpy(m["noise"])[None], 16, 4, 128)
    assert int(counts.min()) > 128


@functools.lru_cache(maxsize=None)
def _jax_band(band):
    return tuple(np.asarray(x) for x in jtiled._band_ccl(
        jnp.asarray(_stack(64, 256)), 8, band, 6, True, roots_cap=128,
        adaptive=True))


@pytest.mark.parametrize("band", [16, 32])
def test_band_labels_plain_version_matches_jax(band):
    lab, roots, counts = ccl_tiled.band_ccl_reference(
        torch.from_numpy(_stack(64, 256)), band, 8, 128)
    want_lab, want_roots, want_counts = _jax_band(band)
    np.testing.assert_array_equal(lab.numpy(), want_lab)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    # JAX's table holds the first 128 roots of a band, as the port's does
    np.testing.assert_array_equal(roots.numpy(), want_roots)


@functools.lru_cache(maxsize=None)
def _jax_tiled(band):
    return tuple(np.asarray(x) for x in jtiled.connected_components_tiled(
        jnp.asarray(_stack(64, 256)), band=band, adaptive=True,
        interpret=True, return_roots=K))


@pytest.mark.parametrize("band", [16, 32])
def test_connected_components_tiled_matches_jax(band):
    got = ccl_tiled.connected_components_tiled(
        torch.from_numpy(_stack(64, 256)), band=band, return_roots=K)
    for name, a, b in zip(("labels", "root_table", "n_blobs"),
                          _jax_tiled(band), got):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def _frames():
    """tile_case_frames at 640x480 and the label cases drawn dark on
    light, [n, 480, 640, 3] uint8."""
    tiles = np.stack(list(scene.tile_case_frames(480, 640).values()))
    drawn = scene.mask_frames(list(scene.label_case_masks(480, 640).values()))
    return np.concatenate([tiles, drawn])


@functools.lru_cache(maxsize=None)
def _xla_program(ct):
    out = contamination_program(
        jnp.asarray(_frames()), jnp.int32(ct), jnp.float32(10.0),
        jnp.float32(3000.0), jnp.float32(0.25), max_blobs=K,
        return_labels=True)
    return (out[0]._fields, tuple(np.asarray(f) for f in out[0]),
            np.asarray(out[3]))


@pytest.mark.parametrize("ct", [15, -15])
def test_fused_plain_version_matches_xla_on_tile_and_label_cases(ct):
    fields, table, labels = _xla_program(ct)
    got, lab = fused_blob_table(torch.from_numpy(_frames()), ct, K,
                                return_labels=True)
    for f, a in zip(fields, table):
        b = getattr(got, f).numpy()
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(lab.numpy(), labels)
