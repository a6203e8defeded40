"""The cases that attack the run extraction's lanes and steps, on the CPU:
the plain versions of the run extraction (B3a) and of the fill + extraction
(B3c), ops/runtable_tiled.py::run_extract_reference and
fill_extract_reference, against heimdall_tpu's kernels
(runtable_tiled.py::_make_extract_kernel and _make_fill_extract_kernel,
Pallas in interpret mode).

The masks come from heimdall_tpu_torch/scene.py (``run_case_masks``): runs
ending at, starting at and crossing the 16-column lane and 512-column step
edges of csrc/runtable_tiled.cu, every other lane's columns, a run through
the row, one-pixel runs on every second column (runid wraps past 255 at
width 1920), rows of 6 to 13 runs (R and R + 1 for the tables' widths), all
foreground and all background; row y is the case's row moved right by
y % 17 columns.  The sizes are a few rows at widths 1, 3, 17, 531 and 1920
(``scene.RUN_CASE_SIZES``).  Every case of a size goes through JAX as one
frame (the cases stacked by rows: extraction is row-local).  The fill takes
seeded random flags for up to 40 background slots (past 32 the CUDA kernel
reads them from memory, not from a ballot).  The same cases hold the CUDA
kernels against these plain versions on the card
(tests/test_torch_runtable_cuda.py, chip_smoke.py phase 3c).

Everything compared is an integer or a table value: tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from heimdall_tpu.ops.runtable_tiled import (_make_extract_kernel,
                                             _make_fill_extract_kernel)

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import runtable_tiled as rt

SIZES = scene.RUN_CASE_SIZES
NAMES = tuple(scene.run_case_masks(1, 1))
FILL_R = [(8, 7), (12, 10), (40, 7)]


def _stacked(h, w):
    """[1, len(NAMES) * h, w] uint8 (0 / 255): every case's rows, stacked."""
    masks = scene.run_case_masks(h, w)
    return (np.concatenate([masks[n] for n in NAMES])[None]
            .astype(np.uint8) * np.uint8(255))


def _spec(H, w):
    return pl.BlockSpec((1, H, w), lambda b: (b, 0, 0))


def _tables_shape(H, W, R):
    return [jax.ShapeDtypeStruct((1, H, W), jnp.uint8),
            jax.ShapeDtypeStruct((1, H, R), jnp.int32),
            jax.ShapeDtypeStruct((1, H, R), jnp.int32),
            jax.ShapeDtypeStruct((1, H, 1), jnp.int32)]


@functools.lru_cache(maxsize=None)
def _jax_extract(h, w, R, invert):
    plane = _stacked(h, w)
    H = plane.shape[1]
    call = pl.pallas_call(
        _make_extract_kernel(H, w, R, invert=invert), grid=(1,),
        in_specs=[_spec(H, w)],
        out_specs=[_spec(H, w), _spec(H, R), _spec(H, R), _spec(H, 1)],
        out_shape=_tables_shape(H, w, R), interpret=True)
    return tuple(np.asarray(x) for x in call(jnp.asarray(plane)))


def _flags(h, w, r_bg):
    """Seeded 0 / 1 flags int32 [1, rows, r_bg] for the fill."""
    rows = len(NAMES) * h
    rng = np.random.RandomState(1000 * r_bg + w)
    return rng.randint(0, 2, (1, rows, r_bg)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_fill_extract(h, w, r_bg, r_fg):
    binary = _stacked(h, w)
    H = binary.shape[1]
    runid_bg = _jax_extract(h, w, r_bg, True)[0]
    call = pl.pallas_call(
        _make_fill_extract_kernel(H, w, r_bg, r_fg), grid=(1,),
        in_specs=[_spec(H, w), _spec(H, w), _spec(H, r_bg)],
        out_specs=[_spec(H, w), _spec(H, w), _spec(H, r_fg),
                   _spec(H, r_fg), _spec(H, 1)],
        out_shape=[jax.ShapeDtypeStruct((1, H, w), jnp.uint8)]
        + _tables_shape(H, w, r_fg), interpret=True)
    out = call(jnp.asarray(binary), jnp.asarray(runid_bg),
               jnp.asarray(_flags(h, w, r_bg)))
    return tuple(np.asarray(x) for x in out)


def _assert_equal(got, want, names):
    for name, a, b in zip(names, want, got):
        assert b.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("R", [7, 12])
@pytest.mark.parametrize("size", SIZES)
def test_run_extract_matches_jax_on_run_cases(size, R, invert):
    got = rt.run_extract(torch.from_numpy(_stacked(*size)), R, invert)
    _assert_equal(got, _jax_extract(*size, R, invert),
                  ("runid", "S", "E", "nrun"))


@pytest.mark.parametrize("r", FILL_R)
@pytest.mark.parametrize("size", SIZES)
def test_fill_extract_matches_jax_on_run_cases(size, r):
    r_bg, r_fg = r
    h, w = size
    binary = torch.from_numpy(_stacked(h, w))
    runid_bg = rt.run_extract(binary, r_bg, invert=True)[0]
    np.testing.assert_array_equal(runid_bg.numpy(),
                                  _jax_extract(h, w, r_bg, True)[0])
    got = rt.fill_extract(binary, runid_bg,
                          torch.from_numpy(_flags(h, w, r_bg)), r_fg)
    _assert_equal(got, _jax_fill_extract(h, w, r_bg, r_fg),
                  ("filled", "runid", "S", "E", "nrun"))


def test_run_cases_are_what_they_claim():
    m = scene.run_case_masks(17, 1920)
    assert set(m) == set(NAMES) and len(NAMES) == 17

    def runs(row):
        d = np.diff(np.r_[0, row.astype(np.int8), 0])
        return list(zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1) - 1))

    # row 0 meets each seam exactly; row y is moved right by y columns
    assert runs(m["ends_at_seams"][0]) == [(s - 4, s - 1)
                                           for s in scene.RUN_SEAMS]
    assert runs(m["starts_at_seams"][0]) == [(s, s + 3)
                                             for s in scene.RUN_SEAMS]
    assert runs(m["across_seams"][0]) == [(s - 1, s)
                                          for s in scene.RUN_SEAMS]
    assert runs(m["ends_at_seams"][16])[0] == (28, 31)
    assert runs(m["lane_blocks"][0])[:2] == [(0, 15), (32, 47)]
    assert runs(m["through_row"][0]) == [(1, 1918)]
    for k in scene.RUN_COUNTS:
        assert all(len(runs(row)) == k for row in m[f"runs_{k}"])
    assert m["all_fg"].all() and not m["all_bg"].any()
    # one-pixel runs on every second column: 960 a row, so runid wraps
    for name in ("alternate_even", "alternate_odd"):
        runid, S, E, nrun = rt.run_extract(
            torch.from_numpy(m[name][:1, None]), 12)
        assert int(nrun.max()) == 960
        assert int(runid.max()) == 255 and int(runid[0, 0, -1]) == 960 % 256
