"""The port's spatially-sharded step against the JAX package's.

heimdall_tpu_torch.parallel's make_tiled_spatial_step runs in one 4-rank
gloo world (tests/_torch_parallel_worker.py, no jax in the ranks) on a 2x2
and a 1x4 (data x spatial) mesh; heimdall_tpu.parallel's runs here on
conftest's virtual CPU devices (1x4 mesh, Pallas in interpret mode).  The
sharded
outputs are functions of the whole frames, whatever the mesh, so both
meshes are held against the one JAX run.

Frames [4, 64, 48, 3] (shards of 16 rows, band 8): dark disks and a dark
ring whose hole the fill closes, both across the cuts
(tests/test_torch_parallel_preprocess.py holds its preprocess).  Every
integer and boolean field of the blob tables and the gates equal JAX's
exactly; the float fields and the confidence are within 1e-6 of
jitted XLA (it rewrites x / 30 as x * (1/30), test_torch_detector_tiled.py)
and equal the port's single-device route (contamination_program with
tiled_band=8) exactly."""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from heimdall_tpu.parallel.mesh import make_mesh
from heimdall_tpu.parallel.sharding import shard_batch
from heimdall_tpu.parallel.tiled_sp import make_tiled_spatial_step
from heimdall_tpu_torch.detectors.contamination_detector import (
    contamination_program)
from heimdall_tpu_torch.parallel.launch import launch

TESTS = str(Path(__file__).resolve().parent)
N, H, W, BAND, K = 4, 64, 48, 8, 16
MESHES = ((2, 2), (1, 4))
GATES = (15, 0.0, 1e9, 0.0)


def make_frames():
    """Dark disks and a dark ring across the cuts of 4 shards."""
    rng = np.random.RandomState(3)
    frames = np.full((N, H, W, 3), 220, np.uint8)
    yy, xx = np.ogrid[:H, :W]
    for i in range(N):
        for _ in range(3):
            y, x = rng.randint(6, H - 6), rng.randint(6, W - 6)
            r, v = rng.randint(3, 8), rng.randint(0, 60)
            frames[i][(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = (v, v, v)
        d = (yy - 30 - i) ** 2 + (xx - 24) ** 2
        frames[i][(d >= 11 ** 2) & (d <= 13 ** 2)] = (20, 30, 40)
    return frames


FRAMES = make_frames()


@functools.lru_cache(maxsize=None)
def _jax():
    mesh = make_mesh(data=1, spatial=4, devices=jax.devices()[:4])
    x = shard_batch(mesh, FRAMES, spatial=True)
    table, conf, accepted = make_tiled_spatial_step(
        mesh, band=BAND, max_blobs=K)(x, *GATES)
    return {"table": {k: np.asarray(v) for k, v in table._asdict().items()},
            "conf": np.asarray(conf), "accepted": np.asarray(accepted)}


@functools.lru_cache(maxsize=None)
def _single_device():
    table, conf, accepted = contamination_program(
        torch.from_numpy(FRAMES), *GATES, max_blobs=K, tiled_band=BAND)
    return {"table": {f: getattr(table, f).numpy() for f in table._fields},
            "conf": conf.numpy(), "accepted": accepted.numpy()}


_WORLD = {}


@pytest.fixture(scope="module", autouse=True)
def _world_started():
    """The world runs while the JAX reference compiles."""
    _WORLD["world"] = launch("_torch_parallel_worker:step_world", 4,
                             args=(FRAMES, BAND, K), device="cpu",
                             timeout=300, sys_path=(TESTS,), wait=False)
    _jax()
    yield
    for world in _WORLD.values():     # worlds a deselected test left
        world.close()
    _WORLD.clear()


@functools.lru_cache(maxsize=None)
def _world():
    return _WORLD["world"].join()


def _by_coord(mesh):
    return {r[mesh]["coord"]: r[mesh] for r in _world()}


def _groups(mesh, get):
    parts = _by_coord(mesh)
    d, s = mesh
    for i in range(d):
        for j in range(1, s):
            np.testing.assert_array_equal(get(parts[i, j]), get(parts[i, 0]))
    return np.concatenate([get(parts[i, 0]) for i in range(d)], axis=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_step_equals_jax(mesh):
    ref = _jax()
    for field, want in ref["table"].items():
        got = _groups(mesh, lambda r: r["table"][field])
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)
    np.testing.assert_allclose(_groups(mesh, lambda r: r["conf"]),
                               ref["conf"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_groups(mesh, lambda r: r["accepted"]),
                                  ref["accepted"])
    assert ref["table"]["n_blobs"].min() >= 1


@pytest.mark.parametrize("mesh", MESHES)
def test_step_equals_single_device_route(mesh):
    ref = _single_device()
    for field, want in ref["table"].items():
        np.testing.assert_array_equal(
            _groups(mesh, lambda r: r["table"][field]), want, err_msg=field)
    np.testing.assert_array_equal(_groups(mesh, lambda r: r["conf"]),
                                  ref["conf"])
    np.testing.assert_array_equal(_groups(mesh, lambda r: r["accepted"]),
                                  ref["accepted"])


@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_agree_on_flood_rounds(mesh):
    """The rings' background crosses the cuts: more than one round, the
    same on every rank."""
    rounds = {p["rounds"] for p in _by_coord(mesh).values()}
    assert len(rounds) == 1 and rounds.pop() >= 2
