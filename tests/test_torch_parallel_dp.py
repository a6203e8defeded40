"""The port's band-route data-parallel step against the JAX package's.

heimdall_tpu_torch.parallel.inspect_step's make_tiled_data_parallel_step
runs in one 4-rank gloo world (tests/_torch_parallel_worker.py, no jax in
the ranks) on a 2x2 and a 1x4 mesh, each rank on its own block of the
flat mesh; heimdall_tpu.parallel's runs here on conftest's virtual CPU
devices (1x4 mesh; its band route's Pallas kernels in interpret mode).
Mono8 frames [4, 64, 48], band 16.  Integer and boolean fields and the
gates are equal exactly; float fields and the confidence within 1e-6
(jitted XLA rewrites x / 30 as x * (1/30), as in
test_torch_detector_tiled.py)."""

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from heimdall_tpu.parallel.inspect_step import make_tiled_data_parallel_step
from heimdall_tpu.parallel.mesh import make_mesh
from heimdall_tpu.parallel.sharding import shard_batch
from heimdall_tpu_torch.parallel.launch import launch

TESTS = str(Path(__file__).resolve().parent)
ROOT = Path(TESTS).parent
N, H, W, K, BAND = 4, 64, 48, 16, 16
MESHES = ((2, 2), (1, 4))


def _frames():
    rng = np.random.RandomState(9)
    frames = np.full((N, H, W), 210, np.uint8)
    yy, xx = np.ogrid[:H, :W]
    for i in range(N):
        for _ in range(4):
            y, x = rng.randint(4, H - 4), rng.randint(4, W - 4)
            r, v = rng.randint(2, 9), rng.randint(0, 70)
            frames[i][(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = v
    return frames


FRAMES = _frames()

# run in a subprocess beside the world
ONE_PROCESS = ("from heimdall_tpu_torch.parallel import make_mesh, "
               "mesh_info, multihost\n"
               "multihost.initialize()\n"
               "info = mesh_info(make_mesh(device='cpu'))\n"
               "assert info['shape'] == {'data': 1, 'spatial': 1}, info\n"
               "assert multihost.line_totals({'f': 2.0}) == {'f': 2.0}\n"
               "print('ok')")


@functools.lru_cache(maxsize=None)
def _jax():
    mesh = make_mesh(data=1, spatial=4, devices=jax.devices()[:4])
    table, conf, accepted = make_tiled_data_parallel_step(
        mesh, max_blobs=K, band=BAND)(shard_batch(mesh, FRAMES), 15, 10.0,
                                      3000.0, 0.25)
    return ({k: np.asarray(v) for k, v in table._asdict().items()},
            np.asarray(conf), np.asarray(accepted))


_WORLD = {}


@pytest.fixture(scope="module", autouse=True)
def _world_started():
    """The world runs while the JAX reference compiles."""
    _WORLD["world"] = launch("_torch_parallel_worker:dp_world", 4,
                             args=(FRAMES, K, BAND), device="cpu",
                             timeout=300, sys_path=(TESTS,), wait=False)
    _WORLD["one"] = subprocess.Popen(
        [sys.executable, "-c", ONE_PROCESS], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    _jax()
    yield
    _WORLD["world"].close()
    if _WORLD["one"].poll() is None:     # its test was deselected
        _WORLD["one"].kill()
        _WORLD["one"].communicate()
    _WORLD.clear()


@functools.lru_cache(maxsize=None)
def _world():
    return _WORLD["world"].join()


def _flat(mesh, get):
    """Each rank's own block of the flat mesh, in rank order."""
    parts = {r[mesh]["coord"]: r[mesh] for r in _world()}
    d, s = mesh
    return np.concatenate([get(parts[i, j]) for i in range(d)
                           for j in range(s)], axis=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_tiled_data_parallel_table_equals_jax(mesh):
    table = _jax()[0]
    for field, want in table.items():
        got = _flat(mesh, lambda r: r["tiled_dp"][0][field])
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)
    assert table["n_blobs"].min() >= 1


@pytest.mark.parametrize("mesh", MESHES)
def test_tiled_data_parallel_gates_equal_jax(mesh):
    _, conf, accepted = _jax()
    np.testing.assert_allclose(_flat(mesh, lambda r: r["tiled_dp"][1]),
                               conf, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_flat(mesh, lambda r: r["tiled_dp"][2]),
                                  accepted)


def test_one_process_mesh_without_a_launcher():
    """make_mesh in a process with no world starts a world of one rank
    (as a JAX mesh needs no launcher); initialize does nothing there."""
    out, err = _WORLD["one"].communicate(timeout=120)
    assert _WORLD["one"].returncode == 0 and out.strip() == "ok", err
