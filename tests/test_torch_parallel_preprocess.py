"""The port's sharded stencil phase against the JAX package's.

heimdall_tpu_torch.parallel.inspect_step's sp_contamination_preprocess
(one exchange of 11 frame rows a side, then the whole-frame preprocess on
the extended shard, cut back) runs in one 4-rank gloo world
(tests/_torch_parallel_worker.py, no jax in the ranks) on a 2x2 and a 1x4
mesh; heimdall_tpu.parallel.inspect_step's (one halo exchange per stencil
op) runs here on conftest's virtual CPU devices (1x4 mesh).  The frames of
tests/test_torch_parallel.py (shards of 16 rows), contrast 15 and -15: the
gray planes and the closed binary masks are equal exactly."""

import functools
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from heimdall_tpu.parallel.inspect_step import sp_contamination_preprocess
from heimdall_tpu.parallel.mesh import make_mesh
from heimdall_tpu_torch.parallel.launch import launch
from test_torch_parallel import make_frames

TESTS = str(Path(__file__).resolve().parent)
MESHES = ((2, 2), (1, 4))
CONTRASTS = (15, -15)
FRAMES = make_frames()


@functools.lru_cache(maxsize=None)
def _jax_fn():
    mesh = make_mesh(data=1, spatial=4, devices=jax.devices()[:4])
    rows = P("data", "spatial")
    f = jax.jit(shard_map(
        lambda x, ct: sp_contamination_preprocess(x, ct, "spatial"),
        mesh=mesh, in_specs=(rows, P()), out_specs=(rows, rows),
        check_vma=False))
    x = jax.device_put(FRAMES, NamedSharding(mesh, rows))
    return lambda ct: tuple(np.asarray(a) for a in f(x, jnp.int32(ct)))


@functools.lru_cache(maxsize=None)
def _jax(ct):
    return _jax_fn()(ct)


_WORLD = {}


@pytest.fixture(scope="module", autouse=True)
def _world_started():
    """The world runs while the JAX reference compiles."""
    _WORLD["world"] = launch("_torch_parallel_worker:preprocess_world", 4,
                             args=(FRAMES,), device="cpu", timeout=300,
                             sys_path=(TESTS,), wait=False)
    for ct in CONTRASTS:
        _jax(ct)
    yield
    for world in _WORLD.values():     # worlds a deselected test left
        world.close()
    _WORLD.clear()


@functools.lru_cache(maxsize=None)
def _world():
    return _WORLD["world"].join()


def _rows(mesh, ct, field):
    """The shards of a [B, H, W] output put back together."""
    parts = {r[mesh, ct]["coord"]: r[mesh, ct] for r in _world()}
    d, s = mesh
    return np.concatenate([np.concatenate([parts[i, j][field]
                                           for j in range(s)], axis=1)
                           for i in range(d)], axis=0)


@pytest.mark.parametrize("ct", CONTRASTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_preprocess_equals_jax(mesh, ct):
    gray, binary = _jax(ct)
    np.testing.assert_array_equal(_rows(mesh, ct, "gray"), gray)
    np.testing.assert_array_equal(_rows(mesh, ct, "binary") > 0,
                                  binary > 0)
    assert 0 < (binary > 0).mean() < 1
