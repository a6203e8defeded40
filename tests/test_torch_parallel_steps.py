"""The port's line, sharded-inspection, fused data-parallel and sharded
train steps, its meshes, line totals and launcher against the JAX
package's.

The port's steps run in one 4-rank gloo world (tests/_torch_parallel_worker
.py, no jax in the ranks) on a 2x2 and a 1x4 mesh; heimdall_tpu.parallel's
run here on conftest's virtual CPU devices (1x4 mesh, Pallas in interpret
mode) — their outputs do not depend on the mesh.  Integer and boolean
fields, the gates and the line totals are equal exactly; float fields and
the confidence within 1e-6 (jitted XLA rewrites x / 30 as x * (1/30), as
in test_torch_detector_tiled.py).  The train step starts from JAX's
initial parameters (drawn by test_torch_training.py::quick_init) and is
held as tests/test_torch_training_bf16.py holds ClassifierTrainer: the
loss within 1e-4, the parameters after the step within 1e-5 where JAX's
gradient on the global batch exceeds the bf16 noise and within 2 * lr
elsewhere; every rank's parameters bitwise equal.  A second world, whose
rank 2 raises, must fail as a whole (it runs beside the first)."""

import functools
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from heimdall_tpu.models import defect_classifier as jdc
from heimdall_tpu.parallel import multihost as jax_multihost
from heimdall_tpu.parallel.inspect_step import (
    make_line_step, make_pallas_data_parallel_step)
from heimdall_tpu.parallel.mesh import make_mesh as jax_make_mesh
from heimdall_tpu.parallel.mesh import mesh_info as jax_mesh_info
from heimdall_tpu.parallel.sharding import shard_batch
from heimdall_tpu_torch.models import convert
from heimdall_tpu_torch.models import defect_classifier as tdc
from heimdall_tpu_torch.parallel import multihost
from heimdall_tpu_torch.parallel.launch import launch
from heimdall_tpu_torch.parallel.mesh import make_mesh

from test_torch_training import check_train_step, quick_init, state
import _torch_step_rule as rule

TESTS = str(Path(__file__).resolve().parent)
N, H, W, K = 4, 64, 48, 16
MESHES = ((2, 2), (1, 4))


def _frames():
    rng = np.random.RandomState(5)
    frames = np.full((N, H, W, 3), 220, np.uint8)
    yy, xx = np.ogrid[:H, :W]
    for i in range(N):
        for _ in range(4):
            y, x = rng.randint(6, H - 6), rng.randint(6, W - 6)
            r, v = rng.randint(3, 9), rng.randint(0, 60)
            frames[i][(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = (v, v, v)
    return frames


FRAMES = _frames()
# the train step's global batch: 16 patches (4 a rank), half of them flat
# regions of five levels (tied maxima in the pools)
_rng = np.random.RandomState(9)
PATCHES = np.concatenate([
    _rng.randint(0, 256, (8, 32, 32, 1)),
    np.array([0, 40, 120, 200, 255])[_rng.randint(0, 5, (8, 32, 32, 1))]
]).astype(np.uint8)
LABELS = _rng.randint(0, 2, 16)
FLAT = {"Dense_0": tdc.DefectClassifierCNN().flatten_shape()}


def _np_tree(out):
    table, *rest = out
    return ({k: np.asarray(v) for k, v in table._asdict().items()},
            *(np.asarray(r) if not isinstance(r, dict)
              else {k: int(v) for k, v in r.items()} for r in rest))


@functools.lru_cache(maxsize=None)
def _jax_train():
    """JAX's make_sharded_train_step on a 1x4 mesh and its initial
    parameters (flax tree, numpy)."""
    mesh = jax_make_mesh(data=1, spatial=4, devices=jax.devices()[:4])
    train = quick_init(jdc.DefectClassifierCNN,
                       lambda: jdc.make_sharded_train_step(mesh), 0)
    return train, jax.device_get(train.state["params"])


@functools.lru_cache(maxsize=None)
def _jax_train_step():
    """JAX's loss, gradients on the global batch (one device) and
    parameters after one sharded step; the error of a batch that does not
    divide over the mesh."""
    train, initial = _jax_train()
    model = jdc.DefectClassifierCNN()

    def loss_fn(params, x, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(params, x), y).mean()

    _, grads = jax.jit(jax.value_and_grad(loss_fn))(
        initial, jnp.asarray(PATCHES), jnp.asarray(LABELS))
    loss = float(train(PATCHES, LABELS))
    after = state(train.state["params"]["params"], FLAT)
    with pytest.raises(ValueError) as err:
        train(PATCHES[:-2], LABELS[:-2])
    return loss, state(grads["params"], FLAT), after, str(err.value)


@functools.lru_cache(maxsize=None)
def _jax():
    mesh = jax_make_mesh(data=1, spatial=4, devices=jax.devices()[:4])
    line = make_line_step(mesh, max_blobs=K)(
        shard_batch(mesh, FRAMES, spatial=True), 15, 10.0, 3000.0, 0.25,
        0.7)
    pallas = make_pallas_data_parallel_step(mesh, max_blobs=K,
                                            interpret=True)(
        shard_batch(mesh, FRAMES), 15, 10.0, 3000.0, 0.25)
    return {"line": _np_tree(line), "pallas_dp": _np_tree(pallas),
            "info": jax_mesh_info(mesh)}


_WORLD = {}


@pytest.fixture(scope="module", autouse=True)
def _world_started():
    """The world runs while the JAX references compile."""
    initial = convert.state_dict_from_flax(_jax_train()[1]["params"], FLAT)
    _WORLD["world"] = launch("_torch_parallel_worker:steps_world", 4,
                             args=(FRAMES, K, initial, PATCHES, LABELS),
                             device="cpu", timeout=300, sys_path=(TESTS,),
                             wait=False)
    _WORLD["failing"] = launch("_torch_parallel_worker:failing_world", 4,
                               device="cpu", timeout=120, sys_path=(TESTS,),
                               wait=False)
    _jax()
    _jax_train_step()
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
    """A data group's output (the same on its spatial members), by group."""
    parts = _by_coord(mesh)
    d, s = mesh
    for i in range(d):
        for j in range(1, s):
            np.testing.assert_array_equal(get(parts[i, j]), get(parts[i, 0]))
    return np.concatenate([get(parts[i, 0]) for i in range(d)], axis=0)


def _flat(mesh, get):
    """Each rank's own block of a flat mesh, in rank order."""
    parts = _by_coord(mesh)
    d, s = mesh
    return np.concatenate([get(parts[i, j]) for i in range(d)
                           for j in range(s)], axis=0)


def _assert_tables(got_table, want_table, rows=slice(None)):
    for field, want in want_table.items():
        got, want = got_table(field), want[rows]
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("mesh", MESHES)
def test_line_step_equals_jax(mesh):
    table, conf, accepted, stats = _jax()["line"]
    _assert_tables(lambda f: _groups(mesh, lambda r: r["line"][0][f]),
                   table)
    np.testing.assert_allclose(_groups(mesh, lambda r: r["line"][1]), conf,
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_groups(mesh, lambda r: r["line"][2]),
                                  accepted)
    for part in _by_coord(mesh).values():
        assert {k: int(v) for k, v in part["line"][3].items()} == stats
    assert stats["frames"] == N and stats["defects"] == accepted.sum()


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_inspection_ceil_split(mesh):
    """Two frames over the mesh: padded, labelled and trimmed back."""
    table, conf, accepted, _ = _jax()["line"]
    rows = slice(0, 2)
    _assert_tables(
        lambda f: _groups(mesh, lambda r: r["inspect_small"][0][f]), table,
        rows)
    np.testing.assert_allclose(
        _groups(mesh, lambda r: r["inspect_small"][1]), conf[rows],
        atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        _groups(mesh, lambda r: r["inspect_small"][2]), accepted[rows])


@pytest.mark.parametrize("mesh", MESHES)
def test_pallas_data_parallel_step_equals_jax(mesh):
    table, conf, accepted = _jax()["pallas_dp"]
    _assert_tables(lambda f: _flat(mesh, lambda r: r["pallas_dp"][0][f]),
                   table)
    np.testing.assert_allclose(_flat(mesh, lambda r: r["pallas_dp"][1]),
                               conf, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_flat(mesh, lambda r: r["pallas_dp"][2]),
                                  accepted)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_info_equals_jax(mesh):
    want = jax_mesh_info(jax_make_mesh(*mesh, devices=jax.devices()[:4]))
    for part in _by_coord(mesh).values():
        got = part["info"]
        assert got["axis_names"] == want["axis_names"]
        assert got["shape"] == dict(want["shape"])
        assert got["n_devices"] == want["n_devices"]
        assert len(got["devices"]) == len(want["devices"])


@pytest.mark.parametrize("data,spatial", [(3, 2), (-1, 3), (5, 1)])
def test_make_mesh_errors_equal_jax(data, spatial):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(data, spatial, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as got:
        make_mesh(data, spatial, devices=range(4))
    assert str(got.value) == str(want.value)


def test_line_totals_equal_jax():
    """One process: the input, as JAX gives it; four ranks: every rank
    gets the sum over the ranks (what JAX's gives over hosts,
    tests/test_multihost.py)."""
    counts = {"frames": 8.0, "defects": 3.0}
    assert multihost.line_totals(counts) == jax_multihost.line_totals(
        counts)
    want = {"defects": 0.0 + 1 + 2 + 3, "frames": 4 * 8.0 + 0 + 1 + 2 + 3}
    assert [r["totals"] for r in _world()] == [want] * 4


def test_failed_rank_fails_the_world():
    """Rank 2 raises while the others wait for it in a collective: the
    launcher stops them and raises with rank 2's traceback."""
    with pytest.raises(RuntimeError, match="rank 2 fails on purpose"):
        _WORLD["failing"].join()


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_train_step_equals_jax(mesh):
    loss_j, grads_j, after_j, err_j = _jax_train_step()
    parts = list(_by_coord(mesh).values())
    first = parts[0]["train"]
    for part in parts:
        got = part["train"]
        assert got["count"] == 1 and got["device"] == "cpu"
        assert got["loss"] == first["loss"]
        for k, v in got["params"].items():      # every rank the same
            np.testing.assert_array_equal(v, first["params"][k], err_msg=k)
        assert "does not divide" in got["indivisible"]
    assert "divisible" in err_j
    assert abs(first["loss"] - loss_j) <= rule.BF16_LOSS_TOL * loss_j
    tols = rule.bf16_tols(grads_j, "Dense_1")
    check_train_step(f"sharded {mesh}", {
        "grads_j": grads_j, "after_j": after_j, "after_t": first["params"],
        "tols": tols})


def test_dryrun_runs_the_train_step():
    """parallel/dryrun.py's body at its small shapes in the same world:
    every step, the sharded train step's loss finite and the same on every
    rank."""
    runs = [r["dryrun"] for r in _world()]
    assert runs[0]["line_frames"] == 8
    assert np.isfinite(runs[0]["train_loss"])
    assert all(r == runs[0] for r in runs)
