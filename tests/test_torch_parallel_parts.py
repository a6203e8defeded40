"""The port's sharded band kernels' parts against the JAX package's.

heimdall_tpu_torch.parallel.tiled_sp's fill_holes_tiled_sp,
connected_components_tiled_sp and blob_stats_tiled_sp run in one 4-rank
gloo world (tests/_torch_parallel_worker.py, no jax in the ranks) on a
2x2 and a 1x4 mesh; heimdall_tpu.parallel.tiled_sp's run here on conftest's
virtual CPU devices (1x4 mesh, Pallas in interpret mode).  The sharded
outputs are functions of the whole frames, whatever the mesh, so both
meshes are held against the one JAX run, exactly: filled masks, labels,
root tables, blob counts and every field of the blob tables.

Two batches of 64x96 masks, band 8 (two bands a shard): the tile and label
cases of scene.py (spiral and snake corridors across every cut, pixels
meeting at corners, a component whose least pixel lies in a later tile)
with a disk over three shards, on the band tables; and most of them again
with isolated pixels (192 roots in a band, more than its table's 128) and
noise, which take the whole batch to the top-K fallback.

Integer and boolean fields are equal exactly; the float fields of the blob
table are within 1e-6: jitted XLA rewrites x / 30 as x * (1/30), as in
test_torch_detector_tiled.py (tests/test_torch_parallel.py holds them
exactly against the port's single-device route)."""

import functools
from pathlib import Path

import numpy as np
import pytest

import jax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from heimdall_tpu.parallel.inspect_step import _blob_table_structure
from heimdall_tpu.parallel.mesh import make_mesh
from heimdall_tpu.parallel import tiled_sp as jsp
from heimdall_tpu_torch import scene
from heimdall_tpu_torch.parallel.launch import launch

TESTS = str(Path(__file__).resolve().parent)
H, W, BAND, K = 64, 96, 8, 16
MESHES = ((2, 2), (1, 4))
BATCHES = ("cases", "topk")


def _masks():
    tiles = scene.tile_case_masks(H, W)
    labels = scene.label_case_masks(H, W)
    yy, xx = np.ogrid[:H, :W]
    disk = (yy - 26) ** 2 + (xx - 40) ** 2 <= 15 ** 2   # rows 11..41
    cases = [tiles[k] for k in ("spiral_closed", "spiral_open",
                                "snake_closed", "snake_open",
                                "diagonal_corners", "all_fg", "all_bg")]
    cases += [labels[k] for k in ("spiral", "hook", "diagonal_corners",
                                  "antidiagonal_corners")] + [disk]
    dots = np.zeros((H, W), bool)
    dots[::2, ::2] = True
    # the same batch size for both: one JAX compile
    return {"cases": np.stack(cases),
            "topk": np.stack(cases[:10] + [dots, tiles["noise"]])}


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.RandomState(7)
    out = {}
    for name, m in _masks().items():
        B = m.shape[0]
        out[name] = (m, rng.randint(0, 256, (B, H, W), dtype=np.uint8),
                     rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8))
    return out


@functools.lru_cache(maxsize=None)
def _jax_fn():
    mesh = make_mesh(data=1, spatial=4, devices=jax.devices()[:4])
    axes = ("data", "spatial")

    def local(m, g, c):
        filled = jsp.fill_holes_tiled_sp(m, BAND, H, "spatial",
                                         interpret=True, sync_axes=axes)
        lab, rl, nb, sl, sc = jsp.connected_components_tiled_sp(
            filled, BAND, H, "spatial", K, interpret=True, sync_axes=axes)
        table = jsp.blob_stats_tiled_sp(lab, filled, g, c, BAND, H,
                                        "spatial", rl, nb, sl, sc, True,
                                        interpret=True)
        return filled, lab, rl, nb, table

    rows, batch = P("data", "spatial"), P("data")
    f = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(rows, rows, P("data", None, "spatial")),
        out_specs=(rows, rows, batch, batch,
                   jax.tree.map(lambda _: batch, _blob_table_structure(K))),
        check_vma=False))

    def run(m, g, c):
        put = [jax.device_put(a, NamedSharding(mesh, s)) for a, s in
               ((m, rows), (g, rows),
                (np.ascontiguousarray(c.transpose(0, 3, 1, 2)),
                 P("data", None, "spatial")))]
        filled, lab, rl, nb, table = f(*put)
        return {"filled": np.asarray(filled), "labels": np.asarray(lab),
                "rl": np.asarray(rl), "n_blobs": np.asarray(nb),
                "table": {k: np.asarray(v)
                          for k, v in table._asdict().items()}}

    return run


@functools.lru_cache(maxsize=None)
def _jax(name):
    return _jax_fn()(*_inputs()[name])


@pytest.fixture(scope="module", autouse=True)
def _world_started():
    """The world runs while the JAX references compile."""
    _WORLD["world"] = launch("_torch_parallel_worker:parts_world", 4,
                             args=(_inputs(), BAND, K), device="cpu",
                             timeout=300, sys_path=(TESTS,), wait=False)
    for name in BATCHES:
        _jax(name)
    yield
    for world in _WORLD.values():     # worlds a deselected test left
        world.close()
    _WORLD.clear()


_WORLD = {}


@functools.lru_cache(maxsize=None)
def _world():
    return _WORLD["world"].join()


def _by_coord(mesh, name):
    return {r[mesh, name]["coord"]: r[mesh, name] for r in _world()}


def _rows(mesh, name, field):
    """The shards of a [B, H, W] output put back together."""
    parts = _by_coord(mesh, name)
    d, s = mesh
    return np.concatenate([np.concatenate([parts[i, j][field]
                                           for j in range(s)], axis=1)
                           for i in range(d)], axis=0)


def _groups(mesh, name, get):
    """A data group's output (the same on its spatial members), by group."""
    parts = _by_coord(mesh, name)
    d, s = mesh
    for i in range(d):
        for j in range(1, s):
            np.testing.assert_array_equal(get(parts[i, j]), get(parts[i, 0]))
    return np.concatenate([get(parts[i, 0]) for i in range(d)], axis=0)


@pytest.mark.parametrize("name", BATCHES)
@pytest.mark.parametrize("mesh", MESHES)
def test_filled_and_labels_equal_jax(mesh, name):
    ref = _jax(name)
    np.testing.assert_array_equal(_rows(mesh, name, "filled"),
                                  ref["filled"])
    np.testing.assert_array_equal(_rows(mesh, name, "labels"),
                                  ref["labels"])


@pytest.mark.parametrize("name", BATCHES)
@pytest.mark.parametrize("mesh", MESHES)
def test_root_tables_equal_jax(mesh, name):
    ref = _jax(name)
    for field in ("rl", "n_blobs"):
        np.testing.assert_array_equal(
            _groups(mesh, name, lambda r: r[field]), ref[field],
            err_msg=field)


@pytest.mark.parametrize("name", BATCHES)
@pytest.mark.parametrize("mesh", MESHES)
def test_blob_tables_equal_jax(mesh, name):
    ref = _jax(name)["table"]
    for field, want in ref.items():
        got = _groups(mesh, name, lambda r: r["table"][field])
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("mesh", MESHES)
def test_branches_and_rounds(mesh):
    """The cases take the band tables, the dots the top-K fallback, on
    every rank; the spiral's corridor crosses the cuts, so the flood takes
    two rounds or more, as many on every rank."""
    for name, branch in (("cases", "table"), ("topk", "topk")):
        parts = _by_coord(mesh, name)
        assert {p["branch"] for p in parts.values()} == {branch}
        rounds = {p["rounds"] for p in parts.values()}
        assert len(rounds) == 1
    assert min(rounds) >= 1
    cases_rounds = {p["rounds"] for p in _by_coord(mesh, "cases").values()}
    assert cases_rounds.pop() >= 2
