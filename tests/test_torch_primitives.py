"""The port's primitive microbench (ops/primitives.py and the port's
scripts/microbench_vpu.py) against heimdall_tpu's scripts/microbench_vpu.py.

The script's make_call fixes B = 256 and has no interpret flag, so this
file builds its own pallas_call around the script's bodies and factories,
in interpret mode, at [4, sub, 640], returning the whole plane: the
script's planes of each variant at a batch of 2, then 2 planes of a second
seed with values in [-60, 60).

* primitive_steps on the CPU (the plain version) equals that pallas_call
  exactly for all 27 variants at N = 1, 4 and 36, whole plane and row 0;
* inputs() equals the planes that the script's own main() draws (full,
  quick, only), at a batch of 2;
* the port's script: its constants and per-step arithmetic are the
  script's, it prints the script's JSON form, and it exits with an error
  where there is no card or on arguments it does not take.

The script is loaded by path; its import points jax's compilation cache at
the repository's tracked .jax_cache, so the previous setting is restored
right after it.  JAX outputs are computed once per file (cached).  The
CUDA kernel is held against the plain version on the card by
tests/test_torch_primitives_cuda.py and chip_smoke.py.
"""

import functools
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from heimdall_tpu_torch.ops import primitives as pr
from heimdall_tpu_torch.scripts import microbench_vpu as port_mb
from heimdall_tpu_torch.scripts import timing

_CACHE_DIR = jax.config.jax_compilation_cache_dir
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "scripts"))
import microbench_vpu as mbv  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)

IDS = [f"{n}-{d}" for n, d, _, _ in pr.VARIANTS]
BODIES = {(n, np.dtype(d).name): (b, False) for n, b, d, _ in mbv.VARIANTS}
BODIES.update({(n, np.dtype(d).name): (f, True)
               for n, f, d, _ in mbv.FACTORY_VARIANTS})


@functools.lru_cache(maxsize=None)
def _planes(name, dtype):
    """The script's planes of (name, dtype) at a batch of 2, then 2 planes
    of a second seed in [-60, 60): [4, sub, 640]."""
    first = next(x for n, d, x in pr.inputs(only={name}, batch=2)
                 if d == dtype)
    second = np.random.RandomState(1).randint(-60, 60, first.shape)
    return np.concatenate([first, second.astype(dtype)])


@functools.lru_cache(maxsize=None)
def _jax(name, dtype, iters):
    """make_call's kernel on _planes in interpret mode, whole plane out."""
    body, factory = BODIES[(name, dtype)]
    x = _planes(name, dtype)
    n, sub, w = x.shape

    def kernel(x_ref, o_ref):
        v = x_ref[0]
        if factory:
            step = body(v.shape, v.dtype)

            def loop(i, c):
                return step(c)
        else:
            def loop(i, c):
                return body(c, i)

        o_ref[0] = jax.lax.fori_loop(0, iters, loop, v).astype(jnp.int32)

    spec = pl.BlockSpec((1, sub, w), lambda b: (b, 0, 0),
                        memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        kernel, grid=(n,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((n, sub, w), jnp.int32),
        interpret=True)
    return np.asarray(call(jnp.asarray(x)))


def test_variants_are_the_scripts():
    todo = ([(n, np.dtype(d).name, s, False) for n, _, d, s in mbv.VARIANTS]
            + [(n, np.dtype(d).name, s, True)
               for n, _, d, s in mbv.FACTORY_VARIANTS])
    assert list(pr.VARIANTS) == todo
    assert (pr.H, pr.W, pr.B) == (mbv.H, mbv.W, mbv.B)


@pytest.mark.parametrize("variant", pr.VARIANTS, ids=IDS)
def test_primitive_steps_equal_jax(variant):
    name, dtype, sub, _ = variant
    x = torch.from_numpy(_planes(name, dtype))
    for iters in (1, 4, 36):
        got = pr.primitive_steps(x, name, iters, out_rows=sub)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _jax(name, dtype, iters),
                                      err_msg=f"{name} {dtype} N={iters}")
        assert torch.equal(pr.primitive_steps(x, name, iters), got[:, :1])


def test_step_reference_on_leading_dims():
    x = torch.from_numpy(_planes("nbmin8", "int16"))
    want = pr.step_reference("nbmin8", x)
    got = pr.step_reference("nbmin8", x.view(2, 2, *x.shape[1:]))
    assert torch.equal(got.reshape(want.shape), want)


def _script_run(monkeypatch, capsys, args):
    """The script's main() at B = 2 with its timing stubbed out: (its
    results list, the planes it drew, in order)."""
    drawn = []

    def fake_time(fn, x):
        drawn.append(np.asarray(x))
        return 1.0

    monkeypatch.setattr(mbv, "B", 2)
    monkeypatch.setattr(mbv, "make_call", lambda *a, **k: (lambda x: x))
    monkeypatch.setattr(mbv, "time_call", fake_time)
    monkeypatch.setattr(sys, "argv", ["microbench_vpu.py", *args])
    mbv.main()
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return results, drawn[::2]


@pytest.mark.parametrize("args", [[], ["quick"], ["only", "nbmin8,add"],
                                  ["quick", "only", "min_scan_step,nbmin8"]],
                         ids=["full", "quick", "only", "quick_only"])
def test_inputs_are_the_scripts_draws(monkeypatch, capsys, args):
    results, drawn = _script_run(monkeypatch, capsys, args)
    quick, only = port_mb.parse(args)
    ours = list(pr.inputs(quick, only, batch=2))
    assert [(r["op"], r["dtype"]) for r in results] == [
        (n, d) for n, d, _ in ours]
    assert len(drawn) == len(ours)
    for x, (_, d, y) in zip(drawn, ours):
        assert x.dtype == y.dtype == np.dtype(d)
        np.testing.assert_array_equal(x, y)


def test_port_script_constants_and_arithmetic():
    assert (port_mb.H, port_mb.W, port_mb.B, port_mb.N_LO, port_mb.N_HI,
            port_mb.REPS) == (mbv.H, mbv.W, mbv.B, mbv.N_LO, mbv.N_HI,
                              mbv.REPS)
    t_lo, t_hi = 0.0123, 0.0456
    assert port_mb.us_per_op(t_lo, t_hi, mbv.B) == (
        (t_hi - t_lo) / (mbv.N_HI - mbv.N_LO) / mbv.B * 1e6)


def test_port_script_output_form(monkeypatch, capsys):
    """The port's main() with the card stubbed: t(N) = 1 ms + N * 20 us for
    a batch of 2 gives 10 us per step and frame."""
    monkeypatch.setattr(port_mb, "B", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(timing, "card", lambda: "a card, 700.00 W")
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self: self)
    monkeypatch.setattr(port_mb, "time_call",
                        lambda x, name, iters: 1e-3 + iters * 2e-5)
    results = port_mb.main(["only", "add,mxu_cumsum"])
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == results
    assert [(r["op"], r["dtype"]) for r in results] == [
        ("add", "int32"), ("add", "int16"), ("mxu_cumsum", "int32")]
    assert all(set(r) == {"op", "dtype", "us_per_op"} for r in results)
    assert all(abs(r["us_per_op"] - 10.0) < 1e-9 for r in results)
    lines = err.strip().splitlines()
    assert lines[0] == "a card, 700.00 W" and len(lines) == 4
    assert "us/op/frame" in lines[1]


@pytest.mark.parametrize("argv", [[], ["bogus"], ["only"]],
                         ids=["no_card", "bad_arg", "only_without_names"])
def test_port_script_exits_with_an_error(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        port_mb.main(argv)


@pytest.mark.parametrize("name, dtype, shape, kw", [
    ("mxu_cumsum", torch.int16, (2, 8, 64), {}),      # no such variant
    ("add", torch.int32, (2, 8, 641), {}),            # wider than 640
    ("seg_min_step", torch.int32, (2, 9, 64), {}),    # odd rows
    ("add", torch.int32, (2, 8, 64), {"out_rows": 3}),
    ("add", torch.int32, (2, 8, 64), {"iters": -1}),
    ("nbmin8", torch.int32, (2, 8 * 89, 640), {}),    # beyond 8 blocks
], ids=["dtype", "width", "seg_rows", "out_rows", "iters", "cluster"])
def test_primitive_steps_refuses(name, dtype, shape, kw):
    kw = {"iters": 1, **kw}
    with pytest.raises(ValueError):
        pr.primitive_steps(torch.zeros(shape, dtype=dtype), name, **kw)
