"""The port's last top-level scripts against the JAX package's (JAX on the
CPU, the port with device="cpu"): examples/camera_capture.py,
test_basic.py and test_contamination.py print the same lines as their
JAX counterparts on the same seeds (times masked) and test_contamination
writes the same images; examples/model_training.py runs cut to 8 frames
and 2 steps and prints JAX's lines; scripts/ab_benchmark.py keeps
benchmark.py's arguments and exits without a card.  None of the port's
example files holds a test function (pytest collects only tests/).
"""

import ast
import contextlib
import importlib.util
import io
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from heimdall_tpu_torch.examples import camera_capture, model_training
from heimdall_tpu_torch.examples import test_basic as basic_example
from heimdall_tpu_torch.examples import (
    test_contamination as contamination_example)
from heimdall_tpu_torch.scripts import ab_benchmark

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_EXAMPLES = ("camera_capture", "test_basic", "test_contamination",
                 "model_training")


def jax_example(name):
    """examples/<name>.py of the JAX package, imported from its path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return out.getvalue().splitlines(), result


TIME = re.compile(r"\d+(\.\d+)?( ?ms|s = [\d.]+ fps)")


def masked(lines):
    return [TIME.sub("<t>", line) for line in lines]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_camera_capture_prints_jax_lines():
    want, _ = printed(jax_example("camera_capture").main)
    got, stats = printed(camera_capture.main)
    assert len(got) == 32 and masked(got) == masked(want)
    assert len(stats) == 30 and stats[0][1] == (480, 640)


def test_basic_prints_jax_lines():
    want, _ = printed(jax_example("test_basic").main)
    got, images = printed(lambda: basic_example.main(["--device", "cpu"]))
    assert masked(got) == masked(want)
    assert got[-1] == "basic pipeline OK"
    assert [im.shape for im in images] == [(480, 640)] * 3


def test_contamination_equals_jax(tmp_path, monkeypatch):
    """JAX's writes to results/ in its working directory; the port's to
    the directory it is given (results/ by default)."""
    monkeypatch.chdir(tmp_path)
    want, _ = printed(jax_example("test_contamination").main)
    out = tmp_path / "port"
    got, results = printed(lambda: contamination_example.main(
        ["--device", "cpu", "--output-dir", str(out)]))
    view = [i for i, line in enumerate(want) if line.startswith("view")]
    assert masked(got)[:-1] == masked(want)[:view[0]]
    assert got[-1] == ("view results: python -m "
                       f"heimdall_tpu_torch.serving.web_viewer -d {out}")
    assert sum(r.defect_count for r in results) > 0
    jax_files = sorted(p.name for p in (tmp_path / "results").iterdir())
    assert sorted(p.name for p in out.iterdir()) == jax_files
    assert len(jax_files) == 9
    for name in jax_files:
        assert (out / name).read_bytes() == (
            tmp_path / "results" / name).read_bytes(), name


def test_model_training_runs_and_prints_jax_lines(tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    got, out = printed(lambda: model_training.main(
        ["--device", "cpu"], n_frames=8, steps=2))
    # the lines of JAX's print calls (examples/model_training.py:55-78),
    # their values as patterns
    num = r"[\d.]+"
    want = [r"captured 8 frames, \d+ with defects, shards in .+",
            rf"  train step 0: loss {num}",
            rf"int8 vs float mask agreement: {num}",
            r"  float segmentation detector: \d+ defects on 8 frames",
            r"  int8 segmentation detector: \d+ defects on 8 frames",
            r"  classical detector: \d+ defects \(reference count\)"]
    assert len(got) == len(want)
    for line, pattern in zip(got, want):
        assert re.fullmatch(pattern, line), (line, pattern)
    assert f"shards in {tmp_path}" in got[0]
    assert len(out["losses"]) == 2 and all(map(math.isfinite,
                                               out["losses"]))
    assert 0.0 <= out["agreement"] <= 1.0
    assert out["with_defects"] == 8 and out["defects"]["classical"] > 0


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("holds the no-card error")
    out = str(tmp_path / "results")
    for call in (lambda: model_training.main([], n_frames=1, steps=1),
                 lambda: basic_example.main([]),
                 lambda: contamination_example.main(["--output-dir", out])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "results").exists()
    with pytest.raises(SystemExit, match="no CUDA device"):
        ab_benchmark.main(["-t", "acquisition"])


def test_ab_benchmark_keeps_the_reference_arguments():
    args = ab_benchmark.parse_args(["-i", "3", "-t", "processing", "-f",
                                    "x.png", "-b", "4"])
    assert (args.iterations, args.test, args.file, args.batch) == (
        3, "processing", "x.png", 4)
    args = ab_benchmark.parse_args([])
    assert (args.iterations, args.test, args.file, args.batch) == (
        10, "all", None, 8)
    with pytest.raises(SystemExit):
        ab_benchmark.parse_args(["-t", "nothing"])
    image = ab_benchmark.make_image()
    assert image.shape == (480, 640, 3) and image.dtype == np.uint8
    np.testing.assert_array_equal(image, jax_ab_image())


def jax_ab_image():
    spec = importlib.util.spec_from_file_location("jax_benchmark",
                                                  ROOT / "benchmark.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.make_image()


def test_port_examples_hold_no_test_function():
    for name in PORT_EXAMPLES:
        tree = ast.parse((ROOT / "heimdall_tpu_torch" / "examples"
                          / f"{name}.py").read_text())
        assert not [n.name for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef)
                    and n.name.startswith("test")], name


@pytest.mark.parametrize("use_color", [True, False])
def test_ab_benchmark_cv2_oracle_is_the_parity_tests(use_color):
    """The A/B harness's copy of the OpenCV oracle gives what
    tests/test_detector_parity.py::cv2_oracle gives: on the harness's
    frames (BGR and gray, 0-6 defects) and on the scenes' bench frames."""
    pytest.importorskip("cv2")
    from test_detector_parity import cv2_oracle
    from heimdall_tpu_torch import scene

    images = [ab_benchmark.make_image(n_defects=n, seed=n)
              for n in range(0, 7, 2)]
    images += list(scene.make_frames(2, seed=1))
    images += [im[..., 1].copy() for im in images[:2]]
    found = 0
    for image in images:
        mine = ab_benchmark.cv2_oracle(image, use_color=use_color)
        assert mine == cv2_oracle(image, use_color=use_color)
        found += len(mine)
    assert found > 0
