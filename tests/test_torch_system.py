"""The port's system layers against heimdall_tpu's (JAX on the CPU):
config, acquisition, results, the PLC rejector and training-data capture
(copies of JAX-free modules), the contamination inspector, stations, the
diagnostics and ``main``.

The port runs with device="cpu".  Seeded inputs go to both packages;
integers, images, counts and verdicts must be exactly equal, float blob
fields within 1e-6 (XLA's jit on the CPU may divide by a constant through
its reciprocal: ROADMAP.md §C).
"""

import functools
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from heimdall_tpu.core import acquisition as jacq
from heimdall_tpu.core import config as jconfig
from heimdall_tpu.core import results as jresults
from heimdall_tpu.inspection.base_inspector import (
    InspectionResult as JaxResult)
from heimdall_tpu.inspection.contamination_inspector import (
    ContaminationInspector as JaxInspector)
from heimdall_tpu.detectors.base import Defect as JaxDefect
from heimdall_tpu.models import capture as jcapture
from heimdall_tpu.runtime import diagnostics as jdiag
from heimdall_tpu.runtime import plc as jplc

import heimdall_tpu_torch
from heimdall_tpu_torch import cli, scene
from heimdall_tpu_torch import main as tmain
from heimdall_tpu_torch.core import acquisition, config, results, system
from heimdall_tpu_torch.core.pipeline import Pipeline
from heimdall_tpu_torch.detectors.base import Defect
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.inspection import (ContaminationInspector,
                                           InspectionResult)
from heimdall_tpu_torch.models import capture
from heimdall_tpu_torch.runtime import diagnostics, plc
from heimdall_tpu_torch.serving import dashboard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="holds the no-card error")


# ---------------------------------------------------------------- config

def test_config_defaults_and_simulation_yaml_equal_jax():
    assert config.Config().config == jconfig.Config().config
    assert config.Config().get("tpu.batch_size") == 32
    mine = os.path.join(ROOT, "heimdall_tpu_torch", "config",
                        "simulation.yaml")
    theirs = os.path.join(ROOT, "heimdall_tpu", "config", "simulation.yaml")
    with open(mine) as a, open(theirs) as b:
        assert a.read() == b.read()
    assert config.Config(mine).config == jconfig.Config(theirs).config


@pytest.mark.parametrize("ext", [".yaml", ".json"])
def test_config_roundtrip_and_lookups(tmp_path, ext):
    cfgs = [config.Config(), jconfig.Config()]
    for c in cfgs:
        c.set("tpu.batch_size", 8)
        c.set("new.deep.key", [1, 2])
        c.add_camera("cam_1", {"type": "simulation", "width": 320})
        c.add_station("s1", {"camera_id": "cam_1", "save_images": True})
    paths = [str(tmp_path / f"{i}{ext}") for i in range(2)]
    for c, p in zip(cfgs, paths):
        assert c.save_config(p)
    loaded = [config.Config(paths[0]), jconfig.Config(paths[1])]
    assert loaded[0].config == loaded[1].config
    for c in loaded:
        assert c.get("tpu.batch_size") == 8
    assert (loaded[0].get_camera_config("cam_1")
            == loaded[1].get_camera_config("cam_1"))
    assert (loaded[0].get_station_config("s1")
            == loaded[1].get_station_config("s1"))
    assert loaded[0].get_all_cameras() == loaded[1].get_all_cameras()
    assert loaded[0].get_all_stations() == loaded[1].get_all_stations()
    assert config.Config().load_config(str(tmp_path / "none.yaml")) is False


# ----------------------------------------------------------- acquisition

@pytest.mark.parametrize("cfg", [
    {"width": 160, "height": 120, "seed": 0, "defect_probability": 0.3},
    {"width": 96, "height": 64, "seed": 7, "defect_probability": 1.0},
    {"width": 128, "height": 96, "seed": 3, "pattern": "checkerboard",
     "defect_probability": 0.5},
    {"width": 64, "height": 48, "seed": 1, "inject_defects": False},
])
def test_simulation_source_equals_jax(cfg):
    a = acquisition.ImageSourceFactory.create_source("cam", cfg)
    b = jacq.ImageSourceFactory.create_source("cam", cfg)
    with a, b:
        for n in (5, 3):
            ca, fa = a.read_batch(n)
            cb, fb = b.read_batch(n)
            assert ca == cb == n
            np.testing.assert_array_equal(fa, fb)
        oka, one_a = a.read()
        okb, one_b = b.read()
        assert oka and okb
        np.testing.assert_array_equal(one_a, one_b)


def test_file_and_directory_sources_equal_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(4)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"img_{i}.png"),
                    rng.randint(0, 256, (24, 32, 3)).astype(np.uint8))
    for kind, cfg in (("file", {"type": "file", "file_path":
                                str(tmp_path / "img_1.png")}),
                      ("directory", {"type": "directory", "loop": True,
                                     "directory_path": str(tmp_path)})):
        a = acquisition.ImageSourceFactory.create_source(kind, cfg)
        b = jacq.ImageSourceFactory.create_source(kind, cfg)
        assert a.open() and b.open()
        ca, fa = a.read_batch(5)
        cb, fb = b.read_batch(5)
        assert ca == cb == 5
        np.testing.assert_array_equal(fa, fb)
    with pytest.raises(ValueError, match="Unsupported image source"):
        acquisition.ImageSourceFactory.create_source("x", {"type": "bogus"})


# ------------------------------------------------ results, PLC, capture

def _defects(module_defect, n, seed):
    rng = np.random.RandomState(seed)
    return [module_defect("contamination", (int(rng.randint(100)),
                                            int(rng.randint(100))),
                          float(rng.randint(3, 50)), float(rng.rand()),
                          {"bounding_box": (1, 2, 3, 4)}) for _ in range(n)]


def test_result_repository_equals_jax(tmp_path):
    repos = [results.ResultRepository(str(tmp_path / "a")),
             jresults.ResultRepository(str(tmp_path / "b"))]
    for repo, R, D in zip(repos, (InspectionResult, JaxResult),
                          (Defect, JaxDefect)):
        for i in range(4):
            repo.store(R(f"id{i}", 100.0 + i, True, _defects(D, i % 3, i),
                         metadata={"processing_time": 0.01 * i}))
    recs = [r.query(limit=10) for r in repos]
    for a, b in zip(*recs):
        a.pop("stored_at"), b.pop("stored_at")
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert repos[0].summary() == repos[1].summary()
    assert (len(repos[0].query(since=101.5, only_defective=True))
            == len(repos[1].query(since=101.5, only_defective=True)))


def test_rejection_controller_equals_jax():
    ctrls = [plc.RejectionController(delay_ms=5, pulse_duration_ms=1),
             jplc.RejectionController(delay_ms=5, pulse_duration_ms=1)]
    for c in ctrls:
        for i in range(3):
            c.reject("s", 0.5 + 0.1 * i)
    deadline = time.time() + 10
    while time.time() < deadline and any(
            c.stats()["fired"] < 3 for c in ctrls):
        time.sleep(0.01)
    assert ctrls[0].stats() == ctrls[1].stats()
    assert ctrls[0].stats()["fired"] == 3
    client = plc.PLCClient()
    with pytest.raises(ConnectionError):
        client.write_register(plc.REG_LINE_SPEED, 1)
    client.connect()
    client.write_register(plc.REG_LINE_SPEED, 90)
    assert client.read_register(plc.REG_LINE_SPEED) == 90


def test_training_capture_equals_jax(tmp_path):
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (6, 16, 20, 3)).astype(np.uint8)
    caps = [capture.TrainingDataCapture(str(tmp_path / "a"), shard_size=4,
                                        sample_rate=0.5, seed=2),
            jcapture.TrainingDataCapture(str(tmp_path / "b"), shard_size=4,
                                         sample_rate=0.5, seed=2)]
    for cap, D in zip(caps, (Defect, JaxDefect)):
        cap.add_batch(frames, [_defects(D, i % 2, i) for i in range(6)])
        cap.flush()
    assert caps[0].stats() == caps[1].stats()
    for a, b in zip(caps[0].dataset_masks(), caps[1].dataset_masks()):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- inspector

@functools.lru_cache(maxsize=None)
def _jax_inspector():
    return JaxInspector("insp")


def _assert_defects_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.defect_type == b.defect_type
        assert tuple(a.position) == tuple(b.position)
        assert a.size == b.size
        assert a.metadata["bounding_box"] == b.metadata["bounding_box"]
        assert abs(a.confidence - b.confidence) <= 1e-6
        for k in ("intensity_diff", "shape_score", "color_score"):
            assert abs(a.metadata[k] - b.metadata[k]) <= 1e-6, k


@pytest.mark.parametrize("hw", [(120, 160), (240, 320)])
def test_inspect_batch_equals_jax(hw):
    frames = scene.ring_frames(3, *hw, seed=hw[0])
    mine = ContaminationInspector("insp", device="cpu")
    want = _jax_inspector().inspect_batch(frames)
    got = mine.inspect_batch(frames)
    assert sum(r.defect_count for r in want) > 0
    for a, b in zip(got, want):
        assert a.success and b.success
        assert a.has_defects == b.has_defects
        _assert_defects_equal(a.defects, b.defects)
        assert a.metadata["batch_size"] == b.metadata["batch_size"] == 3
    # a tensor batch gives the same results, and with_images the same images
    got_t = mine.inspect_batch(torch.from_numpy(frames), with_images=True)
    want_i = _jax_inspector().inspect_batch(frames, with_images=True)
    for a, b in zip(got_t, want_i):
        _assert_defects_equal(a.defects, b.defects)
        for k in ("original", "processed", "visualization"):
            np.testing.assert_array_equal(a.images[k],
                                          np.asarray(b.images[k]))


def test_inspect_equals_jax():
    frame = scene.ring_frames(1, 120, 160, seed=3)[0]
    want = _jax_inspector().inspect(frame)
    got = ContaminationInspector("insp", device="cpu").inspect(frame)
    assert got.success and want.success and want.defect_count > 0
    _assert_defects_equal(got.defects, want.defects)
    for a, b in zip(got.defects, want.defects):
        assert a.metadata["contour"] == b.metadata["contour"]
    assert set(got.images) == set(want.images)
    for k in want.images:
        np.testing.assert_array_equal(got.images[k], np.asarray(
            want.images[k]), err_msg=k)
    assert set(got.to_dict()) == set(want.to_dict())


def test_inspector_defaults_and_device():
    insp = ContaminationInspector("i", device="cpu")
    det = insp.detectors[0]
    assert (det.min_contaminant_size, det.max_contaminant_size,
            det.contrast_threshold, det.min_confidence, det.use_color) == (
        3, 3000, 25, 0.3, True)
    assert det.device.type == insp.pipeline.device.type == "cpu"
    assert [s.name for s in insp.pipeline.stages] == [
        "grayscale", "blur", "threshold", "morphology"]


def test_detect_batch_on_a_tensor():
    frames = scene.ring_frames(2, 120, 160, seed=9)
    det = ContaminationDetector(config={"include_contours": True},
                                device="cpu")
    a = det.detect_batch(frames)
    b = det.detect_batch(torch.from_numpy(frames))
    assert sum(map(len, a)) > 0
    for da, db in zip(a, b):
        assert [d.to_dict() for d in da] == [d.to_dict() for d in db]


# -------------------------------------------------------------- stations

def _wait(pred, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.05)
    return pred()


def test_station_lifecycle_and_remove():
    sysm = system.System(device="cpu")
    sysm.config.add_camera("cam_1", {"type": "simulation", "width": 80,
                                     "height": 64, "seed": 3})
    sysm.add_station("s1", {"camera_id": "cam_1",
                            "pipeline_type": "bottle_base",
                            "batch_size": 2})
    assert sysm.stations["s1"].pipeline.device.type == "cpu"
    assert sysm.start()
    assert _wait(lambda: sysm.stations["s1"].frames_processed > 0)
    status = sysm.get_status()
    sysm.stop()
    assert status["station_count"] == 1 and status["running_stations"] == 1
    assert status["stations"]["s1"]["frames_processed"] > 0
    assert not sysm.stations["s1"].running
    assert sysm.remove_station("s1")
    assert not sysm.remove_station("s1")
    assert sysm.get_status()["station_count"] == 0


def test_inspector_station_rejects_and_records(tmp_path):
    sysm = system.System(device="cpu")
    sysm.config.set("paths.results", str(tmp_path / "results"))
    sysm.config.add_camera("cam_i", {
        "type": "simulation", "width": 96, "height": 64, "seed": 9,
        "defect_probability": 1.0})
    sysm.add_station("insp", {
        "camera_id": "cam_i", "inspector": "contamination",
        "inspector_config": {"contamination_detector_config": {
            "min_contaminant_size": 3, "contrast_threshold": 25,
            "min_confidence": 0.1, "include_contours": False}},
        "reject": True, "rejection_threshold": 0.1, "save_results": True,
        "capture_training_data": str(tmp_path / "capture"),
        "batch_size": 2})
    st = sysm.stations["insp"]
    assert st.inspector.device.type == "cpu" and st.rejector is not None
    sysm.start()
    ok = _wait(lambda: st.defects_detected > 0)
    sysm.stop()
    assert ok and st.frames_processed > 0
    assert st.last_result["success"]
    assert st.rejector.stats()["scheduled"] > 0
    assert st.repository.summary()["inspections"] > 0
    assert st.capture.stats()["captured"] > 0
    with pytest.raises(ValueError, match="unknown inspector"):
        sysm.add_station("bad", {"camera_id": "cam_i", "inspector": "nope"})


# ------------------------------------------------- diagnostics and main

def test_run_diagnostics_on_cpu():
    report = diagnostics.run_diagnostics(device="cpu", frame=np.full(
        (48, 64, 3), 128, np.uint8))
    want = jdiag.run_diagnostics(frame=np.full((48, 64, 3), 128, np.uint8))
    assert [t.name for t in report.tests] == [t.name for t in want.tests]
    by_name = {t.name: t for t in report.tests}
    assert by_name["tpu_device"].details["platform"] == "cpu"
    assert by_name["compile_sanity"].details == {
        "result": float(want.tests[1].details["result"])}
    assert by_name["detection_pipeline"].details == {"defects": 1}
    assert [t.passed for t in report.tests] == [t.passed for t in want.tests]
    assert report.summary().splitlines()[0] == "Diagnostics: 3/4 passed"


def test_main_simulation_runs_and_returns_0():
    status = {}
    assert tmain.main(["-s", "--duration", "2", "--device", "cpu"],
                      status) == 0
    assert set(status["stations"]) == {"base_inspection",
                                       "sidewall_inspection"}


def test_main_diagnose_on_cpu(capsys):
    assert tmain.main(["--diagnose", "--device", "cpu"]) == 0
    assert "Diagnostics: 3/3 passed" in capsys.readouterr().out


def test_main_dashboard_serves_and_the_cli_drives_it(capsys, monkeypatch):
    """``main -s --dashboard`` serves the dashboard for the run's duration,
    its loop on the run's device, and shuts it down with the system (JAX's
    behaviour; the port exited with an error before its serving layer was
    ported).  The server binds a free port (main imports DashboardServer
    when it starts one, so the patch reaches it), which the CLI is pointed
    at: a fixed port would meet another run's dashboard."""
    status, seen, servers = {}, {}, []

    class FreePort(dashboard.DashboardServer):
        def __init__(self, port=0, **kwargs):
            super().__init__(port=0, **kwargs)
            servers.append(self)

    monkeypatch.setattr(dashboard, "DashboardServer", FreePort)

    def run():
        seen["rc"] = tmain.main(["-s", "--dashboard", "--duration", "1",
                                 "--device", "cpu"], status)

    thread = threading.Thread(target=run)
    thread.start()
    try:
        deadline = time.time() + 30
        while not servers or cli.main(
                ["--port", str(servers[0].port), "status"]) != 0:
            assert time.time() < deadline and thread.is_alive()
            time.sleep(0.1)
        assert json.loads(capsys.readouterr().out)["running"] is True
    finally:
        thread.join(timeout=120)
    assert not thread.is_alive() and seen["rc"] == 0
    assert len(servers) == 1
    assert status["dashboard"]["frames_processed"] > 0
    assert status["dashboard"]["running"] is False
    assert set(status["stations"]) == {"base_inspection",
                                       "sidewall_inspection"}
    assert not [t for t in threading.enumerate()
                if t.name == "dashboard-loop"]
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(
            f"http://127.0.0.1:{servers[0].port}/api/stats", timeout=10)


@NO_CARD
def test_entry_points_raise_without_a_card():
    for make in (lambda: system.System(),
                 lambda: Pipeline("p"),
                 lambda: ContaminationInspector("i"),
                 lambda: diagnostics.run_diagnostics(),
                 lambda: tmain.main(["-s", "--duration", "0.1"]),
                 lambda: tmain.main(["-s", "--dashboard", "--duration",
                                     "0.1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_package_exports_what_jax_exports():
    import heimdall_tpu
    names = {"Config", "ImageSource", "ImageSourceFactory", "Pipeline",
             "PipelineFactory", "ProcessingStage", "System",
             "InspectionStation", "ResultRepository", "Defect",
             "DefectDetector", "ContaminationDetector", "Inspector",
             "InspectionResult", "ContaminationInspector"}
    assert names <= set(dir(heimdall_tpu))
    assert names <= set(heimdall_tpu_torch.__all__)
