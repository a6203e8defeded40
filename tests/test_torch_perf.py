"""The port's copies of the JAX-free perf and camera modules
(heimdall_tpu_torch/perf, heimdall_tpu_torch/camera), its torch.profiler
trace, and its performance_analysis example on the CPU; the profilers
(heimdall_tpu_torch/scripts) exit without a card.

The cases are those of tests/test_perf_serving.py (metrics, profiling
sessions, report formats, the manager, the measure helpers) and of
tests/test_camera_lighting.py (the camera HAL), run against the port.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from heimdall_tpu_torch.camera.hal import (CameraError, CameraFactory,
                                           PixelFormat, SimulatedCamera)
from heimdall_tpu_torch.examples import performance_analysis
from heimdall_tpu_torch.perf.metrics import (MetricCounter, MetricsRegistry,
                                             SlidingWindow, ThroughputMeter,
                                             Timer)
from heimdall_tpu_torch.perf.profiling import (ProfilingManager,
                                               ProfilingSession,
                                               measure_throughput,
                                               measure_time)
from heimdall_tpu_torch.perf.reports import ReportFormat


class TestMetrics:
    def test_sliding_window(self):
        w = SlidingWindow(3)
        for v in (1, 2, 3, 4):
            w.push(v)
        assert w.values == [2, 3, 4]
        assert w.min() == 2 and w.max() == 4 and w.avg() == 3
        assert w.percentile(99) == 4

    def test_counter_rate(self):
        c = MetricCounter("x")
        for _ in range(5):
            c.increment()
        assert c.count == 5
        assert c.rate_per_second() >= 0

    def test_timer(self):
        t = Timer("t")
        with t:
            time.sleep(0.01)
        assert t.stats()["avg_s"] >= 0.009

    def test_throughput(self):
        m = ThroughputMeter("t")
        for _ in range(3):
            m.record(10)
            time.sleep(0.01)
        assert m.total == 30
        assert m.throughput() > 0

    def test_registry_prometheus(self):
        reg = MetricsRegistry()
        reg.counter("frames").increment(5)
        reg.gauge("fps", 123.0)
        reg.histogram("lat", 1.5)
        text = reg.prometheus_text()
        assert "frames 5" in text
        assert "fps 123.0" in text
        assert 'lat{stat="avg"}' in text


class TestProfiling:
    def test_session_timings_and_report(self):
        s = ProfilingSession("test")
        with s.timing("step_a"):
            time.sleep(0.005)
        s.increment("frames", 3)
        s.sample_system()
        report = s.report()
        names = [m.name for m in report.stats]
        assert "step_a" in names and "rss" in names
        assert report.counters["frames"] == 3

    def test_report_formats(self):
        s = ProfilingSession("fmt")
        with s.timing("x"):
            pass
        r = s.report()
        assert json.loads(r.render(ReportFormat.JSON))["name"] == "fmt"
        assert "| x |" in r.render(ReportFormat.MARKDOWN)
        assert "x," in r.render(ReportFormat.CSV)
        assert "<table" in r.render(ReportFormat.HTML)
        assert "fmt" in r.render(ReportFormat.TEXT)

    def test_manager_saves(self, tmp_path):
        mgr = ProfilingManager(output_dir=str(tmp_path))
        s = mgr.start_session("run1", device="cpu")
        assert s.device == "cpu"
        with s.timing("t"):
            pass
        path = mgr.end_session("run1")
        assert path and json.load(open(path))["name"] == "run1"
        assert mgr.history == ["run1"]

    def test_measure_helpers(self):
        r, t = measure_time(lambda: 42)
        assert r == 42 and t >= 0
        r, tp = measure_throughput(lambda: None, items=100)
        assert tp > 0

    def test_trace_on_the_cpu(self, tmp_path):
        """The torch.profiler trace writes a Chrome trace and keeps the
        per-operator table on the session."""
        s = ProfilingSession("traced", device="cpu")
        with s.trace(str(tmp_path / "trace")) as log_dir:
            torch.ones(64, 64).matmul(torch.ones(64, 64))
        assert s.trace_path == os.path.join(log_dir, "traced_trace.json")
        events = json.load(open(s.trace_path))["traceEvents"]
        assert any("aten::matmul" in e.get("name", "") for e in events)
        assert "aten::matmul" in s.trace_table

    def test_trace_on_the_card_needs_one(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        s = ProfilingSession("traced")          # device: CUDA by default
        with pytest.raises(RuntimeError):
            with s.trace(str(tmp_path)):
                pass


class TestCameraHAL:
    def test_create_and_acquire(self):
        cam = CameraFactory.create("simulator", "c0",
                                   {"width": 64, "height": 48, "fps": 500})
        cam.initialize()
        cam.start_acquisition()
        frame = cam.acquire_frame()
        assert frame.to_ndarray().shape == (48, 64)
        assert frame.pixel_format == PixelFormat.MONO8
        cam.stop_acquisition()

    def test_acquire_without_start_fails(self):
        cam = SimulatedCamera("c0")
        cam.initialize()
        with pytest.raises(CameraError):
            cam.acquire_frame()

    def test_software_trigger(self):
        cam = SimulatedCamera("c0", {"trigger_mode": "software",
                                     "width": 32, "height": 32})
        cam.initialize()
        cam.start_acquisition()
        cam.trigger()
        frame = cam.acquire_frame(timeout_s=1.0)
        assert frame.frame_id == 0

    def test_trigger_on_continuous_fails(self):
        cam = SimulatedCamera("c0")
        cam.initialize()
        with pytest.raises(CameraError):
            cam.trigger()

    def test_deterministic_defect_every_5th(self):
        cam = SimulatedCamera("c0", {"width": 64, "height": 64,
                                     "fps": 10000})
        cam.initialize()
        cam.start_acquisition()
        mins = [cam.acquire_frame().to_ndarray().min() for _ in range(5)]
        assert mins[4] < 30  # defect frame

    def test_enumerate(self):
        infos = CameraFactory.enumerate("aravis")
        assert len(infos) == 4
        assert infos[0].model == "acA1920-50gm"

    @pytest.mark.parametrize("backend", ["nope", "aravis-hw"])
    def test_unknown_backend(self, backend, monkeypatch):
        # "aravis-hw" is the real-hardware backend: on a host without
        # libaravis (its shim reports none) its camera raises at initialize
        from heimdall_tpu_torch.camera import aravis
        monkeypatch.setattr(aravis, "_load_shim", lambda: None)
        with pytest.raises(CameraError):
            CameraFactory.create(backend, "x").initialize()


class TestPerformanceAnalysis:
    def test_runs_on_the_cpu(self, tmp_path, capsys):
        report, path = performance_analysis.main(
            ["--device", "cpu", "--batches", "2", "--output-dir",
             str(tmp_path)])
        assert report.counters["frames"] == 16
        assert report.counters["defects"] > 0
        names = {s.name: s for s in report.stats}
        assert names["detect_batch"].count == 2
        assert {"warmup", "acquire_batch", "rss"} <= set(names)
        saved = json.load(open(path))
        assert saved["name"] == "performance_analysis"
        assert saved["counters"] == report.counters
        out = capsys.readouterr().out
        assert "Performance report: performance_analysis" in out
        assert "| detect_batch |" in out

    def test_runs_on_the_card_by_default(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError):
            performance_analysis.main(["--output-dir", str(tmp_path)])
        assert not os.listdir(tmp_path)

    def test_detector_sees_the_simulator_defect(self):
        """Every fifth simulated frame carries a dark disc: one more blob
        than the four frames before it (the checkerboard scene holds more
        blobs than K, so the count is n_blobs, not the defect list)."""
        cam = CameraFactory.create("simulator", "c", {"fps": 10000})
        cam.initialize()
        cam.start_acquisition()
        frames = np.stack([cam.acquire_frame().to_ndarray()
                           for _ in range(5)])
        from heimdall_tpu_torch import ContaminationDetector
        det = ContaminationDetector(config={"use_color": False},
                                    device="cpu")
        n = det.run_device(frames)[0].n_blobs.tolist()
        assert n[:4] == [n[0]] * 4 and n[4] == n[0] + 1


@pytest.mark.parametrize("name", ["profile_fused", "profile_preprocess",
                                  "profile_pre_variants",
                                  "profile_fill_variants"])
def test_profilers_exit_without_a_card(name, monkeypatch, capsys):
    """The profilers time the card only: without one they exit with an
    error before timing anything."""
    import importlib
    mod = importlib.import_module(f"heimdall_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(["2", "1"])
    assert "us/frame" not in capsys.readouterr().out
