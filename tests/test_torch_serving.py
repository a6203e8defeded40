"""The port's serving layer against heimdall_tpu's (JAX on the CPU): the
dashboard (REST endpoints, server-sent events, settings, 404s, its
inspection loop against JAX's on one fixed batch), the results viewer and
the control CLI (``main --dashboard`` is held in tests/test_torch_system.py
with the rest of ``main``).

The port runs with device="cpu".  The dashboards are driven at 64x48 as
tests/test_perf_serving.py drives JAX's; integers, counts and defect
positions must be equal, float defect fields within 1e-6 (XLA's jit on the
CPU may divide by a constant through its reciprocal: ROADMAP.md §C).
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from heimdall_tpu import cli as jcli
from heimdall_tpu.serving import dashboard as jdash
from heimdall_tpu.serving import web_viewer as jviewer

from heimdall_tpu_torch import cli, scene
from heimdall_tpu_torch.serving import DashboardServer, ResultsViewer
from heimdall_tpu_torch.serving import dashboard, web_viewer

SMALL = {"width": 64, "height": 48, "batch_size": 2}


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read()


def _post(port, path, data=b""):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def _wait_frames(port, least=1, timeout=90):
    deadline = time.time() + timeout
    while time.time() < deadline:
        stats = json.loads(_get(port, "/api/stats")[1])
        if stats["frames_processed"] >= least:
            return stats
        time.sleep(0.1)
    raise AssertionError("the dashboard processed no frames")


def _loop_threads():
    return [t for t in threading.enumerate() if t.name == "dashboard-loop"]


@pytest.fixture()
def server():
    srv = DashboardServer(port=0, settings=dict(SMALL), device="cpu")
    srv.start_background()
    yield srv
    srv.shutdown()


# -------------------------------------------------------------- dashboard

def test_endpoints_settings_and_metrics(server):
    status, body = _get(server.port, "/")
    assert status == 200 and b"Heimdall" in body
    stats = json.loads(_get(server.port, "/api/stats")[1])
    assert stats["frames_processed"] == 0 and stats["running"] is False
    assert set(stats) == {"frames_processed", "defects_detected",
                          "defect_rate", "avg_processing_time", "fps",
                          "running"}

    assert json.loads(_post(server.port, "/api/start")[1]) == {
        "started": True, "running": True}
    assert json.loads(_post(server.port, "/api/start")[1])["started"] is \
        False
    _wait_frames(server.port)
    latest = json.loads(_get(server.port, "/api/latest")[1])
    assert {"timestamp", "defect_count", "defects"} <= set(latest)
    # cv2 is installed here: the preview is a base64 JPEG
    assert latest["image"]

    status, body = _post(server.port, "/api/settings",
                         json.dumps({"batch_size": 4}).encode())
    settings = json.loads(body)["settings"]
    assert settings["batch_size"] == 4 and settings["width"] == 64
    assert set(settings) == {"width", "height", "defect_probability",
                             "batch_size", "min_confidence", "use_native"}
    assert json.loads(_post(server.port, "/api/stop")[1]) == {
        "stopped": True, "running": False}
    assert not _loop_threads()
    status, body = _get(server.port, "/metrics")
    assert status == 200 and b"heimdall_frames_total" in body
    assert b"heimdall_batch_latency_ms" in body


def test_bad_settings_and_404(server):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server.port, "/api/settings", b"{not json")
    assert err.value.code == 400
    for path in ("/nope", "/api"):
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(server.port, path)
        assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server.port, "/api/nope")
    assert err.value.code == 404


def test_stream_pushes_frames(server):
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    try:
        sock.sendall(b"GET /api/stream HTTP/1.1\r\nHost: localhost\r\n"
                     b"Accept: text/event-stream\r\n\r\n")
        sock.settimeout(90)
        _post(server.port, "/api/start")
        buf, events = b"", []
        while len(events) < 2:
            chunk = sock.recv(65536)
            assert chunk, "stream closed early"
            buf += chunk
            while b"\n\n" in buf:
                block, buf = buf.split(b"\n\n", 1)
                for line in block.splitlines():
                    if line.startswith(b"data: "):
                        events.append(json.loads(line[6:]))
    finally:
        sock.close()
    assert events[0]["seq"] < events[1]["seq"]
    assert "stats" in events[0] and "latest" in events[0]
    assert events[1]["stats"]["frames_processed"] >= 2


def test_no_image_without_cv2(server, monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    assert dashboard._encode_jpeg(np.zeros((8, 8, 3), np.uint8)) is None
    server.state.start()
    _wait_frames(server.port)
    server.state.stop()
    latest = server.state.snapshot_latest()
    assert "defect_count" in latest and "image" not in latest


class _Batches:
    """A source that gives one fixed batch twice, then nothing."""
    batch = None

    def __init__(self, source_id, config):
        self.left = 2

    def open(self):
        return True

    def read_batch(self, n):
        if not self.left:
            return 0, None
        self.left -= 1
        return len(self.batch), self.batch


class _Clock:
    """time.time() for the loop, from a script: batch 1 takes 1 s, batch 2
    0.25 s (so the EMA and the fps have known values); sleep is real."""

    def __init__(self):
        self.stamps = [0.0, 1.0, 1.0, 10.0, 10.25, 10.25]

    def time(self):
        return self.stamps.pop(0) if len(self.stamps) > 1 else \
            self.stamps[0]

    @staticmethod
    def sleep(s):
        time.sleep(s)


def _run_two_batches(module, **kwargs):
    state = module.DashboardState(dict(SMALL), **kwargs)
    state.start()
    deadline = time.time() + 120
    while state.snapshot_stats()["frames_processed"] < 4:
        assert time.time() < deadline, "the batches were not processed"
        time.sleep(0.05)
    state.stop()
    return state


def _assert_defect_dicts_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], float) and k != "size":
                assert abs(a[k] - b[k]) <= 1e-6, k
            else:
                assert tuple(np.atleast_1d(a[k])) == tuple(
                    np.atleast_1d(b[k])), k


def test_loop_equals_jax_on_one_batch(monkeypatch):
    """Both loops on the same batch, given twice: latest, the counts and
    the stats' arithmetic (the EMA of dashboard.py:205-212, the fps)."""
    frames = scene.ring_frames(2, 48, 64, seed=5)
    monkeypatch.setattr(_Batches, "batch", frames)
    for module in (dashboard, jdash):
        monkeypatch.setattr(module, "SimulationImageSource", _Batches)
        monkeypatch.setattr(module, "time", _Clock())
    mine = _run_two_batches(dashboard, device="cpu")
    theirs = _run_two_batches(jdash)
    got, want = mine.snapshot_latest(), theirs.snapshot_latest()
    assert want["defect_count"] > 0
    assert got["defect_count"] == want["defect_count"]
    _assert_defect_dicts_equal(got["defects"], want["defects"])
    assert mine.stats == theirs.stats
    assert mine.stats["frames_processed"] == 4
    assert mine.stats["avg_processing_time"] == 0.9 * 0.5 + 0.1 * 0.125
    assert mine.stats["fps"] == 8.0
    assert mine.frame_seq == theirs.frame_seq == 2
    assert not _loop_threads()


def test_stop_waits_for_the_batch_in_flight(monkeypatch):
    """No loop thread outlives stop(), however long a batch takes."""
    state = dashboard.DashboardState(dict(SMALL), device="cpu")
    from heimdall_tpu_torch.inspection import contamination_inspector as ci
    real = ci.ContaminationInspector.inspect_batch
    entered = threading.Event()

    def slow(self, *args, **kwargs):
        entered.set()
        time.sleep(5.5)         # past JAX's 5 s join timeout
        return real(self, *args, **kwargs)

    monkeypatch.setattr(ci.ContaminationInspector, "inspect_batch", slow)
    state.start()
    assert entered.wait(60)
    assert state.stop() is True
    assert not _loop_threads() and state.running is False
    assert state.stats["frames_processed"] == 2


def test_use_native_counts_frames(server):
    server.state.settings["use_native"] = True
    server.state.start()
    stats = _wait_frames(server.port)
    server.state.stop()
    assert stats["frames_processed"] >= 2
    assert "defect_count" in server.state.snapshot_latest()


# ------------------------------------------------------------------ viewer

def _result_images(tmp_path):
    cv2 = pytest.importorskip("cv2")
    for i in (1, 2):
        for kind in ("original", "processed", "visualization"):
            cv2.imwrite(str(tmp_path / f"{kind}_{i}.jpg"),
                        np.zeros((8, 8, 3), np.uint8))
    cv2.imwrite(str(tmp_path / "snapshot.png"), np.zeros((4, 4), np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")


def test_group_results_equals_jax(tmp_path):
    _result_images(tmp_path)
    got = web_viewer.group_results(str(tmp_path))
    assert got == jviewer.group_results(str(tmp_path))
    assert set(got) == {"1", "2", "misc"} and len(got["1"]) == 3
    assert web_viewer.group_results(str(tmp_path / "missing")) == {}


def test_viewer_serves_results(tmp_path):
    _result_images(tmp_path)
    viewer = ResultsViewer(str(tmp_path), port=0)
    viewer.start_background()
    try:
        assert b"Inspection results" in _get(viewer.port, "/")[1]
        data = json.loads(_get(viewer.port, "/api/images")[1])
        assert data["count"] == 7
        status, body = _get(viewer.port, "/images/original_1.jpg")
        assert status == 200 and body == (tmp_path /
                                          "original_1.jpg").read_bytes()
        for path in ("/images/missing.jpg", "/other"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(viewer.port, path)
            assert err.value.code == 404
    finally:
        viewer.shutdown()
    assert web_viewer.DEFAULT_PORT == jviewer.DEFAULT_PORT == 52829


# --------------------------------------------------------------------- CLI

def test_cli_drives_the_dashboard(server, capsys):
    port = ["--port", str(server.port)]
    assert cli.main(port + ["status"]) == 0
    assert json.loads(capsys.readouterr().out)["running"] is False
    assert cli.main(port + ["set", "batch_size", "3"]) == 0
    assert server.state.settings["batch_size"] == 3
    assert cli.main(port + ["set", "note", "text"]) == 0
    assert server.state.settings["note"] == "text"
    capsys.readouterr()
    assert cli.main(port + ["start"]) == 0
    assert json.loads(capsys.readouterr().out)["running"] is True
    _wait_frames(server.port)
    assert cli.main(port + ["latest"]) == 0
    latest = json.loads(capsys.readouterr().out)
    assert "defect_count" in latest and "image" not in latest
    assert cli.main(port + ["metrics"]) == 0
    assert "heimdall_frames_total" in capsys.readouterr().out
    assert cli.main(port + ["stop"]) == 0
    assert json.loads(capsys.readouterr().out) == {"stopped": True,
                                                   "running": False}


def test_cli_unreachable_as_jax(capsys):
    assert cli.main(["--port", "1", "status"]) == 1
    assert "cannot reach http://127.0.0.1:1" in capsys.readouterr().err
    assert jcli.main(["--port", "1", "status"]) == 1


def test_dashboard_keeps_jax_defaults():
    assert dashboard.DEFAULT_PORT == jdash.DEFAULT_PORT == 59858
    assert (dashboard.DashboardState(device="cpu").settings
            == jdash.DashboardState().settings)


def test_dashboard_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("holds the no-card error")
    for make in (lambda: DashboardServer(port=0),
                 lambda: dashboard.DashboardState()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
