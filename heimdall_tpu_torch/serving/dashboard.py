"""Live inspection dashboard (stdlib HTTP — no Flask dependency), on
PyTorch/CUDA (port of heimdall_tpu/serving/dashboard.py).

API-compatible with the reference dashboard (dashboard.py:34-630): the
same five REST endpoints — GET /api/latest, GET /api/stats, POST
/api/start, POST /api/stop, POST /api/settings — plus GET / serving an
auto-refreshing HTML page, and GET /metrics with Prometheus text (the
reference declared a Prometheus exporter in heimdall-server).

A background thread runs the simulation source through the
ContaminationInspector in device batches (on the card: the fused kernel at
640x480), keeps base64-JPEG previews of the latest result (only where cv2
is installed, as in JAX), and maintains global stats with the reference's
EMA (dashboard.py:483-500).  Default port matches the reference (59858).

The state runs on ``device`` (CUDA unless "cpu" is named; construction
raises when there is no card).  ``stop()`` waits for the batch in flight,
however long the first batch takes to build or load the kernels, so no
loop thread outlives ``stop()`` or ``shutdown()``.
"""

import base64
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from heimdall_tpu_torch import native_bridge
from heimdall_tpu_torch.core.acquisition import SimulationImageSource
from heimdall_tpu_torch.detectors.base import Defect
from heimdall_tpu_torch.detectors.contamination_detector import (
    resolve_device)
from heimdall_tpu_torch.inspection.contamination_inspector import (
    ContaminationInspector)
from heimdall_tpu_torch.perf.metrics import registry

logger = logging.getLogger("heimdall.dashboard")

DEFAULT_PORT = 59858

_PAGE = """<!DOCTYPE html>
<html><head><title>Heimdall Dashboard</title>
<style>
body {{ font-family: sans-serif; background: #1e1e2e; color: #cdd6f4;
       margin: 2em; }}
h1 {{ color: #89b4fa; }}
.card {{ background: #313244; border-radius: 8px; padding: 1em;
         margin: 1em 0; display: inline-block; vertical-align: top; }}
img {{ border-radius: 4px; max-width: 480px; }}
table td {{ padding: 2px 12px 2px 0; }}
button {{ background: #89b4fa; border: 0; padding: 8px 16px;
          border-radius: 4px; cursor: pointer; margin-right: 8px; }}
</style></head>
<body>
<h1>Heimdall &mdash; Live Inspection</h1>
<div>
 <button onclick="fetch('/api/start',{{method:'POST'}})">Start</button>
 <button onclick="fetch('/api/stop',{{method:'POST'}})">Stop</button>
</div>
<div class="card"><h3>Latest frame</h3>
 <img id="frame" alt="waiting for frames..."/></div>
<div class="card"><h3>Stats</h3><table id="stats"></table></div>
<script>
async function tick() {{
  try {{
    const latest = await (await fetch('/api/latest')).json();
    if (latest.image) {{
      document.getElementById('frame').src =
        'data:image/jpeg;base64,' + latest.image;
    }}
    const stats = await (await fetch('/api/stats')).json();
    const rows = Object.entries(stats).map(
      ([k, v]) => `<tr><td>${{k}}</td><td>${{
        typeof v === 'number' ? v.toFixed(3) : v}}</td></tr>`).join('');
    document.getElementById('stats').innerHTML = rows;
  }} catch (e) {{}}
}}
function render(latest, stats) {{
  if (latest.image) {{
    document.getElementById('frame').src =
      'data:image/jpeg;base64,' + latest.image;
  }}
  const rows = Object.entries(stats).map(
    ([k, v]) => `<tr><td>${{k}}</td><td>${{
      typeof v === 'number' ? v.toFixed(3) : v}}</td></tr>`).join('');
  document.getElementById('stats').innerHTML = rows;
}}
// push channel (every frame); fall back to 1 Hz polling on error
try {{
  const es = new EventSource('/api/stream');
  es.onmessage = (ev) => {{
    const p = JSON.parse(ev.data); render(p.latest, p.stats);
  }};
  es.onerror = () => {{ es.close(); setInterval(tick, 1000); }};
}} catch (e) {{
  setInterval(tick, 1000);
}}
tick();
</script>
</body></html>"""


def _encode_jpeg(image: np.ndarray) -> Optional[str]:
    try:
        import cv2
        ok, buf = cv2.imencode(".jpg", image)
        if ok:
            return base64.b64encode(buf.tobytes()).decode()
    except ImportError:
        pass
    return None


class DashboardState:
    def __init__(self, settings: Dict[str, Any] = None, device=None):
        self.device = resolve_device(device)
        self.settings: Dict[str, Any] = {
            "width": 640, "height": 480,
            "defect_probability": 0.3,
            "batch_size": 4,
            "min_confidence": 0.3,
            # like the reference's use_rust toggle (dashboard.py:453):
            # route detection through the native C++ scalar path instead
            # of the inspector on the device
            "use_native": False,
            **(settings or {})}
        self.running = False
        self.latest: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {
            "frames_processed": 0,
            "defects_detected": 0,
            "defect_rate": 0.0,
            "avg_processing_time": 0.0,
            "fps": 0.0,
        }
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # server-push (SSE) support: sequence number bumped per frame
        self.frame_seq = 0
        self._frame_cv = threading.Condition()

    # ------------------------------------------------------------------
    def start(self) -> bool:
        with self._lock:
            if self.running:
                return False
            self._stop.clear()
            self.running = True
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="dashboard-loop")
            self._thread.start()
            return True

    def stop(self) -> bool:
        with self._lock:
            if not self.running:
                return False
            self._stop.set()
        # the loop sees the event between batches: wait for the batch in
        # flight (JAX waits at most 5 s)
        if self._thread is not None:
            self._thread.join()
        self.running = False
        return True

    def _loop(self) -> None:
        source = SimulationImageSource("dashboard", {
            "width": self.settings["width"],
            "height": self.settings["height"],
            "defect_probability": self.settings["defect_probability"]})
        source.open()
        inspector = ContaminationInspector("dashboard", {
            "contamination_detector_config": {
                "min_contaminant_size": 3,
                "contrast_threshold": 25,
                "min_confidence": self.settings["min_confidence"],
                "include_contours": False}}, device=self.device)
        frame_counter = registry.counter("heimdall_frames_total")
        defect_counter = registry.counter("heimdall_defects_total")
        while not self._stop.is_set():
            n, batch = source.read_batch(self.settings["batch_size"])
            if n == 0:
                time.sleep(0.05)
                continue
            start = time.time()
            if self.settings.get("use_native"):
                class _R:  # minimal result shim for the stats below
                    def __init__(self, defects):
                        self.defects = defects
                        self.defect_count = len(defects)
                results = []
                for frame in batch:
                    out = native_bridge.detect_contamination(
                        frame, device=self.device)
                    results.append(_R([
                        Defect(d["type"], tuple(d["position"]), d["size"],
                               d["confidence"],
                               {"bounding_box": d.get("bounding_box")})
                        for d in out["defects"]]))
            else:
                results = inspector.inspect_batch(batch, with_images=False)
            elapsed = time.time() - start
            per_frame = elapsed / n

            defects = sum(r.defect_count for r in results)
            frame_counter.increment(n)
            defect_counter.increment(defects)
            registry.histogram("heimdall_batch_latency_ms", elapsed * 1000)
            with self._lock:
                s = self.stats
                s["frames_processed"] += n
                s["defects_detected"] += defects
                s["defect_rate"] = (s["defects_detected"]
                                    / max(s["frames_processed"], 1))
                # reference EMA alpha = 0.1 (dashboard.py:483-500)
                if s["avg_processing_time"] == 0:
                    s["avg_processing_time"] = per_frame
                else:
                    s["avg_processing_time"] = (
                        0.9 * s["avg_processing_time"] + 0.1 * per_frame)
                s["fps"] = n / elapsed if elapsed > 0 else 0.0

                last = results[-1]
                viz = ContaminationInspector._create_visualization(
                    inspector, batch[-1], batch[-1], last.defects)
                encoded = _encode_jpeg(viz)
                self.latest = {
                    "timestamp": time.time(),
                    "defect_count": last.defect_count,
                    "defects": [d.to_dict() for d in last.defects],
                }
                if encoded:
                    self.latest["image"] = encoded
                with self._frame_cv:
                    self.frame_seq += 1
                    self._frame_cv.notify_all()

    # ------------------------------------------------------------------
    def wait_for_frame(self, last_seq: int, timeout: float = 5.0) -> int:
        """Block until a frame newer than last_seq exists (SSE push).

        Returns the current sequence number (== last_seq on timeout)."""
        with self._frame_cv:
            self._frame_cv.wait_for(lambda: self.frame_seq > last_seq,
                                    timeout=timeout)
            return self.frame_seq

    def snapshot_latest(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self.latest)
            # contour metadata can be huge — drop it from the wire format
            for d in out.get("defects", []):
                d.pop("contour", None)
            return out

    def snapshot_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {**self.stats, "running": self.running}


class _Handler(BaseHTTPRequestHandler):
    state: DashboardState = None

    def _send(self, code: int, body: bytes,
              content_type: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj: Any, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode())

    def do_GET(self):  # noqa: N802
        if self.path == "/":
            self._send(200, _PAGE.encode(), "text/html")
        elif self.path == "/api/latest":
            self._json(self.state.snapshot_latest())
        elif self.path == "/api/stats":
            self._json(self.state.snapshot_stats())
        elif self.path == "/metrics":
            self._send(200, registry.prometheus_text().encode(),
                       "text/plain; version=0.0.4")
        elif self.path == "/api/stream":
            self._stream_events()
        else:
            self._json({"error": "not found"}, 404)

    def _stream_events(self) -> None:
        """Server-Sent Events push: one event per processed frame.

        The reference dashboard polls at 1 Hz (dashboard.py:322-397); this
        push channel delivers every frame with no polling — EventSource in
        the browser, or any HTTP client reading the stream."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        seq = 0
        try:
            while True:
                new_seq = self.state.wait_for_frame(seq, timeout=2.0)
                if new_seq == seq:
                    if not self.state.running:
                        # keep the stream alive while idle, but let the
                        # client know (SSE comment = keepalive)
                        self.wfile.write(b": idle\n\n")
                        self.wfile.flush()
                        continue
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
                    continue
                seq = new_seq
                payload = {"seq": seq,
                           "latest": self.state.snapshot_latest(),
                           "stats": self.state.snapshot_stats()}
                self.wfile.write(b"data: " + json.dumps(payload).encode()
                                 + b"\n\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            return  # client went away

    def do_POST(self):  # noqa: N802
        if self.path == "/api/start":
            self._json({"started": self.state.start(),
                        "running": self.state.running})
        elif self.path == "/api/stop":
            self._json({"stopped": self.state.stop(),
                        "running": self.state.running})
        elif self.path == "/api/settings":
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
                self.state.settings.update(payload)
                self._json({"settings": self.state.settings})
            except json.JSONDecodeError:
                self._json({"error": "invalid json"}, 400)
        else:
            self._json({"error": "not found"}, 404)

    def log_message(self, fmt, *args):  # quiet
        logger.debug("%s - %s", self.address_string(), fmt % args)


class DashboardServer:
    """HTTP dashboard server wrapper."""

    def __init__(self, port: int = DEFAULT_PORT,
                 settings: Dict[str, Any] = None, device=None):
        self.state = DashboardState(settings, device=device)
        handler = type("BoundHandler", (_Handler,), {"state": self.state})
        self.httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self.port = self.httpd.server_address[1]

    def serve_forever(self) -> None:
        logger.info("Dashboard on http://0.0.0.0:%d", self.port)
        try:
            self.httpd.serve_forever()
        finally:
            self.state.stop()

    def start_background(self) -> threading.Thread:
        thread = threading.Thread(target=self.httpd.serve_forever,
                                  daemon=True)
        thread.start()
        return thread

    def shutdown(self) -> None:
        self.state.stop()
        self.httpd.shutdown()
        self.httpd.server_close()


def main():  # pragma: no cover - manual entry
    import argparse
    parser = argparse.ArgumentParser(description="Heimdall dashboard")
    parser.add_argument("-p", "--port", type=int, default=DEFAULT_PORT)
    parser.add_argument("--autostart", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to run on (default cuda; cpu runs the "
                             "plain PyTorch versions)")
    args = parser.parse_args()
    server = DashboardServer(port=args.port, device=args.device)
    if args.autostart:
        server.state.start()
    server.serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
