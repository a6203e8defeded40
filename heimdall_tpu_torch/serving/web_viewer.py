"""Static inspection-results viewer (stdlib http.server); a copy of
heimdall_tpu/serving/web_viewer.py (the port imports nothing of the JAX
package).

API-compatible with the reference web_viewer.py:16-248: serves the
``results/`` directory, groups original/processed/visualization image sets
by inspection index, exposes GET /api/images, default port 52829.
"""

import json
import logging
import os
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

logger = logging.getLogger("heimdall.web_viewer")

DEFAULT_PORT = 52829

_PAGE = """<!DOCTYPE html>
<html><head><title>Heimdall Results</title>
<style>
body { font-family: sans-serif; background: #1e1e2e; color: #cdd6f4;
       margin: 2em; }
.set { background: #313244; border-radius: 8px; padding: 1em;
       margin: 1em 0; }
img { max-width: 300px; margin-right: 8px; border-radius: 4px; }
</style></head><body>
<h1>Inspection results</h1><div id="sets"></div>
<script>
fetch('/api/images').then(r => r.json()).then(data => {
  const div = document.getElementById('sets');
  for (const [idx, images] of Object.entries(data.sets)) {
    const imgs = images.map(f =>
      `<a href="/images/${f}"><img src="/images/${f}" title="${f}"/></a>`
    ).join('');
    div.innerHTML += `<div class="set"><h3>Inspection ${idx}</h3>${imgs}
    </div>`;
  }
});
</script></body></html>"""

_KINDS = ("original", "processed", "visualization")


def group_results(results_dir: str) -> Dict[str, List[str]]:
    """Group result images into original/processed/visualization sets by
    trailing index (reference web_viewer.py grouping)."""
    sets: Dict[str, List[str]] = {}
    if not os.path.isdir(results_dir):
        return sets
    pattern = re.compile(
        r"^(original|processed|visualization)[_-]?(\d+)\.(jpg|jpeg|png)$")
    for name in sorted(os.listdir(results_dir)):
        m = pattern.match(name)
        if m:
            sets.setdefault(m.group(2), []).append(name)
        elif name.lower().endswith((".jpg", ".jpeg", ".png")):
            sets.setdefault("misc", []).append(name)
    return sets


class _Handler(BaseHTTPRequestHandler):
    results_dir: str = "./results"

    def _send(self, code, body, ctype):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path == "/":
            self._send(200, _PAGE.encode(), "text/html")
        elif self.path == "/api/images":
            sets = group_results(self.results_dir)
            self._send(200, json.dumps(
                {"sets": sets,
                 "count": sum(len(v) for v in sets.values())}).encode(),
                "application/json")
        elif self.path.startswith("/images/"):
            name = os.path.basename(self.path[len("/images/"):])
            path = os.path.join(self.results_dir, name)
            if os.path.isfile(path):
                with open(path, "rb") as f:
                    data = f.read()
                ext = os.path.splitext(name)[1].lstrip(".")
                self._send(200, data, f"image/{ext}")
            else:
                self._send(404, b"not found", "text/plain")
        else:
            self._send(404, b"not found", "text/plain")

    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)


class ResultsViewer:
    def __init__(self, results_dir: str = "./results",
                 port: int = DEFAULT_PORT):
        handler = type("BoundHandler", (_Handler,),
                       {"results_dir": results_dir})
        self.httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        logger.info("Results viewer on http://0.0.0.0:%d", self.port)
        self.httpd.serve_forever()

    def start_background(self):
        import threading
        thread = threading.Thread(target=self.httpd.serve_forever,
                                  daemon=True)
        thread.start()
        return thread

    def shutdown(self):
        self.httpd.shutdown()


def main():  # pragma: no cover
    import argparse
    parser = argparse.ArgumentParser(description="Heimdall results viewer")
    parser.add_argument("-d", "--dir", default="./results")
    parser.add_argument("-p", "--port", type=int, default=DEFAULT_PORT)
    args = parser.parse_args()
    ResultsViewer(args.dir, args.port).serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
