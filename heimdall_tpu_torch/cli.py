#!/usr/bin/env python3
"""Remote-control CLI for a running Heimdall dashboard/server.

Completes the reference's stub CLI crate (rust/heimdall-cli — manifest
only: clap + reqwest client): subcommands hitting the REST API of a
running DashboardServer — status, start, stop, settings, watch, metrics.

A copy of heimdall_tpu/cli.py, against the port's dashboard
(heimdall_tpu_torch/serving/dashboard.py, the same REST surface and port):

    python -m heimdall_tpu_torch.cli status
"""

import argparse
import json
import sys
import time
import urllib.error
import urllib.request


def _get(base: str, path: str):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return json.loads(r.read())


def _post(base: str, path: str, payload=None):
    data = json.dumps(payload).encode() if payload is not None else b""
    req = urllib.request.Request(base + path, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def main(argv=None):
    parser = argparse.ArgumentParser(description="Heimdall control CLI")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=59858)
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("status", help="show system stats")
    sub.add_parser("start", help="start inspection")
    sub.add_parser("stop", help="stop inspection")
    sub.add_parser("latest", help="show the latest inspection result")
    sub.add_parser("metrics", help="dump Prometheus metrics")
    p_set = sub.add_parser("set", help="update a setting")
    p_set.add_argument("key")
    p_set.add_argument("value")
    p_watch = sub.add_parser("watch", help="poll stats")
    p_watch.add_argument("-n", "--interval", type=float, default=1.0)
    args = parser.parse_args(argv)

    base = f"http://{args.host}:{args.port}"
    try:
        if args.command == "status":
            print(json.dumps(_get(base, "/api/stats"), indent=2))
        elif args.command == "start":
            print(json.dumps(_post(base, "/api/start")))
        elif args.command == "stop":
            print(json.dumps(_post(base, "/api/stop")))
        elif args.command == "latest":
            latest = _get(base, "/api/latest")
            latest.pop("image", None)
            print(json.dumps(latest, indent=2))
        elif args.command == "metrics":
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                sys.stdout.write(r.read().decode())
        elif args.command == "set":
            try:
                value = json.loads(args.value)
            except json.JSONDecodeError:
                value = args.value
            print(json.dumps(_post(base, "/api/settings",
                                   {args.key: value})))
        elif args.command == "watch":
            while True:
                stats = _get(base, "/api/stats")
                print(f"\rframes={stats['frames_processed']:>8} "
                      f"defects={stats['defects_detected']:>6} "
                      f"rate={stats['defect_rate']:.3f} "
                      f"fps={stats['fps']:.1f} "
                      f"avg={stats['avg_processing_time']*1000:.1f}ms ",
                      end="", flush=True)
                time.sleep(args.interval)
    except urllib.error.URLError as exc:
        print(f"cannot reach {base}: {exc}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
