"""Network utilities for camera transport diagnostics.

Rebuilds rust/heimdall-gige's net utilities (utils.rs:14-195 and the
connectivity/MTU probes of diagnostics.rs:280-336): TCP connectivity
probe (GigE Vision control port 3956), interface MTU check with the
jumbo-frame warning (< 8000), CIDR math, humanized sizes/durations, and
bandwidth estimation for camera configurations.

A copy of heimdall_tpu/runtime/net.py: the port imports nothing of the JAX
package.
"""

import ipaddress
import os
import socket
import time
from typing import Dict, List, Optional, Tuple

GIGE_CONTROL_PORT = 3956
JUMBO_MTU_WARN = 8000


def probe_tcp(host: str, port: int = GIGE_CONTROL_PORT,
              timeout_s: float = 1.0) -> Tuple[bool, float]:
    """(reachable, round-trip seconds) for a TCP connect probe."""
    start = time.perf_counter()
    try:
        with socket.create_connection((host, port), timeout=timeout_s):
            return True, time.perf_counter() - start
    except OSError:
        return False, time.perf_counter() - start


def interface_mtu(iface: str) -> Optional[int]:
    """MTU of a network interface (Linux sysfs)."""
    path = f"/sys/class/net/{iface}/mtu"
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def list_interfaces() -> List[str]:
    try:
        return sorted(os.listdir("/sys/class/net"))
    except OSError:  # pragma: no cover - non-Linux
        return []


def check_jumbo_frames(iface: str) -> Dict[str, object]:
    """Jumbo-frame gate: warn when MTU < 8000 (reference camera tuning,
    gige/camera.rs:441-465)."""
    mtu = interface_mtu(iface)
    return {
        "interface": iface,
        "mtu": mtu,
        "jumbo_ok": mtu is not None and mtu >= JUMBO_MTU_WARN,
        "recommendation": None if (mtu or 0) >= JUMBO_MTU_WARN else
        f"set MTU >= 9000 on {iface} for GigE Vision streaming",
    }


def same_subnet(ip_a: str, ip_b: str, prefix: int = 24) -> bool:
    net = ipaddress.ip_network(f"{ip_a}/{prefix}", strict=False)
    return ipaddress.ip_address(ip_b) in net


def subnet_hosts(cidr: str, limit: int = 16) -> List[str]:
    net = ipaddress.ip_network(cidr, strict=False)
    out = []
    for host in net.hosts():
        out.append(str(host))
        if len(out) >= limit:
            break
    return out


def humanize_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n:.1f} PiB"


def humanize_duration(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds*1e6:.0f} us"
    if seconds < 1.0:
        return f"{seconds*1e3:.1f} ms"
    if seconds < 60:
        return f"{seconds:.2f} s"
    minutes, secs = divmod(seconds, 60)
    return f"{int(minutes)}m {secs:.0f}s"


def camera_bandwidth_bps(width: int, height: int, fps: float,
                         bytes_per_pixel: float = 1.0,
                         overhead: float = 1.05) -> float:
    """Estimated wire bandwidth for a camera stream (with packet
    overhead)."""
    return width * height * bytes_per_pixel * fps * 8.0 * overhead


def bandwidth_report(cameras: List[Dict], link_bps: float = 1e9) -> Dict:
    """Aggregate bandwidth check for a set of camera configs."""
    total = sum(camera_bandwidth_bps(c.get("width", 640),
                                     c.get("height", 480),
                                     c.get("fps", 30))
                for c in cameras)
    return {
        "total_bps": total,
        "link_bps": link_bps,
        "utilization": total / link_bps,
        "ok": total <= 0.8 * link_bps,
        "human": f"{humanize_bytes(total/8)}/s of "
                 f"{humanize_bytes(link_bps/8)}/s",
    }
