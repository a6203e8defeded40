#!/usr/bin/env python3
"""Full production-line simulation: 4 cameras → card → verdicts → rejection
(port of examples/line_simulation.py).

Config #5 of the JAX package's bench: "full line simulation: 4-camera
acquisition → preprocess → detect → verdict at 90,000 BPH".  Four
simulated GigE cameras produce synchronized FrameSets; sets are assembled
straight into page-locked batch slots (runtime/feeder.py::PinnedUploader);
``ContaminationDetector.verdict_device`` returns per-frame verdicts (B1 at
640x480, the band route at 1920x1080); rejects fire delayed PLC pulses.
The loop reports sustained bottles/hour and per-bottle latency against the
90k BPH / <10 ms gates.

The primary figures are raw: on a PCIe host the upload, launch and fetch
floor is a real cost of every batch, so it is measured (an upload of the
same batch shape, a no-op kernel, a fetch) and printed beside them, not
taken out.  The returned values keep the JAX example's keys.

Runs on the card unless ``--device cpu`` is given (the plain path).

Usage: python -m heimdall_tpu_torch.examples.line_simulation
           [seconds] [sets_per_batch] [--device cuda|cpu]
       python -m heimdall_tpu_torch.examples.line_simulation latency
           [seconds] [--device cuda|cpu]
"""

import argparse
import gc
import time

import numpy as np

from heimdall_tpu_torch.camera.gige import GigESystem, SyncMode
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.perf.metrics import SlidingWindow
from heimdall_tpu_torch.runtime.feeder import (HostFetcher, PinnedUploader,
                                               record_done)
from heimdall_tpu_torch.runtime.plc import RejectionController

TARGET_BPH = 90_000
DEADLINE_MS = 10.0
CAMERAS = 4


def _line(width, height, device):
    """The 4-camera GigE system (started) and the Mono8 detector."""
    system = GigESystem(backend="simulator", sync_mode=SyncMode.SOFTWARE)
    for i in range(CAMERAS):
        system.add_camera(f"cam_{i}", {"width": width, "height": height,
                                       "fps": 10_000, "pattern": "bottle"})
    system.configure()
    system.start()
    detector = ContaminationDetector(config={"include_contours": False,
                                             "use_color": False},
                                     device=device)
    return system, detector


def _assemble(system, buf, sets):
    """Acquire ``sets`` FrameSets into buf, camera order sorted by id."""
    for s in range(sets):
        fs = system.acquire_frames()
        for c, (_cid, fr) in enumerate(sorted(fs.frames.items())):
            buf[CAMERAS * s + c] = fr.data


def _floor_probe(uploader, fetcher, shape):
    """One upload of a batch of shape + a no-op kernel + its fetch, in ms:
    the floor every batch pays on this host."""
    t = time.perf_counter()
    buf = uploader.host_slot(shape)
    x = uploader.upload(buf)
    fetcher.fetch(x[:, 0, 0] > 0)
    return (time.perf_counter() - t) * 1e3


def main(duration_s: float = 10.0, sets_per_batch: int = 8,
         width: int = 640, height: int = 480, return_detail: bool = False,
         device=None, keep_batches: int = 0):
    """Throughput mode: batches of ``sets_per_batch`` bottle sets, two in
    flight.  Returns (bph, p99_ms), or with return_detail (bph, p99_ms,
    detail); ``keep_batches`` keeps the first harvested batches' frames,
    flags and confidences in detail["batches"]."""
    system, detector = _line(width, height, device)
    rejector = RejectionController(delay_ms=100, pulse_duration_ms=50)
    latency_ms = SlidingWindow(1000)
    net_lat_ms = SlidingWindow(1000)
    shape = (CAMERAS * sets_per_batch, height, width)

    # Two page-locked batch slots.  Iteration k assembles into slot k % 2
    # and SUBMITS it (upload on the copy stream, then the verdict kernels:
    # both asynchronous), and only then fetches batch k-1's verdict — so
    # batch k's upload and compute run while k-1's result is fetched and
    # its rejects are processed, and the host then assembles batch k+1.
    # Safety: slot k % 2 is handed out again at iteration k+2 only after
    # the event behind its copy at k has completed (PinnedUploader), and
    # each verdict is fetched after the event recorded when its batch was
    # submitted, on a stream of its own, so fetching k-1 never waits for
    # batch k's work.
    uploader = PinnedUploader(slots=2, device=detector.device)
    fetcher = HostFetcher()
    warm = uploader.host_slot(shape)
    warm[:] = 0
    fetcher.fetch(detector.verdict_device(uploader.upload(warm)))  # build

    def probe_floor():
        return min(_floor_probe(uploader, fetcher, shape) for _ in range(3))

    floor_pre_ms = probe_floor()

    bottles = rejects = n_batches = 0
    kept = []
    t_acq = t_dev = 0.0
    mb_pushed = 0.0
    pending = None          # (flags, confs, done event, frames, t0)

    def harvest(p):
        nonlocal bottles, rejects, n_batches
        flags_d, confs_d, done, frames, t0p = p
        flags, confs = fetcher.fetch((flags_d, confs_d), done)
        for s in range(sets_per_batch):
            bottles += 1
            if flags[CAMERAS * s: CAMERAS * (s + 1)].any():
                conf = float(confs[CAMERAS * s: CAMERAS * (s + 1)].max())
                rejector.reject("line", confidence=conf)
                rejects += 1
        dt = time.perf_counter() - t0p
        latency_ms.push(dt / sets_per_batch * 1000)
        net_lat_ms.push(max(dt * 1e3 - floor_pre_ms, 0.0) / sets_per_batch)
        if frames is not None:
            kept.append((frames, flags, confs))
        n_batches += 1

    k = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < duration_s:
        t0 = time.perf_counter()
        buf = uploader.host_slot(shape)
        _assemble(system, buf, sets_per_batch)
        t1 = time.perf_counter()
        flags_d, confs_d = detector.verdict_device(uploader.upload(buf))
        done = record_done(flags_d)
        t_acq += t1 - t0
        mb_pushed += buf.nbytes / 1e6
        if pending is not None:
            harvest(pending)
        frames = buf.copy() if k < keep_batches else None
        pending = (flags_d, confs_d, done, frames, t0)
        t_dev += time.perf_counter() - t1
        k += 1
    if pending is not None:
        harvest(pending)
    elapsed = time.perf_counter() - t_start
    floor_post_ms = probe_floor()
    floor_ms = max(floor_pre_ms, floor_post_ms)
    system.stop()
    h2d_mb_s = warm.nbytes / 1e6 / (floor_ms / 1e3)

    bph = bottles / elapsed * 3600
    p50_ms = latency_ms.percentile(50)
    p95_ms = latency_ms.percentile(95)
    p99_ms = latency_ms.percentile(99)
    net_elapsed = max(elapsed - n_batches * floor_ms / 1e3, 0.05 * elapsed)
    net_bph = bottles / net_elapsed * 3600
    net_p99_ms = net_lat_ms.percentile(99)
    print(f"stage time: acquisition+assembly {t_acq:.2f}s, "
          f"upload+detect+verdict {t_dev:.2f}s of {elapsed:.2f}s; "
          f"{mb_pushed / elapsed:.0f} MB/s uploaded")
    print(f"\nbottles inspected: {bottles} in {elapsed:.2f}s "
          f"({n_batches} batches of {sets_per_batch} sets, "
          f"{width}x{height} Mono8)")
    print(f"throughput (PRIMARY, raw): {bph:,.0f} BPH "
          f"({'PASS' if bph >= TARGET_BPH else 'below'} the "
          f"{TARGET_BPH:,} BPH target); per-bottle p50 {p50_ms:.3f} ms, "
          f"p95 {p95_ms:.3f} ms, p99 {p99_ms:.3f} ms "
          f"({'PASS' if p99_ms < DEADLINE_MS else 'above'} the 10 ms "
          f"deadline)")
    print(f"floor beside it: upload + no-op kernel + fetch of one batch "
          f"{floor_ms:.3f} ms (pre {floor_pre_ms:.3f}, post "
          f"{floor_post_ms:.3f}; {h2d_mb_s:.0f} MB/s); net of it "
          f"{net_bph:,.0f} BPH, per-bottle p99 {net_p99_ms:.3f} ms")
    print(f"rejects: {rejects} ({rejects / max(bottles, 1) * 100:.1f}%), "
          f"pulses fired: {rejector.stats()['fired']}")
    print(f"sync stats: {system.sync_manager.stats()}")
    if return_detail:
        return bph, p99_ms, {
            "net_bph": net_bph, "h2d_mb_s": h2d_mb_s,
            "net_p99_ms": net_p99_ms, "transfer_ms_per_batch": floor_ms,
            "n_batches": n_batches, "bottles": bottles, "rejects": rejects,
            "p50_ms": p50_ms, "p95_ms": p95_ms, "p99_ms": p99_ms,
            "floor_ms": floor_ms, "elapsed_s": elapsed,
            "acquire_s": t_acq, "batches": kept}
    return bph, p99_ms


def latency_main(duration_s: float = 3.0, width: int = 640,
                 height: int = 480, return_detail: bool = False,
                 device=None, keep_batches: int = 0):
    """Deadline-shaped mode: ONE bottle set per batch.

    Each bottle's 4 frames are acquired into a page-locked slot, uploaded,
    detected and its verdict fetched SYNCHRONOUSLY, so the measured time
    is the per-bottle critical path, acquisition to verdict (the
    reference's RT gate, < 10 ms).  Two floor probes (the same upload, a
    no-op kernel, the fetch) are interleaved with every bottle; the raw
    quantiles are primary, the floor and the quantile-matched net figures
    are printed beside them.  Returns the raw p99, or with return_detail
    the dict (JAX's keys, plus the raw p50/p95 and, with keep_batches, the
    first batches' frames, flags and confidences)."""
    system, detector = _line(width, height, device)
    uploader = PinnedUploader(slots=2, device=detector.device)
    fetcher = HostFetcher()
    shape = (CAMERAS, height, width)
    buf = uploader.host_slot(shape)
    buf[:] = 0
    fetcher.fetch(detector.verdict_device(uploader.upload(buf)))  # build
    _floor_probe(uploader, fetcher, shape)

    # GC is off inside the measured loop: the simulated cameras are Python
    # objects, and a collector pause inside acquire+assembly lands in the
    # raw tail that the floor probes never see.
    raw_ms, floor_samples, acq_ms = [], [], []
    kept = []
    rejects = 0
    gc.collect()
    gc.disable()
    try:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < duration_s:
            t0 = time.perf_counter()
            buf = uploader.host_slot(shape)
            _assemble(system, buf, 1)
            t_acq = time.perf_counter()
            flags_d, confs_d = detector.verdict_device(uploader.upload(buf))
            flags, confs = fetcher.fetch((flags_d, confs_d))
            raw_ms.append((time.perf_counter() - t0) * 1000)
            acq_ms.append((t_acq - t0) * 1000)
            if flags.any():
                rejects += 1
            if len(kept) < keep_batches:
                kept.append((buf.copy(), flags, confs))
            for _ in range(2):
                floor_samples.append(_floor_probe(uploader, fetcher, shape))
    finally:
        gc.enable()
    system.stop()

    raw = np.asarray(raw_ms)
    floor = np.asarray(floor_samples)
    acq = np.asarray(acq_ms)

    def q(a, p):
        return float(np.percentile(a, p))

    def net_q(p):
        return max(q(raw, p) - q(floor, p), 0.0)

    p50, p95, p99 = q(raw, 50), q(raw, 95), q(raw, 99)
    floor_p50 = q(floor, 50)
    net_p50, net_p95, net_p99 = net_q(50), net_q(95), net_q(99)
    print(f"\nlatency mode: {len(raw)} bottles, one 4-frame set per batch "
          f"(synchronous acquire -> upload -> verdict -> fetch; "
          f"{len(floor)} interleaved floor probes)")
    print(f"per-bottle latency (PRIMARY, raw): p50 {p50:.3f} ms, p95 "
          f"{p95:.3f} ms, p99 {p99:.3f} ms "
          f"({'PASS' if p99 < DEADLINE_MS else 'above'} the 10 ms "
          f"deadline at p99)")
    print(f"floor beside it (upload + no-op kernel + fetch): p50 "
          f"{floor_p50:.3f} ms, p99 {q(floor, 99):.3f} ms; net of it, "
          f"quantile-matched: p50 {net_p50:.3f}, p95 {net_p95:.3f}, p99 "
          f"{net_p99:.3f} ms; acquire+assembly p50 {q(acq, 50):.3f} ms, "
          f"p99 {q(acq, 99):.3f} ms; rejects {rejects}")
    if return_detail:
        return {"bottles": len(raw), "floor_ms": floor_p50,
                "p99_ms": p99, "net_p99_ms": net_p99,
                "net_p95_ms": net_p95, "net_p50_ms": net_p50,
                "rejects": rejects, "p50_ms": p50, "p95_ms": p95,
                "acquire_p50_ms": q(acq, 50), "batches": kept}
    return p99


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("args", nargs="*",
                    help="[seconds] [sets_per_batch] or latency [seconds]")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.args and a.args[0] == "latency":
        latency_main(float(a.args[1]) if len(a.args) > 1 else 3.0,
                     device=a.device)
    else:
        main(float(a.args[0]) if a.args else 10.0,
             int(a.args[1]) if len(a.args) > 1 else 8, device=a.device)
