"""The port's runtime layer against heimdall_tpu's: native bridge, frame
ring, camera feeder, device feeder, pinned uploads, recovery, scheduler,
ipc and net.

Each test drives the JAX package's module and the port's with the same
seeded inputs and compares what they return: frames, ids, counters and
outputs exactly; latencies only where both packages define them the same
way (timings differ run to run).  The port's device paths run with
``device="cpu"``; the card-only cases are in test_torch_line_cuda.py.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heimdall_tpu import native_bridge as jnb
from heimdall_tpu.runtime import feeder as jfeeder
from heimdall_tpu.runtime import ipc as jipc
from heimdall_tpu.runtime import net as jnet
from heimdall_tpu.runtime import recovery as jrec
from heimdall_tpu.runtime import scheduler as jsched
from heimdall_tpu_torch import native_bridge as tnb
from heimdall_tpu_torch.runtime import feeder as tfeeder
from heimdall_tpu_torch.runtime import ipc as tipc
from heimdall_tpu_torch.runtime import net as tnet
from heimdall_tpu_torch.runtime import recovery as trec
from heimdall_tpu_torch.runtime import scheduler as tsched

COUNTS = ("pushes", "pops", "drops")


def _wait_for(cond, timeout_s=5.0):
    """Poll cond until it holds or timeout_s passes; returns cond()."""
    deadline = time.time() + timeout_s
    while not cond() and time.time() < deadline:
        time.sleep(0.005)
    return cond()


@pytest.fixture(params=["native", "deque"])
def ring_kind(request, monkeypatch):
    """Both packages' FrameRing on the native ring, or (native_bridge._load
    patched to None in both) on the deque."""
    if request.param == "deque":
        monkeypatch.setattr(jnb, "_load", lambda: None)
        monkeypatch.setattr(tnb, "_load", lambda: None)
    else:
        assert tnb._load() is not None, "native/libheimdall_native.so"
    return request.param


def _ring_trace(mod, frames, capacity):
    ring = mod.FrameRing(capacity, frames.shape[1:])
    pushed = [ring.push(f, i) for i, f in enumerate(frames)]
    size = ring.size()
    popped = [ring.pop() for _ in range(3)]
    batch = ring.pop_batch(4, timeout_s=0.05)
    empty = ring.pop()
    stats = ring.stats()
    native = ring._ring is not None
    ring.close()
    return pushed, size, popped, batch, empty, stats, native


def test_frame_ring_equals_jax(ring_kind):
    frames = np.random.RandomState(0).randint(0, 256, (9, 6, 10), np.uint8)
    j = _ring_trace(jfeeder, frames, 6)
    t = _ring_trace(tfeeder, frames, 6)
    assert t[6] == j[6] == (ring_kind == "native")
    assert t[0] == j[0] and t[1] == j[1]          # pushes, drops, size
    assert not all(t[0])
    for (jf, jid, jlat), (tf, tid, tlat) in zip(j[2], t[2]):
        np.testing.assert_array_equal(tf, jf)
        assert tid == jid and tlat >= 0
    np.testing.assert_array_equal(t[3], j[3])
    assert t[4] is None and j[4] is None
    assert set(t[5]) == set(j[5])
    assert [t[5][k] for k in COUNTS] == [j[5][k] for k in COUNTS]
    if ring_kind == "deque":
        assert t[5] == j[5]                        # no latency kept


def test_native_camera_feeder_python_producer_equals_jax(monkeypatch):
    """The Python producer (no native library): the port's frames, gray by
    ops/color on the CPU, equal JAX's frame for frame."""
    monkeypatch.setattr(jnb, "_load", lambda: None)
    monkeypatch.setattr(tnb, "_load", lambda: None)
    got = []
    for mod in (jfeeder, tfeeder):
        cam = mod.NativeCameraFeeder(width=64, height=48, fps=200,
                                     defect_probability=0.5, capacity=16,
                                     seed=3)
        with cam:
            batch = cam.ring.pop_batch(3, timeout_s=5.0)
        assert cam._py_thread is None and cam.ring._ring is None
        got.append(batch)
    assert got[1].shape == (3, 48, 64)
    np.testing.assert_array_equal(got[1], got[0])


def test_native_camera_feeder_native_producer():
    cam = tfeeder.NativeCameraFeeder(width=64, height=48, fps=200,
                                     capacity=16, seed=1)
    with cam:
        batch = cam.ring.pop_batch(4, timeout_s=2.0)
        stats = cam.stats()
    assert cam.ring._ring is not None
    assert batch.shape == (4, 48, 64)
    assert stats["pushes"] >= 4 and stats["frames_produced"] >= 4
    jcam = jfeeder.NativeCameraFeeder(width=64, height=48, fps=200,
                                      capacity=16, seed=1)
    with jcam:
        jcam.ring.pop_batch(1, timeout_s=2.0)
        jstats = jcam.stats()
    assert set(stats) == set(jstats)


# -- DeviceFeeder ----------------------------------------------------------

def _jax_step(b):
    return {"sum": jnp.asarray(b).sum(), "rows": (jnp.asarray(b)[:, 0],),
            "tag": "batch"}


def _torch_step(b):
    x = torch.from_numpy(b)
    return {"sum": x.to(torch.int64).sum(), "rows": (x[:, 0],),
            "tag": "batch"}


def _same_result(t, j):
    assert set(t) == set(j) and t["tag"] == j["tag"] == "batch"
    assert isinstance(t["sum"], np.ndarray) and int(t["sum"]) == int(
        j["sum"])
    assert isinstance(t["rows"], tuple)
    np.testing.assert_array_equal(t["rows"][0], j["rows"][0])


def _batches(n):
    rng = np.random.RandomState(7)
    return [rng.randint(0, 256, (2, 3), np.uint8) for _ in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_feeder_pull_equals_jax(depth):
    outs = []
    for mod, step in ((jfeeder, _jax_step), (tfeeder, _torch_step)):
        feeder = mod.DeviceFeeder(step, max_in_flight=depth)
        got = [feeder.submit(b, meta=i) for i, b in enumerate(_batches(6))]
        outs.append((got, feeder.drain()))
    (jgot, jdrain), (tgot, tdrain) = outs
    assert [g is None for g in tgot] == [g is None for g in jgot]
    assert sum(g is None for g in tgot) == depth
    tall = [g for g in tgot if g is not None] + tdrain
    jall = [g for g in jgot if g is not None] + jdrain
    assert [m for _, m in tall] == [m for _, m in jall] == list(range(6))
    for (t, _), (j, _) in zip(tall, jall):
        _same_result(t, j)


def test_device_feeder_pull_without_meta():
    feeder = tfeeder.DeviceFeeder(lambda b: torch.from_numpy(b) * 2,
                                  max_in_flight=1)
    assert feeder.submit(np.ones(2, np.int32)) is None
    got = feeder.submit(np.full(2, 5, np.int32))
    np.testing.assert_array_equal(got, [2, 2])
    np.testing.assert_array_equal(feeder.drain()[0], [10, 10])


def test_device_feeder_push_equals_jax():
    outs = []
    for mod, step in ((jfeeder, _jax_step), (tfeeder, _torch_step)):
        done = []
        feeder = mod.DeviceFeeder(step, max_in_flight=3,
                                  on_done=lambda r, m: done.append((r, m)))
        assert all(feeder.submit(b, meta=i) is None
                   for i, b in enumerate(_batches(7)))
        assert feeder.drain() == []
        assert len(done) == 7       # drain waits for every delivery
        feeder.close()
        assert feeder._collector is None and feeder._queue is None
        outs.append(done)
    assert [m for _, m in outs[1]] == [m for _, m in outs[0]] == \
        list(range(7))
    for (t, _), (j, _) in zip(outs[1], outs[0]):
        _same_result(t, j)


def _backpressure(mod, step, depth):
    """Submits until one blocks behind a held on_done: how many returned
    before the release, and whether the blocked one finished after it."""
    release = threading.Event()
    delivered = []

    def on_done(r, m):
        release.wait(5)
        delivered.append(m)

    feeder = mod.DeviceFeeder(step, max_in_flight=depth, on_done=on_done)
    returned = []

    def produce():
        for i, b in enumerate(_batches(depth + 3)):
            feeder.submit(b, meta=i)
            returned.append(i)

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    # the producer returns depth + 1 times, then blocks until the release
    _wait_for(lambda: len(returned) >= depth + 1)
    time.sleep(0.2)
    before = len(returned)
    release.set()
    th.join(5)
    finished = not th.is_alive()
    feeder.close()
    return before, finished, delivered


@pytest.mark.parametrize("depth", [1, 2])
def test_device_feeder_backpressure_equals_jax(depth):
    t = _backpressure(tfeeder, _torch_step, depth)
    j = _backpressure(jfeeder, _jax_step, depth)
    # one result held in on_done, depth queued, the next submit blocks
    assert t[0] == j[0] == depth + 1
    assert t[1] and j[1]
    assert t[2] == j[2] == list(range(depth + 3))


def test_host_fetch_tree_matches_device_get():
    import jax
    from heimdall_tpu_torch.ops.blobs import BlobTable
    x = np.arange(6, dtype=np.int32).reshape(2, 3)
    tree = {"a": [torch.from_numpy(x), 3, "s"], "b": (torch.ones(2),),
            "c": None, "d": np.float32(2.5)}
    jtree = jax.device_get({"a": [jnp.asarray(x), 3, "s"],
                            "b": (jnp.ones(2),), "c": None,
                            "d": np.float32(2.5)})
    got = tfeeder.HostFetcher().fetch(tree)
    assert isinstance(got["a"], list) and isinstance(got["b"], tuple)
    np.testing.assert_array_equal(got["a"][0], jtree["a"][0])
    np.testing.assert_array_equal(got["b"][0], jtree["b"][0])
    assert got["a"][1:] == jtree["a"][1:] and got["c"] is None
    assert got["d"] == jtree["d"]
    got["a"][0][0, 0] = 99                 # a copy, not a view
    assert int(tree["a"][0][0, 0]) == 0
    table = BlobTable(*[torch.zeros(1, 2)] * (len(BlobTable._fields) - 1),
                      torch.zeros(1, dtype=torch.int32))
    assert isinstance(tfeeder.HostFetcher().fetch(table), BlobTable)


# -- PinnedUploader (its CPU path; the card's in test_torch_line_cuda.py) --

def test_pinned_uploader_cpu_returns_copies():
    up = tfeeder.PinnedUploader(slots=2, device="cpu")
    buf = np.arange(12, dtype=np.uint8).reshape(3, 4)
    outs = []
    for i in range(5):
        buf[:] = i
        outs.append(up.upload(buf))
    slot = up.host_slot((2, 2), np.int32)
    slot[:] = 7
    outs.append(up.upload(slot))
    slot[:] = 8                              # the caller reuses the slot
    assert [int(o.flatten()[0]) for o in outs] == [0, 1, 2, 3, 4, 7]
    assert outs[-1].dtype == torch.int32 and outs[-1].shape == (2, 2)


def test_pinned_uploader_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfeeder.PinnedUploader()
    with pytest.raises(ValueError):
        tfeeder.PinnedUploader(slots=0, device="cpu")


# -- native_bridge ---------------------------------------------------------

def _defect_img():
    img = np.full((96, 128, 3), 200, np.uint8)
    img[40:56, 60:76] = 20
    img[10:16, 10:18] = 30
    return img


def _strip(out):
    return {k: v for k, v in out.items() if k != "processing_time"}


def test_native_bridge_native_path_equals_jax():
    assert tnb.is_available() and jnb.is_available()
    img = _defect_img()
    assert _strip(tnb.detect_contamination(img)) == \
        _strip(jnb.detect_contamination(img))
    rnd = np.random.RandomState(0).randint(0, 255, (64, 64, 3), np.uint8)
    t, j = tnb.process_image(rnd), jnb.process_image(rnd)
    assert t["backend"] == j["backend"] == "native"
    for k in ("processed_image", "gray"):
        np.testing.assert_array_equal(t[k], j[k])
    tc = tnb.process_image(img, "contamination")
    assert _strip(tc) == _strip(jnb.process_image(img, "contamination"))


def test_native_bridge_fallback_equals_jax(monkeypatch):
    monkeypatch.setattr(jnb, "_load", lambda: None)
    monkeypatch.setattr(tnb, "_load", lambda: None)
    img = _defect_img()
    t = tnb.detect_contamination(img, device="cpu")
    j = jnb.detect_contamination(img)
    assert t["backend"] == j["backend"] == "python"
    assert t["defect_count"] == j["defect_count"] >= 1
    for dt, dj in zip(t["defects"], j["defects"]):
        for k in ("type", "position", "bounding_box"):
            assert dt[k] == dj[k]
        for k in ("size", "confidence"):
            assert dt[k] == pytest.approx(dj[k], abs=1e-6)
    rnd = np.random.RandomState(0).randint(0, 255, (64, 64, 3), np.uint8)
    tp = tnb.process_image(rnd, device="cpu")
    jp = jnb.process_image(rnd)
    assert tp["backend"] == jp["backend"] == "python"
    np.testing.assert_array_equal(tp["processed_image"],
                                  jp["processed_image"])


def test_native_bridge_fallback_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(tnb, "_load", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tnb.detect_contamination(_defect_img())


def test_benchmark_processing_reports_gpu_ms():
    out = tnb.benchmark_processing(np.full((64, 64, 3), 128, np.uint8),
                                   iterations=3, device="cpu")
    assert out["native_ms_per_frame"] > 0 and out["gpu_ms_per_frame"] > 0
    assert "tpu_ms_per_frame" not in out
    assert out["speedup"] == pytest.approx(
        out["native_ms_per_frame"] / out["gpu_ms_per_frame"])


# -- recovery ----------------------------------------------------------------

def _recovery_trace(rec):
    out = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise rec.AcquisitionError("transient")
        return "ok"

    out.append((rec.with_recovery(
        flaky, rec.RecoveryStrategy(retry_count=5, delay_s=0.001)),
        calls["n"]))
    resets = []
    calls["n"] = 0

    def dev():
        calls["n"] += 1
        if calls["n"] < 2:
            raise rec.DeviceError("gone")
        return 1

    out.append((rec.with_recovery(
        dev, rec.RecoveryStrategy(retry_count=2, delay_s=0.001,
                                  action=rec.RecoveryAction.RESET_DEVICE),
        on_reset=lambda: resets.append(1)), len(resets)))
    try:
        rec.with_recovery(lambda: (_ for _ in ()).throw(
            rec.AcquisitionError("no")),
            rec.RecoveryStrategy(retry_count=2, delay_s=0.001))
    except rec.AcquisitionError as exc:
        out.append(str(exc))
    for exc in (rec.AcquisitionError("x"), rec.DeviceLostError("x"),
                rec.ConfigurationError("x"), ValueError("x"),
                rec.HeimdallError("x", rec.ErrorCategory.FATAL)):
        s = rec.RecoveryStrategy.for_error(exc)
        out.append((s.action.value, s.retry_count))
    inj = rec.FaultInjector(failure_probability=0.4, seed=5)
    fired = []
    for _ in range(30):
        try:
            inj.maybe_fail()
            fired.append(0)
        except rec.AcquisitionError:
            fired.append(1)
    out.append(fired)
    br = rec.CircuitBreaker(failure_threshold=2, reset_timeout_s=0.05)
    states = []
    for fn in (lambda: 1 / 0, lambda: 1 / 0, lambda: 1, "wait", lambda: 1):
        if fn == "wait":
            time.sleep(0.06)
            continue
        try:
            br.call(fn)
            states.append(("ok", br.state))
        except rec.CircuitBreakerOpen:
            states.append(("open", br.state))
        except ZeroDivisionError:
            states.append(("err", br.state))
    out.append(states)
    return out


def test_recovery_equals_jax():
    t, j = _recovery_trace(trec), _recovery_trace(jrec)
    assert t == j
    assert t[0] == ("ok", 3) and t[1] == (1, 1)
    assert sum(t[-2]) and not all(t[-2])
    assert t[-1][-1] == ("ok", "closed")


def test_watchdog_fires_and_recovers():
    for rec in (trec, jrec):
        fired = []
        wd = rec.Watchdog(0.5, lambda: fired.append(1), name="wd")
        wd.start()
        for _ in range(10):
            wd.kick()
            time.sleep(0.01)
        kicked = wd.timeouts
        assert _wait_for(lambda: wd.timeouts >= 1)
        wd.stop()
        assert kicked == 0 and fired
        assert wd._thread is None


# -- scheduler ---------------------------------------------------------------

def _scheduler_trace(sched):
    counter = {"ap": 0, "sp": 0}
    ap = sched.RtTask("ap", lambda: counter.update(ap=counter["ap"] + 1),
                      kind=sched.TaskKind.APERIODIC)
    sp = sched.RtTask("sp", lambda: counter.update(sp=counter["sp"] + 1),
                      kind=sched.TaskKind.SPORADIC, min_interarrival_s=10.0)
    slow = sched.RtTask("slow", lambda: time.sleep(0.03),
                        kind=sched.TaskKind.APERIODIC, deadline_s=0.01)
    s = sched.RtScheduler()
    for task in (ap, sp, slow):
        s.add_task(task)
    s.start_all()
    for _ in range(3):
        ap.execute()
        sp.execute()
    slow.execute()
    _wait_for(lambda: counter["ap"] == 3 and slow.stats.executions == 1)
    ap.pause()
    ap.execute()                       # dropped while paused
    ap.resume()
    s.stop_all()
    paused = counter["ap"]
    stats = s.stats()
    return (counter, paused, sorted(stats), {
        k: sorted(v) for k, v in stats.items()},
        stats["slow"]["deadline_misses"], stats["ap"]["executions"])


def test_scheduler_equals_jax():
    t, j = _scheduler_trace(tsched), _scheduler_trace(jsched)
    assert t == j
    assert t[0] == {"ap": 3, "sp": 1} and t[1] == 3 and t[4] == 1


def test_periodic_task_runs_through_the_native_library():
    n = {"k": 0}
    task = tsched.RtTask("tick", lambda: n.update(k=n["k"] + 1),
                         kind=tsched.TaskKind.PERIODIC, period_s=0.02,
                         cpu=0)
    task.start()
    assert _wait_for(lambda: n["k"] >= 3)
    task.stop()
    assert task.stats.executions == n["k"]
    assert tnb._load() is not None


# -- ipc and net -------------------------------------------------------------

def test_shared_memory_channel_across_packages():
    """A frame the port writes reads back through JAX's channel, and the
    reverse: the slot layout is the same."""
    frames = np.random.RandomState(2).randint(0, 256, (5, 12, 16), np.uint8)
    for writer_mod, reader_mod, name in ((tipc, jipc, "hd_t2j"),
                                         (jipc, tipc, "hd_j2t")):
        w = writer_mod.SharedMemoryFrameChannel(name, (12, 16), slots=3,
                                                create=True)
        try:
            r = reader_mod.SharedMemoryFrameChannel(name, (12, 16), slots=3)
            assert r.latest() is None
            for i, f in enumerate(frames):
                w.write(f, 100 + i)
            got, fid, ts = r.latest()
            np.testing.assert_array_equal(got, frames[-1])
            assert fid == 104 and ts > 0
            r.close()
        finally:
            w.close()


def test_message_broker_equals_jax():
    out = []
    for mod in (tipc, jipc):
        b = mod.MessageBroker()
        s1, s2 = b.subscribe("verdict"), b.subscribe("verdict", maxsize=1)
        n = [b.publish("verdict", {"id": i}) for i in range(3)]
        got = [s1.get(timeout=1) for _ in range(3)]
        b.unsubscribe(s1)
        n.append(b.publish("verdict", "x"))
        n.append(b.publish("nobody", "y"))
        out.append((n, got, s2.try_get(), s2.try_get(), b.stats()))
    assert out[0] == out[1]


def test_net_equals_jax():
    for fn, args in (("same_subnet", ("192.168.1.5", "192.168.1.77")),
                     ("same_subnet", ("192.168.1.5", "192.168.2.7", 24)),
                     ("subnet_hosts", ("10.0.0.0/29",)),
                     ("humanize_bytes", (1536,)),
                     ("humanize_bytes", (3.5e9,)),
                     ("humanize_duration", (0.0042,)),
                     ("humanize_duration", (3725,)),
                     ("camera_bandwidth_bps", (1920, 1080, 50))):
        assert getattr(tnet, fn)(*args) == getattr(jnet, fn)(*args), fn
    cams = [{"width": 1920, "height": 1080, "fps": 50}] * 4
    assert tnet.bandwidth_report(cams) == jnet.bandwidth_report(cams)
    assert tnet.list_interfaces() == jnet.list_interfaces()
    assert tnet.probe_tcp("127.0.0.1", 1, timeout_s=0.2)[0] is \
        jnet.probe_tcp("127.0.0.1", 1, timeout_s=0.2)[0] is False
