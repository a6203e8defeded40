"""The port's GigE system and Aravis backend against heimdall_tpu's.

Simulated cameras are deterministic (a defect every 5th frame), so the
FrameSets of the two packages' GigESystems, and the batches
``FrameSet.to_batch`` assembles from them, are compared exactly.  The Aravis
binding runs the real ctypes and C-shim path against the fake libaravis in
a fresh subprocess per case (the shim caches its dlopen for the whole
process), for each package, and the two must report the same.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from heimdall_tpu.camera import gige as jgige
from heimdall_tpu.camera import hal as jhal
from heimdall_tpu_torch.camera import aravis as taravis
from heimdall_tpu_torch.camera import gige as tgige
from heimdall_tpu_torch.camera import hal as thal

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAKE = ROOT / "native" / "libaravis_fake.so"


def _system(mod, n=4, h=48, w=64, pattern="bottle", **kw):
    s = mod.GigESystem(backend="simulator", **kw)
    for i in range(n):
        s.add_camera(f"cam_{i}", {"width": w, "height": h, "fps": 10_000,
                                  "pattern": pattern})
    s.configure()
    return s


@pytest.mark.parametrize("pattern", ["bottle", "checker"])
def test_framesets_and_batches_equal_jax(pattern):
    got = []
    for mod in (jgige, tgige):
        s = _system(mod, pattern=pattern)
        s.start()
        sets = [s.acquire_frames() for _ in range(6)]
        s.stop()
        got.append((sets, s.frames_acquired, s.sync_manager.trigger_count))
    (jsets, jn, jt), (tsets, tn, tt) = got
    assert (tn, tt) == (jn, jt) == (24, 6)
    for j, t in zip(jsets, tsets):
        assert t.frame_id == j.frame_id
        assert t.has_all_cameras([f"cam_{i}" for i in range(4)])
        tb = t.to_batch()
        assert tb.shape == (4, 48, 64) and tb.dtype == np.uint8
        np.testing.assert_array_equal(tb, j.to_batch())
        for cid in t.frames:
            tf, jf = t.frames[cid], j.frames[cid]
            assert tf.frame_id == jf.frame_id
            np.testing.assert_array_equal(tf.histogram(), jf.histogram())
            assert (tf.mean(), tf.std_dev()) == (jf.mean(), jf.std_dev())
    # the deterministic defect: the 5th set (frame 4) has its dark disk
    assert tsets[4].to_batch().min() == 25 and tsets[3].to_batch().min() > 25


def test_to_batch_orders_cameras_by_id():
    frames = {cid: tgige.Frame(cid, np.full((2, 3), k, np.uint8), 0.0, 0)
              for k, cid in ((2, "cam_b"), (1, "cam_a"), (3, "cam_c"))}
    jframes = {cid: jgige.Frame(cid, f.data, 0.0, 0)
               for cid, f in frames.items()}
    t = tgige.FrameSet(frames, 0.0, 1).to_batch()
    np.testing.assert_array_equal(t, jgige.FrameSet(jframes, 0.0, 1)
                                  .to_batch())
    assert t[:, 0, 0].tolist() == [1, 2, 3]


def test_freerun_and_sync_stats():
    s = _system(tgige, n=1, h=32, w=32, sync_mode=tgige.SyncMode.FREERUN)
    with pytest.raises(thal.CameraError):
        s.sync_manager.trigger(list(s.cameras.values()))
    s.start()
    fs = s.acquire_frames(timeout_s=3.0)
    s.stop()
    assert "cam_0" in fs.frames and s._freerun_thread is None
    s = _system(tgige, n=1)
    s.start()
    for _ in range(5):
        s.acquire_frames()
    s.stop()
    st = s.sync_manager.stats()
    assert st["triggers"] == 5 and st["mean_interval_ms"] >= 0
    assert set(st) == set(jgige.SyncManager().stats())


def test_fault_injection_recovers_as_jax():
    """One camera, the injector's seeded sequence: every read recovers
    through with_recovery in both packages, with the same frames."""
    got = []
    for mod in (jgige, tgige):
        s = _system(mod, n=1, fault_probability=0.3)
        s.start()
        out = []
        for _ in range(5):
            try:
                out.append(s.acquire_frames().to_batch())
            except Exception:  # noqa: BLE001 - counted below
                out.append(None)
        s.stop()
        got.append((out, s.acquisition_errors, s.frames_acquired))
    (jout, jerr, jn), (tout, terr, tn) = got
    assert (terr, tn) == (jerr, jn)
    assert sum(o is not None for o in tout) >= 3
    for j, t in zip(jout, tout):
        assert (j is None) == (t is None)
        if t is not None:
            np.testing.assert_array_equal(t, j)


def test_discover_and_diagnostics_equal_jax():
    for mod in (jgige, tgige):
        assert mod.GigESystem(backend="simulator").discover() == \
            [f"cam_{i}" for i in range(4)]
    diags = []
    for mod in (jgige, tgige):
        s = _system(mod, n=2)
        s.start()
        diags.append(s.diagnostics())
        s.stop()
    jd, td = diags
    assert set(td) == set(jd)
    for k in ("cameras", "frames_acquired", "acquisition_errors"):
        assert td[k] == jd[k]
    # td["pass"] also gates on trigger jitter, which a loaded host breaks
    assert td["fps"] > 0


def test_camera_package_exports():
    import heimdall_tpu.camera as jcam
    import heimdall_tpu_torch.camera as tcam
    for name in ("Frame", "FrameSet", "GigESystem", "SyncManager",
                 "SyncMode", "CameraFactory", "CameraError"):
        assert hasattr(tcam, name) and hasattr(jcam, name)


def test_aravis_hw_backend_is_the_hardware_camera():
    cam = thal.CameraFactory.create("aravis-hw", "x", {"device_id": "d"})
    assert isinstance(cam, taravis.AravisHardwareCamera)
    assert type(jhal.CameraFactory.create("aravis-hw", "x")).__name__ == \
        type(cam).__name__


_ARAVIS = """
import json
import numpy as np
from {pkg}.camera.aravis import hardware_available, enumerate_hardware
from {pkg}.camera.hal import CameraError, CameraFactory
out = {{"hw": hardware_available(), "ids": enumerate_hardware()}}
if out["hw"]:
    cam = CameraFactory.create("aravis-hw", "cam0",
                               {{"device_id": out["ids"][0],
                                 "exposure_us": 2000.0}})
    cam.initialize()
    cam.start_acquisition()
    frames = [cam.acquire_frame(1.0) for _ in range(3)]
    cam.trigger()
    imgs = [f.to_ndarray() for f in frames]
    cam.stop_acquisition()
    cam.close()
    out.update(shape=list(imgs[0].shape),
               ids_seen=[f.frame_id for f in frames],
               sums=[int(i.astype(np.int64).sum()) for i in imgs],
               dark=[int((i < 40).sum()) for i in imgs],
               info=[cam.info().model, cam.info().max_width])
    bad = CameraFactory.create("aravis-hw", "c1",
                               {{"device_id": "NoSuchCamera"}})
else:
    bad = CameraFactory.create("aravis-hw", "c1", {{}})
try:
    bad.initialize()
    out["raised"] = None
except CameraError as e:
    out["raised"] = e.kind.value
print(json.dumps(out))
"""


def _aravis(pkg, lib):
    env = dict(os.environ, HEIMDALL_ARAVIS_LIB=lib, PYTHONPATH=str(ROOT),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_ARAVIS.format(pkg=pkg))],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("lib", ["fake", "absent"])
def test_aravis_through_the_shim_equals_jax(lib):
    if lib == "fake" and not FAKE.exists():
        pytest.fail("native/libaravis_fake.so is missing")
    path = str(FAKE) if lib == "fake" else "/nonexistent/libaravis.so"
    t = _aravis("heimdall_tpu_torch", path)
    assert t == _aravis("heimdall_tpu", path)
    if lib == "fake":
        assert t["ids"] == ["Fake-GigE-0", "Fake-GigE-1"]
        assert t["shape"] == [240, 320] and t["ids_seen"] == [1, 2, 3]
        assert t["dark"][0] > 50 and t["raised"] == "not_found"
    else:
        assert t["hw"] is False and t["ids"] == []
        assert t["raised"] == "not_found"
