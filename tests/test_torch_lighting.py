"""The port's lighting stack against heimdall_tpu's: controllers and their
wire frames, the synchronizers, the calibration loops and the uniformity
map, and the monitor's alerts.

Host code is a copy, so serial and ethernet frames, PID and adjuster
sequences, trends and alerts must be equal.  ``build_map``, ``apply`` and
``apply_on_device`` (PyTorch on the frames' device here, jnp in JAX) are
exact, and a map saved by either package loads in the other.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heimdall_tpu.lighting as jl
import heimdall_tpu_torch.lighting as tl
from heimdall_tpu.lighting import external_sync as jext
from heimdall_tpu.lighting import monitoring as jmon
from heimdall_tpu.lighting import sync as jsync
from heimdall_tpu_torch.lighting import external_sync as text
from heimdall_tpu_torch.lighting import monitoring as tmon
from heimdall_tpu_torch.lighting import sync as tsync


def _controller_trace(lib):
    out = []
    for kind in ("serial", "ethernet"):
        ctrl = lib.LightingControllerFactory.create(kind, f"c_{kind}",
                                                    n_channels=3)
        ctrl.initialize()
        ctrl.turn_on(0)
        ctrl.set_intensity(1, 0.5)
        ctrl.set_intensity(2, 1.7)            # clamped
        ctrl.strobe(1, 1234.9)
        ctrl.trigger_all(50.0)
        ctrl.turn_off(0)
        states = [(s.is_on, s.intensity, s.activation_count)
                  for s in (ctrl.get_channel_state(c) for c in range(3))]
        out.append((ctrl.sent, states, sorted(ctrl.health())))
    with pytest.raises(ValueError):
        lib.LightingControllerFactory.create("nope")
    out.append(type(lib.LightingControllerFactory.create("gpio")).__name__)
    return out


def test_controller_frames_equal_jax():
    t, j = _controller_trace(tl), _controller_trace(jl)
    assert t == j
    assert t[0][0][:2] == [b"@0N\r\n", b"@1I127\r\n"]


def _calibration_trace(lib):
    out = []
    pid = lib.PIDController()
    out.append([pid.update(e) for e in (50.0, 30.0, -10.0, 200.0, 0.0)])
    pid.reset()
    out.append(pid.update(5.0, dt=0.5))
    ctrl = lib.SimulatedLightingController(n_channels=1)
    ctrl.set_intensity(0, 0.2)
    adj = lib.AutoIntensityAdjuster(ctrl, 0, target_brightness=128,
                                    gain=0.004)
    out.append([adj.step(255 * ctrl.get_channel_state(0).intensity)
                for _ in range(40)])
    for alg in lib.IntensityAlgorithm:
        ctrl = lib.SimulatedLightingController(n_channels=1)
        ctrl.set_intensity(0, 0.9)
        a = lib.AdvancedAutoIntensityAdjuster(ctrl, 0, target_brightness=100,
                                              algorithm=alg, tolerance=5)
        final = a.calibrate(lambda: 255 * ctrl.get_channel_state(0)
                            .intensity, max_iters=80)
        out.append((alg.value, final, a.history))
    return out


def test_calibration_sequences_equal_jax():
    t, j = _calibration_trace(tl), _calibration_trace(jl)
    assert t == j
    for _, final, _ in t[3:]:
        assert abs(255 * final - 100) < 20


def _vignette(n=8, h=48, w=64, seed=0):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    v = 1.0 - 0.4 * (((y - h / 2) / (h / 2)) ** 2
                     + ((x - w / 2) / (w / 2)) ** 2)
    return np.clip(200 * v + rng.randn(n, h, w) * 2, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("k", [5, 9, 31])
def test_uniformity_map_exact(k):
    frames = _vignette()
    jc, tc = jl.UniformityCalibrator(k), tl.UniformityCalibrator(k)
    np.testing.assert_array_equal(tc.build_map(frames), jc.build_map(frames))
    assert tc.correction_map.dtype == np.float32
    np.testing.assert_array_equal(tc.apply(frames[0]), jc.apply(frames[0]))
    assert tc.uniformity_score(frames[0]) == jc.uniformity_score(frames[0])
    assert tc.uniformity_score(tc.apply(frames[0])) > \
        tc.uniformity_score(frames[0])


@pytest.mark.parametrize("shape", [(4, 48, 64), (3, 48, 64, 3)])
def test_apply_on_device_exact(shape):
    cal_j, cal_t = jl.UniformityCalibrator(9), tl.UniformityCalibrator(9)
    flat = _vignette()
    cal_j.build_map(flat)
    cal_t.build_map(flat)
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 256, shape).astype(np.uint8)
    frames.reshape(-1)[:4] = (0, 255, 128, 1)
    want = np.asarray(cal_j.apply_on_device(jnp.asarray(frames)))
    got = cal_t.apply_on_device(torch.from_numpy(frames))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # a numpy batch goes to the named device
    np.testing.assert_array_equal(
        cal_t.apply_on_device(frames, device="cpu").numpy(), want)
    if len(shape) == 3:
        np.testing.assert_array_equal(got.numpy(), cal_t.apply(frames))


def test_apply_on_device_rounds_half_to_even():
    """Products landing on .5 round to even, as jnp.rint does."""
    cal_j, cal_t = jl.UniformityCalibrator(), tl.UniformityCalibrator()
    cmap = np.full((2, 4), 0.5, np.float32)
    cmap[1] = 1.5
    cal_j.correction_map = cal_t.correction_map = cmap
    frames = np.array([[[1, 3, 5, 7], [1, 3, 171, 255]]], np.uint8)
    got = cal_t.apply_on_device(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(cal_j.apply_on_device(jnp.asarray(frames))))
    assert got.tolist() == [[[0, 2, 2, 4], [2, 4, 255, 255]]]


def test_apply_on_device_without_map_and_without_card(monkeypatch):
    cal = tl.UniformityCalibrator()
    frames = np.zeros((1, 2, 2), np.uint8)
    assert cal.apply_on_device(frames) is frames
    cal.build_map(_vignette(2, 8, 8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cal.apply_on_device(np.zeros((1, 8, 8), np.uint8))


def test_saved_maps_load_across_packages(tmp_path):
    frames = _vignette()
    for save_lib, load_lib in ((jl, tl), (tl, jl)):
        src = save_lib.UniformityCalibrator(5)
        src.build_map(frames)
        path = str(tmp_path / f"map_{save_lib.__name__}.npy")
        src.save(path)
        dst = load_lib.UniformityCalibrator()
        np.testing.assert_array_equal(dst.load(path), src.correction_map)
        np.testing.assert_array_equal(dst.apply(frames[1]),
                                      src.apply(frames[1]))
    with pytest.raises(ValueError):
        tl.UniformityCalibrator().save(str(tmp_path / "none.npy"))


def _monitor_trace(mon_mod, lib):
    ctrl = lib.SimulatedLightingController(n_channels=1)
    alerts = mon_mod.AlertManager()
    seen = []
    alerts.register_callback(lambda a: seen.append((a.level.value,
                                                    a.source, a.message)))
    mon = mon_mod.LightingMonitor(ctrl, alert_manager=alerts,
                                  anomaly_sigma=3)
    rng = np.random.RandomState(0)
    for i in range(25):
        mon.record(100.0 + rng.randn())
        mon.measurements[-1].timestamp = 1000.0 + i * 60.0
    mon.record(400.0)
    mon.measurements[-1].timestamp = 1000.0 + 25 * 60.0
    trend = mon.trend()
    n_active = len(alerts.active())
    alerts.acknowledge_all()
    alerts.raise_alert(mon_mod.AlertLevel.ERROR, "test", "boom")
    return (seen, n_active, len(alerts.active()), len(alerts.history),
            {k: round(v, 9) for k, v in trend.items()},
            sorted(mon.health_report()))


def test_monitor_alerts_equal_jax():
    t = _monitor_trace(tmon, tl)
    assert t == _monitor_trace(jmon, jl)
    assert t[1] >= 1 and t[2] == 1


def test_synchronizer_and_timing_equal_jax():
    for exposure in (500.0, 2000.0):
        assert vars(tsync.compute_strobe_timing(exposure)) == \
            vars(jsync.compute_strobe_timing(exposure))
    ctrl = tl.SimulatedLightingController(n_channels=1)
    sync = tl.LightingSynchronizer(ctrl, strobe_duration_us=10)
    sync.start()
    for _ in range(3):
        sync.send_event(tl.SyncEvent.CAMERA_TRIGGER)
    deadline = time.time() + 3
    while time.time() < deadline and sync.stats()["success"] < 3:
        time.sleep(0.02)
    sync.stop()
    stats = sync.stats()
    assert stats["success"] == 3 and ctrl.get_channel_state(0) \
        .activation_count == 3
    assert set(stats) == set(jl.LightingSynchronizer(
        jl.SimulatedLightingController(n_channels=1)).stats())
    jm = tsync.JitterMeasurement(expected_period_us=1000)
    for _ in range(5):
        jm.record_event()
    assert set(jm.stats()) == set(
        jsync.JitterMeasurement(expected_period_us=1000).stats())


def test_external_sync_pulses():
    sync = text.ExternalSynchronizer(poll_interval_s=0.0005)
    sync.add_source(text.TriggerSource.PROXIMITY_SENSOR,
                    text.SimulatedPulseSource(period_s=0.03),
                    debounce_s=0.005)
    seen = []
    sync.register_callback(seen.append)
    sync.start()
    deadline = time.time() + 5
    while len(seen) < 3 and time.time() < deadline:
        time.sleep(0.01)
    sync.stop()
    assert len(seen) >= 3
    assert sync.stats()["proximity_sensor"] >= 3
    assert [s.value for s in text.TriggerSource] == \
        [s.value for s in jext.TriggerSource]
