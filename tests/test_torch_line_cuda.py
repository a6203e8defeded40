"""The line path on the card (marked ``cuda``; each test skips where
torch.cuda.is_available() is false): the pinned uploader's slots, the
device feeder in both modes, the line simulation's verdicts and the
uniformity correction, each against the port's CPU path.  This file
imports no JAX:

    python -m pytest tests/test_torch_line_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.examples import line_simulation
from heimdall_tpu_torch.lighting.calibration import UniformityCalibrator
from heimdall_tpu_torch.runtime.feeder import (DeviceFeeder, HostFetcher,
                                               PinnedUploader, record_done)

# a line batch small enough that the host writes all of the test's
# batches well inside the copy stream's held half second
BATCH = (8, 480, 640)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("through_slot", [False, True])
def test_overwriting_a_batch_after_submit_keeps_its_result(card,
                                                           through_slot):
    """Batches go up back to back through 2 slots while the copy stream is
    held behind a spin kernel, so every copy after the first is still
    pending when its slot comes round again; the caller's array is
    overwritten right after each upload returns.  Each device tensor must
    hold its own batch: a slot written again before its copy completed
    would mix two batches."""
    # load the kernels first: a kernel's first launch loads its module,
    # which can wait for the device and so for the held copy stream
    warm = torch.zeros(BATCH, dtype=torch.uint8, device=card)
    warm.amin(), warm.amax()
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    up = PinnedUploader(slots=2, device=card)
    mine = np.zeros(BATCH, np.uint8)
    outs = []
    for i in range(8):
        buf = up.host_slot(BATCH) if through_slot else mine
        buf[:] = i
        x = up.upload(buf)
        if not through_slot:
            mine[:] = 255                # the caller's array, overwritten
        if i == 0:
            with torch.cuda.stream(up._copy_stream):
                torch.cuda._sleep(1_000_000_000)   # about 0.5 s
        outs.append((x.amin(), x.amax()))
    got = [(int(a), int(b)) for a, b in outs]
    assert got == [(i, i) for i in range(8)]


@pytest.mark.cuda
def test_feeder_results_survive_overwritten_batches(card):
    det = ContaminationDetector(config={"include_contours": False,
                                        "use_color": False})
    cpu = ContaminationDetector(config={"include_contours": False,
                                        "use_color": False}, device="cpu")
    up = PinnedUploader(slots=3, device=card)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 256, (4, 480, 640), np.uint8)
               for _ in range(6)]
    for b in batches[::2]:
        b[:, 200:230, 300:330] = 10        # a dark blob on every other one
    want = [[t.numpy() for t in cpu.verdict_device(b)] for b in batches]
    for push in (True, False):
        got = {}
        feeder = DeviceFeeder(lambda b: det.verdict_device(up.upload(b)),
                              max_in_flight=2,
                              on_done=(lambda r, m: got.__setitem__(m, r))
                              if push else None)
        buf = np.empty_like(batches[0])
        for i, b in enumerate(batches):
            buf[:] = b
            out = feeder.submit(buf, meta=i)
            buf[:] = 0                     # the caller reuses its buffer
            if out is not None:
                got[out[1]] = out[0]
        for r, m in feeder.drain():
            got[m] = r
        feeder.close()
        assert sorted(got) == list(range(len(batches)))
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[i][0], w[0])
            np.testing.assert_array_equal(got[i][1], w[1])


@pytest.mark.cuda
def test_fetch_waits_only_for_its_own_batch(card):
    """A fetch after a batch's event returns while later work queued on
    the compute stream is still running."""
    x = torch.arange(8, device=card)
    y = x * 2
    done = record_done(y)
    torch.cuda._sleep(200_000_000)       # ~0.1 s or more of later work
    later = torch.cuda.Event()
    later.record()
    got = HostFetcher().fetch(y, done)
    assert not later.query()
    np.testing.assert_array_equal(got, np.arange(8) * 2)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(480, 640), (1080, 1920)])
def test_line_simulation_verdicts_on_card(card, size):
    h, w = size
    bph, p99, d = line_simulation.main(1.0, 2, width=w, height=h,
                                       return_detail=True,
                                       keep_batches=3)
    cpu = ContaminationDetector(config={"include_contours": False,
                                        "use_color": False}, device="cpu")
    memo = {}
    for frames, flags, confs in d["batches"]:
        for k, f in enumerate(frames):
            key = f.tobytes()
            if key not in memo:
                memo[key] = [t.numpy()[0] for t in cpu.verdict_device(f[None])]
            assert flags[k] == memo[key][0] and confs[k] == memo[key][1]
    assert bph > 0 and p99 > 0 and d["bottles"] == 2 * d["n_batches"]


@pytest.mark.cuda
def test_apply_on_device_on_card(card):
    cal = UniformityCalibrator(31)
    rng = np.random.RandomState(0)
    cal.build_map(rng.randint(100, 200, (4, 480, 640), np.uint8))
    for shape in ((4, 480, 640), (2, 480, 640, 3)):
        frames = rng.randint(0, 256, shape, np.uint8)
        on_card = cal.apply_on_device(frames)
        assert on_card.is_cuda
        assert torch.equal(on_card.cpu(), cal.apply_on_device(
            torch.from_numpy(frames)))
