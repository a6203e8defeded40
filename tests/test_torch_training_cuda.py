"""The training path on the card against the port's CPU path (marked
``cuda``; each test skips where torch.cuda.is_available() is false).  This
file imports no JAX:

    python -m pytest tests/test_torch_training_cuda.py -q -m cuda --noconftest

Each step is held by tests/_torch_step_rule.py, the rule of the CPU
tests.

* The float32 UNet's train step keeps cuDNN's TF32 off through its
  backward: at 2 x 96 x 128 each gradient tensor on the card within 1e-5
  of its largest |g| of the CPU gradient (float32 noise; a TF32 backward
  lies about 1e-3 apart, which the test prints beside it), the flag as it
  was after the step, and the parameters after it within 1e-5; at 8 x 640
  x 480, where the CPU's own float32 gradient lies up to 1.5e-3 from
  float64, the card's step against the CPU's step in float64 at those
  tolerances.
* ProfilingSession.trace after train steps on the card lists its
  kernels.
* One step of ClassifierTrainer and of the autoencoder, card against CPU,
  as tests/test_torch_training_bf16.py holds them against JAX: loss within
  1e-4 relative; kernels' gradients within 1e-2 of their largest |g|, the
  bf16 layers' biases together at a cosine of at least 0.95; parameters
  within 1e-5 where |g_cpu| exceeds that noise, within 2 * lr elsewhere,
  at most 0.2% of them further than 1e-5 apart.
* AnomalyDetector.fit for one epoch on both: the loss and the threshold
  within 1e-3 relative.

The sharded train step on the card is in tests/test_torch_parallel_cuda.py.
"""

import numpy as np
import pytest
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.models import anomaly, defect_classifier, layers
from heimdall_tpu_torch.models import segmentation

import _torch_step_rule as rule

LR = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def grads(model):
    return {k: p.grad.detach().cpu().numpy().copy() for k, p in
            model.named_parameters()}


def params(model):
    return {k: p.detach().cpu().numpy().copy() for k, p in
            model.named_parameters()}


def step(loss, model):
    """One step in tests/_torch_step_rule.py's form: its loss, the
    gradients at the parameters before it and the parameters after it."""
    return {"loss": loss, "grads": grads(model), "params": params(model)}


@pytest.mark.cuda
def test_unet_train_step_keeps_tf32_off(card):
    frames = scene.ring_frames(2, 96, 128, seed=4)
    masks = frames[..., 1] < 60
    segs = {d: segmentation.DefectSegmenter(base=16, device=d)
            for d in (card, "cpu")}
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        losses = {d: s.train_step(frames, masks) for d, s in segs.items()}
        assert torch.backends.cudnn.allow_tf32 is True
        g_card, g_cpu = grads(segs[card].model), grads(segs["cpu"].model)
        errs = {k: float(np.abs(g_card[k] - v).max() / np.abs(v).max())
                for k, v in g_cpu.items()}
        # the same backward with TF32 on, for scale
        seg = segmentation.DefectSegmenter(base=16, device=card)
        x, _ = segmentation._to_model_input(frames, card)
        with layers.float32_convs(card):
            logits = seg.model(x)[:, 0]
        logits.float().pow(2).mean().backward()
        tf32 = grads(seg.model)
        seg.model.zero_grad()
        with layers.float32_convs(card):
            seg.model(x)[:, 0].float().pow(2).mean().backward()
        plain = grads(seg.model)
        tf32_err = max(float(np.abs(tf32[k] - v).max() / np.abs(v).max())
                       for k, v in plain.items())
    finally:
        torch.backends.cudnn.allow_tf32 = before
    print(f"UNet gradients, card against CPU: max {max(errs.values()):.3g}"
          f"; a backward in TF32: {tf32_err:.3g}")
    assert abs(losses[card] - losses["cpu"]) <= 1e-5 * losses["cpu"]
    assert max(errs.values()) <= 1e-5, errs
    p_card, p_cpu = params(segs[card].model), params(segs["cpu"].model)
    for k, v in p_cpu.items():
        np.testing.assert_allclose(p_card[k], v, atol=1e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.cuda
def test_unet_step_at_line_size_holds_float64(card):
    """At 8 x 640 x 480, where a weight's gradient sums 2.46 M terms a
    channel pair, the CPU's float32 gradient lies up to 1.5e-3 of a
    tensor's largest |g| from float64 (the CPU's sums), as far as a TF32
    backward: the card's float32 step, with TF32 allowed process-wide, is
    held against the CPU's step in float64 at the float32 tolerances."""
    frames = scene.ring_frames(8, 480, 640, seed=3)
    masks = frames[..., 1] < 60
    steps = {}
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for d, dtype in ((card, torch.float32), ("cpu", torch.float64)):
            seg = segmentation.DefectSegmenter(base=16, device=d)
            seg.model.to(dtype)
            steps[d] = step(seg.train_step(frames, masks), seg.model)
    finally:
        torch.backends.cudnn.allow_tf32 = before
    figures = rule.hold_step("UNet at 8x640x480", steps["cpu"], steps[card],
                             rule.f32_tols(steps["cpu"]["grads"]),
                             rule.F32_LOSS_TOL, LR)
    print(f"UNet at 8x640x480, card against float64: {figures}")


@pytest.mark.cuda
def test_profiling_trace_after_train_steps(card, tmp_path):
    """ProfilingSession.trace in a process that has trained on the card (a
    classifier, a UNet and an autoencoder step) lists the card's kernels
    in the trace of a UNet step at its first try: the trace opens with a
    lead of kernels for the profiler to drop (it drops a trace's first
    kernel records once this process has trained; ROADMAP.md, section C)
    and raises if either of its bracketing spin kernels is missing."""
    import json

    from heimdall_tpu_torch.perf.profiling import ProfilingSession

    rng = np.random.RandomState(2)
    clf = defect_classifier.DefectClassifier(seed=0, device=card)
    defect_classifier.ClassifierTrainer(clf).train_step(
        rng.randint(0, 256, (64, 32, 32, 1)).astype(np.uint8),
        rng.randint(0, 2, 64))
    frames = scene.ring_frames(2, 96, 128, seed=4)
    anomaly.AnomalyDetector(seed=0, device=card)._train_step(
        anomaly._tile_frames(frames[..., 1]))
    seg = segmentation.DefectSegmenter(base=16, device=card)
    seg.train_step(frames, frames[..., 1] < 60)
    session = ProfilingSession("after_training", device=card)
    with session.trace(str(tmp_path)):
        seg.train_step(frames, frames[..., 1] < 60)
    with open(session.trace_path) as fh:
        kernels = sum(1 for e in json.load(fh)["traceEvents"]
                      if e.get("cat") == "kernel")
    print(f"trace after training: {kernels} kernels at the first try")
    assert kernels > 2 and session.trace_kernels == kernels


@pytest.mark.cuda
def test_classifier_step_on_the_card_equals_cpu(card):
    rng = np.random.RandomState(2)
    patches = rng.randint(0, 256, (64, 32, 32, 1)).astype(np.uint8)
    labels = rng.randint(0, 2, 64)
    out = {}
    for d in (card, "cpu"):
        clf = defect_classifier.DefectClassifier(seed=0, device=d)
        out[d] = step(defect_classifier.ClassifierTrainer(clf).train_step(
            patches, labels), clf.model)
    rule.hold_step("classifier", out["cpu"], out[card],
                   rule.bf16_tols(out["cpu"]["grads"], "Dense_1"),
                   rule.BF16_LOSS_TOL, LR)


@pytest.mark.cuda
def test_autoencoder_on_the_card_equals_cpu(card):
    frames = scene.ring_frames(2, 128, 192, seed=5)[..., 1]
    tiles = anomaly._tile_frames(frames)
    out, fits = {}, {}
    for d in (card, "cpu"):
        ae = anomaly.AnomalyDetector(seed=0, device=d)
        out[d] = step(float(ae._train_step(tiles)), ae.model)
        fit = anomaly.AnomalyDetector(seed=0, device=d)
        fits[d] = (fit.fit(frames, epochs=1, batch_size=4), fit.threshold)
    rule.hold_step("autoencoder", out["cpu"], out[card],
                   rule.bf16_tols(out["cpu"]["grads"], "ConvTranspose_2"),
                   rule.BF16_LOSS_TOL, LR)
    for a, b in zip(fits[card], fits["cpu"]):
        assert abs(a - b) <= rule.FIT_TOL * b, (fits[card], fits["cpu"])
