#!/usr/bin/env python3
"""End-to-end model workflow on the card: capture -> train -> quantize ->
deploy (port of examples/model_training.py).

The loop runs on simulated line data:

  1. capture training frames and weak labels from the classical detector
     (models/capture.py; the fused kernel on the card),
  2. train the U-Net defect segmenter on the captured masks (float32,
     cuDNN without TF32, the port's optax.adam),
  3. post-training-quantize it to int8,
  4. drop the quantized model into the detector stack and compare its
     verdicts with the float model and the classical detector (the
     segmentation detector labels with 6 of JAX's sweeps, PyTorch ops).

Usage: python -m heimdall_tpu_torch.examples.model_training [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from heimdall_tpu_torch.core.acquisition import SimulationImageSource
from heimdall_tpu_torch.detectors.contamination_detector import (
    ContaminationDetector)
from heimdall_tpu_torch.models.capture import TrainingDataCapture
from heimdall_tpu_torch.models.quantized import QuantizedSegmenter
from heimdall_tpu_torch.models.segmentation import (DefectSegmenter,
                                                    SegmentationDetector)


def main(argv=None, n_frames: int = 48, steps: int = 80):
    """Runs the workflow on ``--device`` (CUDA unless "cpu"); n_frames and
    steps are JAX's numbers, cut only by tests.  Returns the figures it
    prints: {"captured", "with_defects", "losses" (every step's),
    "agreement", "defects" (detector -> count on 8 test frames)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain path")
    args = ap.parse_args(argv)
    device = args.device

    # 1. capture: classical detector provides weak labels -----------------
    src = SimulationImageSource("capture", {
        "width": 128, "height": 96, "seed": 7, "defect_probability": 1.0})
    src.open()
    det = ContaminationDetector(config={"include_contours": False,
                                        "min_contaminant_size": 3},
                                device=device)
    capture_dir = tempfile.mkdtemp(prefix="heimdall_capture_")
    cap = TrainingDataCapture(capture_dir, shard_size=16)
    frames = np.stack([src.read()[1] for _ in range(n_frames)])
    results = det.detect_batch(frames)
    n_def = cap.add_batch(frames, results)
    cap.flush()
    print(f"captured {n_frames} frames, {n_def} with defects, "
          f"shards in {capture_dir}")
    out = {"captured": n_frames, "with_defects": n_def, "losses": []}

    # 2. train the segmenter on captured masks ----------------------------
    imgs, masks = cap.dataset_masks()
    seg = DefectSegmenter(base=8, seed=0, learning_rate=3e-3, device=device)
    for step in range(steps):
        loss = seg.train_step(imgs, masks)
        out["losses"].append(loss)
        if step % 20 == 0:
            print(f"  train step {step}: loss {float(loss):.4f}")

    # 3. int8 post-training quantization ----------------------------------
    qseg = QuantizedSegmenter.from_segmenter(seg, imgs[:16])
    p_float = seg.predict(imgs[:8])
    p_int8 = qseg.predict(imgs[:8])
    agree = np.mean((p_float > 0.5) == (p_int8 > 0.5))
    print(f"int8 vs float mask agreement: {agree:.4f}")
    out["agreement"] = float(agree)

    # 4. deploy through the detector stack --------------------------------
    test = np.stack([src.read()[1] for _ in range(8)])
    det_f = SegmentationDetector(seg, config={"min_contaminant_size": 3},
                                 device=device)
    det_q = SegmentationDetector(qseg, config={"min_contaminant_size": 3},
                                 device=device)
    out["defects"] = {}
    for name, d in (("float", det_f), ("int8", det_q)):
        found = sum(len(r) for r in d.detect_batch(test))
        print(f"  {name} segmentation detector: {found} defects "
              f"on {len(test)} frames")
        out["defects"][name] = found
    classical = sum(len(r) for r in det.detect_batch(test))
    print(f"  classical detector: {classical} defects (reference count)")
    out["defects"]["classical"] = classical
    src.close()
    return out


if __name__ == "__main__":
    main()
