#!/usr/bin/env python3
"""Basic smoke demo: simulation source + 2-stage pipeline with timings
(port of examples/test_basic.py; the stages run on the card unless
``--device cpu``).

Usage: python -m heimdall_tpu_torch.examples.test_basic [--device cpu]
"""

import argparse

from heimdall_tpu_torch.core.acquisition import SimulationImageSource
from heimdall_tpu_torch.core.pipeline import (GaussianBlurStage,
                                              GrayscaleStage, Pipeline)


def main(argv=None):
    """Runs 3 frames through grayscale + blur; returns each frame's
    processed image."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain path")
    args = ap.parse_args(argv)

    source = SimulationImageSource("demo", {"width": 640, "height": 480,
                                            "defect_probability": 0.5,
                                            "seed": 42})
    source.open()

    pipeline = Pipeline("basic_demo", instrumented=True, device=args.device)
    pipeline.add_stage(GrayscaleStage("grayscale"))
    pipeline.add_stage(GaussianBlurStage("blur", {"kernel_size": 5}))

    results = []
    for i in range(3):
        ok, frame = source.read()
        if not ok:
            raise RuntimeError("the simulation source returned no frame")
        ctx = pipeline.process(frame)
        print(f"frame {i}: success={ctx['success']} "
              f"result={ctx['result_image'].shape}")
        for stage, t in ctx["stage_times"].items():
            print(f"  {stage}: {t*1000:.2f} ms")
        results.append(ctx["result_image"])
    source.close()
    print("basic pipeline OK")
    return results


if __name__ == "__main__":
    main()
