"""Times two kernels on the card, each CUDA launch apart:

* B6a, the stats kernel from a label plane (ops/split_kernels.py::
  stats_kernel, hd_stats_from_labels): on the label kernel's labels of
  ``batch`` bench frames of 640x480 (K = 64), us/frame;
* B5b-sp, the shard hole fill (ops/ccl_tiled.py::flood_fill_sp,
  hd_flood_fill_sp): on the second shard of four of 4 bench frames of
  1920x1080 ([4, 270, 1920], random reached halos on both cut rows), us a
  call; beside it B5b, the whole-frame fill (flood_fill), at batch 4 on
  1080x1920 and on the same [4, 270, 1920] masks (the frame's rules, no
  halos): whether a shard call loses its time to its size or to its
  halo rules.

A call's time is the mean over ``iters`` calls between CUDA events, queued
behind a spin kernel (scripts/timing.py::queued_ms), so only the card's
time counts; each CUDA kernel's mean device time comes from a
torch.profiler trace of ``iters`` more calls (opened with
perf/profiling.py's lead of fill kernels, which the profiler may drop).
Each beside its byte bound at 3.35 TB/s (B6a's, label_stats_bytes, counts
the labels, the frame bytes of this run's bbox windows and the tables;
chip_smoke.py's phase 5d uses the same function).

It uses whichever heimdall_tpu_torch is importable, so another checkout's
kernels are timed by the same script:

    python -m heimdall_tpu_torch.scripts.profile_stats_fill [batch] [iters]
    PYTHONPATH=OTHER_ROOT \\
        python heimdall_tpu_torch/scripts/profile_stats_fill.py [batch] [iters]

Prints the card (nvidia-smi's name and power limit), a line per
measurement and one JSON line.  Exits with an error where there is no
card.
"""

import json
import re
import sys

import numpy as np
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import ccl_tiled as ct
from heimdall_tpu_torch.ops import fused_kernels as fk
from heimdall_tpu_torch.ops import split_kernels as sk
from heimdall_tpu_torch.perf import profiling
from heimdall_tpu_torch.scripts import timing

CONTRAST = 15
K = 64
H2, W2 = 1080, 1920
SHARDS, SHARD_BATCH = 4, 4
HBM_BYTES_PER_S = 3.35e12
USAGE = ("usage: python -m heimdall_tpu_torch.scripts.profile_stats_fill "
         "[batch] [iters]")


def label_stats_bytes(labels, out):
    """Bytes the stats kernel from a label plane must move on these
    inputs: the label plane (4 B/px), the three frame bytes of each pixel
    in the union of a frame's bbox windows (the slot pixels lie in them),
    and the outputs (16 K + 1 int32 a frame); ``out`` is the stats
    kernel's (or its plain version's) output on them."""
    B, H, W = labels.shape
    bbox, n = out[1], out[3]
    K = bbox.shape[-1]
    used = torch.arange(K, device=bbox.device)[None] < n[:, None]
    b, k = torch.nonzero(used, as_tuple=True)
    x0, y0, x1, y1 = (bbox[b, i, k].long() for i in range(4))
    mark = torch.zeros((B, H + 1, W + 1), dtype=torch.int32,
                       device=bbox.device)
    for yy, xx, v in ((y0, x0, 1), (y0, x1 + 1, -1), (y1 + 1, x0, -1),
                      (y1 + 1, x1 + 1, 1)):
        mark.index_put_((b, yy, xx), torch.full_like(yy, v, dtype=torch.int32),
                        accumulate=True)
    covered = int((mark.cumsum(1).cumsum(2) > 0).sum())
    return B * H * W * 4 + covered * 3 + B * (16 * K + 1) * 4


def kernel_us(fn, iters: int) -> dict:
    """{CUDA kernel name: mean device us a call} over ``iters`` calls of
    fn, from a torch.profiler trace; names shortened to the kernel's
    identifier (k_..., or the name up to its first parenthesis)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiling.lead("cuda")
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or profiling.LEAD_KERNEL in e.name:
            continue
        m = re.search(r"(?:^|[\s:])(k_\w+)", e.name)
        name = m.group(1) if m else e.name.split("(")[0][:60]
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / iters
    return out


def measure(name: str, fn, iters: int, nbytes: int, per: int, unit: str):
    """One entry: the call's ms, its kernels' us a call, the byte bound."""
    fn()
    torch.cuda.synchronize()
    ms = timing.queued_ms(fn, iters)
    kernels = kernel_us(fn, iters)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{name:34s} {ms * 1e3 / per:9.3f} us/{unit} (bound "
          f"{bound_ms * 1e3 / per:.3f}); kernels, us a call: "
          f"{ {k: round(v, 3) for k, v in kernels.items()} }", flush=True)
    return {"ms": ms, "us_per_" + unit: ms * 1e3 / per,
            "bound_ms": bound_ms, "kernels_us": kernels}


def main(argv=None) -> dict:
    batch, iters = timing.batch_and_iters(
        sys.argv[1:] if argv is None else argv, USAGE)
    x = timing.bench_on_card(batch)
    smi = timing.card()
    print(f"{smi}  batch={batch} iters={iters}", flush=True)
    out = {"card": smi, "batch": batch, "iters": iters}

    labels = sk.label_kernel(x, CONTRAST)
    out["stats_kernel"] = measure(
        "B6a stats_kernel 640x480", lambda: sk.stats_kernel(x, labels, K),
        iters, label_stats_bytes(labels, sk.stats_kernel_reference(
            x, labels, K)), batch, "frame")
    del labels, x

    frames = scene.make_frames(SHARD_BATCH, H2, W2, seed=2)
    bench = torch.from_numpy(np.ascontiguousarray(frames)).cuda()
    mask = (fk.preprocess(bench, CONTRAST)[1] > 0).to(torch.uint8)
    hl = H2 // SHARDS
    shard = mask[:, hl:2 * hl].contiguous()
    rng = np.random.RandomState(11)
    ht, hb = (torch.from_numpy(rng.rand(SHARD_BATCH, W2) < 0.5)
              .to(torch.uint8).cuda() for _ in range(2))
    spx = SHARD_BATCH * hl * W2
    out["flood_fill_sp"] = measure(
        f"B5b-sp flood_fill_sp {SHARD_BATCH}x{hl}x{W2}",
        lambda: ct.flood_fill_sp(shard, hl, H2, ht, hb), iters,
        2 * spx + 2 * SHARD_BATCH * W2, 1, "call")
    out["flood_fill_shard_shape"] = measure(
        f"B5b flood_fill {SHARD_BATCH}x{hl}x{W2}",
        lambda: ct.flood_fill(shard), iters, 2 * spx, 1, "call")
    out["flood_fill_batch4"] = measure(
        f"B5b flood_fill {SHARD_BATCH}x{H2}x{W2}",
        lambda: ct.flood_fill(mask), iters, 2 * SHARD_BATCH * H2 * W2, 1,
        "call")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
