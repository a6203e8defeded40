"""Where B5b-sp's cluster kernel (csrc/ccl_tiled.cu, k_fill_shard) spends
its time: builds a copy of ccl_tiled.cu with clock64() stamps of each
block's thread 0 after a block barrier at the kernel's phases, runs
hd_flood_fill_sp once on the bench shard (the second shard of four of 4
bench frames of 1920x1080, [4, 270, 1920]) with random reached halos, with
empty halos, and on the first shard, checks each result against
flood_sp_reference, and prints per phase the mean and largest cycles over
the blocks, and the row + column iterations and rounds a block ran:

    load        the mask read into bits, the seeds
    fixpoint1   the first round's row and column passes
    exchange1   the first round's edge rows and gains across the cluster
                (two cluster barriers; the wait for the slowest block)
    rounds      the later rounds, and the break
    store       the filled rows still to store (a block that gained
                nothing in the last round stored them during its barrier)

The stamps are text-injected after the source's own lines, so the script
fails where the kernel's text no longer has them.  Needs nvcc and a card:

    python -m heimdall_tpu_torch.scripts.stamp_fill_shard

Prints the card (nvidia-smi's name and power limit), the SM clock and one
JSON line.
"""

import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from heimdall_tpu_torch import scene
from heimdall_tpu_torch.ops import _cuda
from heimdall_tpu_torch.ops import ccl_tiled as ct
from heimdall_tpu_torch.ops import fused_kernels as fk
from heimdall_tpu_torch.scripts import timing

H, W, SHARDS, BATCH = 1080, 1920, 4, 4
PHASES = ("load", "fixpoint1", "exchange1", "rounds", "store")
_STAMP = """
__device__ unsigned long long g_stamp[64][8];
__device__ int g_count[64][2];
#define STAMP(k) do { __syncthreads(); \\
  int blk_ = blockIdx.y * gridDim.x + blockIdx.x; \\
  if (threadIdx.x == 0 && blk_ < 64) \\
    g_stamp[blk_][k] = clock64(); } while (0)
"""
# (anchor in k_fill_shard, text put after it)
_AFTER = (
    ("namespace cg = cooperative_groups;\n", _STAMP),
    ("  bool started = false;\n",
     "  int n_it = 0, n_rd = 0;\n  STAMP(0);\n"),
    ("  // The filled plane of the block's rows, from BG and R.\n",
     "  STAMP(1);\n"),
    ("      ch = __syncthreads_or(column_pass(g, BG, R, rows));\n",
     "      ++n_it;\n"),
    ("    // Each block stores its edge rows into its neighbours' shared "
     "memory\n", "    if (n_rd++ == 0) STAMP(2);\n"),
    ("    asm volatile(\"barrier.cluster.wait.acquire.aligned;\" ::: "
     "\"memory\");\n", "    if (n_rd == 1) STAMP(3);\n"),
    ("    if (!__syncthreads_or(threadIdx.x < g.C && s_gain[threadIdx.x]))"
     " break;\n  }\n", "  STAMP(4);\n"),
    ("  if (!stored) store();\n",
     "  STAMP(5);\n  if (threadIdx.x == 0 && blockIdx.y * gridDim.x + "
     "blockIdx.x < 64) {\n    g_count[blockIdx.y * gridDim.x + blockIdx.x]"
     "[0] = n_it;\n    g_count[blockIdx.y * gridDim.x + blockIdx.x][1] = "
     "n_rd;\n  }\n"),
)
_READ = """
extern "C" int hd_stamps(unsigned long long* stamps, int* counts) {
  cudaError_t e = cudaMemcpyFromSymbol(stamps, g_stamp, sizeof(g_stamp));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(counts, g_count, sizeof(g_count));
  return (int)e;
}
"""


def stamped_source() -> str:
    src = (_cuda.CSRC / "ccl_tiled.cu").read_text()
    for anchor, text in _AFTER:
        if src.count(anchor) != 1:
            raise SystemExit(f"k_fill_shard's text changed: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + _READ


def build(tmp: Path) -> ctypes.CDLL:
    cu = tmp / "ccl_tiled_stamped.cu"
    cu.write_text(stamped_source())
    so = tmp / "ccl_tiled_stamped.so"
    subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I",
                    str(_cuda.CSRC), "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.hd_flood_fill_sp.argtypes = [P, I, I, I, I, I, P, P, P, P, P, P]
    lib.hd_stamps.argtypes = [P, P]
    return lib


def run(lib, mask, row_off, halo_top, halo_bot) -> dict:
    B, hl, w = mask.shape
    out = torch.empty_like(mask, dtype=torch.bool)
    ptr = [None if h is None else h.data_ptr() for h in (halo_top, halo_bot)]
    for _ in range(3):
        err = lib.hd_flood_fill_sp(mask.data_ptr(), B, hl, w, row_off, H,
                                   *ptr, None, None, out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"hd_flood_fill_sp: CUDA error {err}")
    torch.cuda.synchronize()
    equal = torch.equal(out, ct.flood_sp_reference(mask, row_off, H,
                                                   halo_top, halo_bot))
    stamps = np.zeros((64, 8), np.uint64)
    counts = np.zeros((64, 2), np.int32)
    lib.hd_stamps(stamps.ctypes.data, counts.ctypes.data)
    blocks = B * min(16, hl)
    st = stamps[:blocks, :6].astype(np.int64)
    d = st[:, 1:] - st[:, :-1]
    return {"equal": equal,
            "cycles": {p: {"mean": float(d[:, k].mean()),
                           "max": int(d[:, k].max())}
                       for k, p in enumerate(PHASES)},
            "total": {"mean": float((st[:, 5] - st[:, 0]).mean()),
                      "max": int((st[:, 5] - st[:, 0]).max())},
            "iterations": [int(counts[:blocks, 0].min()),
                           int(counts[:blocks, 0].max())],
            "rounds": [int(counts[:blocks, 1].min()),
                       int(counts[:blocks, 1].max())]}


def main() -> dict:
    timing.require_card()
    print(timing.card(), flush=True)
    frames = torch.from_numpy(scene.make_frames(BATCH, H, W, seed=2)).cuda()
    mask = (fk.preprocess(frames, 15)[1] > 0).to(torch.uint8)
    hl = H // SHARDS
    rng = np.random.RandomState(11)
    ht, hb = (torch.from_numpy(rng.rand(BATCH, W) < 0.5).to(torch.uint8)
              .cuda() for _ in range(2))
    out = {"card": timing.card(), "shard": [BATCH, hl, W]}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        second = mask[:, hl:2 * hl].contiguous()
        for name, args in (
                ("random_halos", (second, hl, ht, hb)),
                ("empty_halos", (second, hl, torch.zeros_like(ht),
                                 torch.zeros_like(hb))),
                ("first_shard", (mask[:, :hl].contiguous(), 0, None,
                                 torch.zeros_like(hb)))):
            out[name] = r = run(lib, *args)
            print(f"{name}: equal {r['equal']}, iterations {r['iterations']}"
                  f", rounds {r['rounds']}; cycles (mean / max over blocks) "
                  + ", ".join(f"{p} {c['mean']:.0f} / {c['max']}"
                              for p, c in r["cycles"].items())
                  + f"; total {r['total']['mean']:.0f} / "
                  f"{r['total']['max']}", flush=True)
    out["sm_clock_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"SM clock {out['sm_clock_mhz']}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
