"""Latency of a chain of dependent loads from shared memory on the card: the
block's own shared memory, the same through the cluster's window, and
another block's through that window (distributed shared memory), with one
cluster of 8 blocks in flight and with 1,024 blocks.  The run-table
union-finds (csrc/runtable_tiled.cu) are built around the answer: a block
reads other blocks' memory in one parallel round, never along a chain.

Every thread of 256 a block walks 1,000 steps x = s[x] over a 4,096-entry
permutation in shared memory; thread 0 of block 0 reads clock64 around its
walk.  Prints the card (nvidia-smi's name and power limit) and one JSON
line {"card": ..., "cycles_per_load": {case: cycles}}.

Usage: python -m heimdall_tpu_torch.scripts.probe_cluster_loads
"""

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from heimdall_tpu_torch.ops import _cuda

STEPS = 1000
CASES = {    # name: (mode of k_walk, blocks in clusters of 8)
    "own_smem_1_cluster": (0, 8),
    "own_smem_1024_blocks": (0, 1024),
    "window_own_block_1_cluster": (1, 8),
    "window_own_block_1024_blocks": (1, 1024),
    "window_other_block_1_cluster": (2, 8),
    "window_other_block_1024_blocks": (2, 1024),
}

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

// mode 0: the block's shared memory; 1: the same through the cluster's
// window; 2: the next block's through the window.
__global__ void k_walk(int mode, int steps, long long* cycles, int* sink) {
  __shared__ int s[4096];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < 4096; i += blockDim.x)
    s[i] = (i * 1103 + 17) & 4095;
  cluster.sync();
  unsigned rank = cluster.block_rank();
  const volatile int* p = s;
  if (mode == 1) p = cluster.map_shared_rank(s, rank);
  if (mode == 2) p = cluster.map_shared_rank(s, (rank + 1) % 8);
  int x = threadIdx.x;
  long long t0 = clock64();
  for (int k = 0; k < steps; ++k) x = p[x];
  long long t1 = clock64();
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
  sink[blockIdx.x * blockDim.x + threadIdx.x] = x;
  cluster.sync();
}

extern "C" int walk(int mode, int blocks, int steps, long long* cycles,
                    int* sink) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 8;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(256);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, k_walk, mode, steps, cycles, sink);
}
"""


def library() -> ctypes.CDLL:
    """The probe built with the port's nvcc flags into its build directory."""
    _cuda.BUILD_DIR.mkdir(exist_ok=True)
    key = hashlib.sha256((SOURCE + " ".join(_cuda.NVCC_FLAGS)).encode())
    out = _cuda.BUILD_DIR / f"probe_cluster_loads-{key.hexdigest()[:16]}.so"
    if not out.exists():
        src = out.with_suffix(".cu")
        src.write_text(SOURCE)
        subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.walk.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p]
    lib.walk.restype = ctypes.c_int
    return lib


def main() -> int:
    """Prints each case's cycles per dependent load."""
    if not torch.cuda.is_available():
        raise SystemExit("probe_cluster_loads runs on the card: no CUDA "
                         "device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    lib = library()
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1024 * 256, dtype=torch.int32, device="cuda")
    out = {}
    for name, (mode, blocks) in CASES.items():
        for _ in range(2):          # the first launch warms up
            err = lib.walk(mode, blocks, STEPS, cycles.data_ptr(),
                           sink.data_ptr())
            if err:
                raise RuntimeError(f"walk launch failed: CUDA error {err}")
            torch.cuda.synchronize()
        out[name] = int(cycles) / STEPS
    print(json.dumps({"card": card, "cycles_per_load": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
