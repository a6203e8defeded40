"""Where a step of the primitive microbench's kernels spends its time, in
the line-buffer design that csrc/primitives.cu replaced: a shifted read
through a warp's line buffer in shared memory, a transpose through a
padded [32][33] shared tile, mxu_cumsum's int carry repacked into bf16
each step, and a cross-row step with two cluster barriers.  Builds
clock64()-stamped copies of one step of each of its four kernels, runs
each on the microbench's planes (256 frames of 480x640 int32, the
script's RandomState(0) values) for N_STEPS steps, checks each result
against primitive_steps_reference, and prints the mean cycles a step of
each phase over the units that stamp:

    rows (min_scan_step, cumsum_ladder; a unit is a warp, a rung each
          step of the ladder):
        stores      the row into the warp's line buffer, between two
                    __syncwarp()s
        loads       the shifted reads into registers, with their index
                    tests (the stamp waits for the loads: an xor tree
                    over the values read)
        arithmetic  the min or add of each value with its read
    transpose_pair (a unit is a warp's 32 x 32 tile): stores, loads and
        arithmetic (the min with 63) of its two transposes
    mxu_cumsum (a unit is a block of 16 rows, stamped by thread 0 after
        a block barrier):
        repack      the int carry's low bits into the bf16 operand
        products    the tensor-core products of each warp's column
                    tiles, A read as four 32-bit shared loads a product
        write_back  the products' (int)d & 63 into the int carry
    nbmin8 (a unit is a block of a cluster of 8, stamped by thread 0
        after a block barrier):
        lane        the lane part, a warp per row, in place
        barrier1    the first cluster barrier
        halo        the halo rows from the neighbours' edge rows
                    (distributed shared memory)
        barrier2    the second cluster barrier
        column      the row part down each column, and a block barrier

The phases' cycles are each unit's own clock between its stamps, so a
phase includes the time the unit waited for issue slots that other units
on its SM held.  Needs nvcc and a card:

    python -m heimdall_tpu_torch.scripts.stamp_primitives

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

from heimdall_tpu_torch.ops import _cuda
from heimdall_tpu_torch.ops import primitives as pr
from heimdall_tpu_torch.scripts import timing

N_STEPS = 8
PHASES = {
    "min_scan_step": ("stores", "loads", "arithmetic"),
    "cumsum_ladder": ("stores", "loads", "arithmetic"),
    "transpose_pair": ("stores", "loads", "arithmetic"),
    "mxu_cumsum": ("repack", "products", "write_back"),
    "nbmin8": ("lane", "barrier1", "halo", "barrier2", "column"),
}

_SOURCE = r"""
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxW = 640, kPer = kMaxW / 32, kWarps = 8, kCumRows = 16;
constexpr int kCluster = 8, kCrossThreads = 640;

__device__ __forceinline__ long long stamp(int dep) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "r"(dep) : "memory");
  return t;
}

// an xor tree over v: a stamp that takes it waits for every value
template <int N>
__device__ __forceinline__ int fold(const int (&v)[N]) {
  int t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = v[i];
#pragma unroll
  for (int s = 1; s < N; s *= 2)
#pragma unroll
    for (int i = 0; i + s < N; i += 2 * s) t[i] ^= t[i + s];
  return t[0];
}

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// min_scan_step (kLadder false) or cumsum_ladder: a warp per row, each
// rung a store of the row to the line buffer, its shifted reads, and the
// min or add.
template <bool kLadder>
__global__ void __launch_bounds__(kWarps * 32)
    k_rows(const int* x, int sub, int W, int iters, int* out,
           long long* cyc) {
  __shared__ int s_line[kWarps][kMaxW];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int row = blockIdx.x * kWarps + warp, b = blockIdx.y;
  if (row >= sub) return;
  int* line = s_line[warp];
  const int* xr = x + ((long long)b * sub + row) * W;
  int v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int xx = 32 * j + lane;
    v[j] = xx < W ? xr[xx] : 0;
  }
  long long acc[3] = {0, 0, 0};
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if (kLadder)
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] &= 1;
#pragma unroll 1
    for (int d = 1; d < (kLadder ? 1024 : 2); d *= 2) {
      long long t0 = stamp(0);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int xx = 32 * j + lane;
        if (xx < W) line[xx] = v[j];
      }
      __syncwarp();
      long long t1 = stamp(0);
      int t[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int xx = 32 * j + lane, s = xx - d;
        t[j] = xx < W && s >= 0 ? line[s] : (kLadder ? 0 : 63);
      }
      long long t2 = stamp(fold(t));
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int xx = 32 * j + lane;
        if (xx < W) v[j] = kLadder ? wadd(v[j], t[j]) : min(v[j], t[j]);
      }
      long long t3 = stamp(fold(v));
      acc[0] += t1 - t0;
      acc[1] += t2 - t1;
      acc[2] += t3 - t2;
    }
  }
  int* o = out + ((long long)b * sub + row) * W;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int xx = 32 * j + lane;
    if (xx < W) o[xx] = v[j];
  }
  if (lane == 0) {
    long long u = (long long)b * sub + row;
    for (int k = 0; k < 3; ++k) cyc[u * 3 + k] = acc[k];
  }
}

// transpose_pair: a warp per 32 x 32 tile, each transpose a store to and
// a load from a padded [32][33] shared tile.
__global__ void __launch_bounds__(kWarps * 32)
    k_transpose_pair(const int* x, int sub, int W, int iters, int* out,
                     long long* cyc) {
  __shared__ int s_tile[kWarps][32][33];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int tiles_x = (W + 31) / 32, tiles = (sub + 31) / 32 * tiles_x;
  int t = blockIdx.x * kWarps + warp, b = blockIdx.y;
  if (t >= tiles) return;
  int y0 = t / tiles_x * 32, xx = t % tiles_x * 32 + lane;
  const int* xb = x + (long long)b * sub * W;
  int(*s)[33] = s_tile[warp];
  int v[32];
#pragma unroll
  for (int r = 0; r < 32; ++r)
    v[r] = y0 + r < sub && xx < W ? xb[(long long)(y0 + r) * W + xx] : 0;
  long long acc[3] = {0, 0, 0};
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    long long t0 = stamp(0);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 32; ++r) s[lane][r] = v[r];
    __syncwarp();
    long long t1 = stamp(0);
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = s[i][lane];
    long long t2 = stamp(fold(v));
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = min(v[i], 63);
    long long t3 = stamp(fold(v));
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i][lane] = v[i];
    __syncwarp();
    long long t4 = stamp(0);
#pragma unroll
    for (int r = 0; r < 32; ++r) v[r] = s[lane][r];
    long long t5 = stamp(fold(v));
    acc[0] += t1 - t0 + t4 - t3;
    acc[1] += t2 - t1 + t5 - t4;
    acc[2] += t3 - t2;
  }
  int* ob = out + (long long)b * sub * W;
#pragma unroll
  for (int r = 0; r < 32; ++r)
    if (y0 + r < sub && xx < W) ob[(long long)(y0 + r) * W + xx] = v[r];
  if (lane == 0) {
    long long u = (long long)b * tiles + t;
    for (int k = 0; k < 3; ++k) cyc[u * 3 + k] = acc[k];
  }
}

// mxu_cumsum: 16 rows a block, the int carry s_v repacked into bf16 s_a,
// the products of each warp's 8-wide column tiles (A as four 32-bit
// shared loads a product), then (int)d & 63 written back into s_v.  The
// products are kept in registers until the write-back, so that the two
// phases can be stamped apart.
__global__ void __launch_bounds__(kWarps * 32)
    k_mxu_cumsum(const int* x, int sub, int W, int iters, int* out,
                 long long* cyc) {
  extern __shared__ uint32_t s_mem[];
  int Wp = (W + 15) & ~15, stride = Wp + 8, half = stride / 2;
  uint32_t* s_a = s_mem;
  uint16_t* s16 = reinterpret_cast<uint16_t*>(s_a);
  int* s_v = reinterpret_cast<int*>(s_mem + kCumRows * half);
  int y0 = blockIdx.x * kCumRows, b = blockIdx.y;
  const int* xb = x + (long long)b * sub * W;
  for (int i = threadIdx.x; i < kCumRows * Wp; i += blockDim.x) {
    int r = i / Wp, c = i - r * Wp;
    s_v[i] = y0 + r < sub && c < W ? xb[(long long)(y0 + r) * W + c] : 0;
  }
  __syncthreads();
  int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  int warp = threadIdx.x >> 5;
  long long acc[3] = {0, 0, 0};
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    long long t0 = stamp(0);
    for (int i = threadIdx.x; i < kCumRows * Wp; i += blockDim.x) {
      int r = i / Wp;
      s16[r * stride + i - r * Wp] = (uint16_t)bf16_one(s_v[i] & 1);
    }
    __syncthreads();
    long long t1 = stamp(0);
    float d[10][4];
#pragma unroll
    for (int q = 0; q < 10; ++q) {
      int nt = warp + kWarps * q;
      d[q][0] = d[q][1] = d[q][2] = d[q][3] = 0.f;
      if (nt * 8 >= W) continue;
      int j = nt * 8 + gid, kt_last = (nt * 8 + 7) >> 4;
      for (int kt = 0; kt <= kt_last; ++kt) {
        int w0 = kt * 8 + tig;
        uint32_t a[4] = {s_a[gid * half + w0], s_a[(gid + 8) * half + w0],
                         s_a[gid * half + w0 + 4],
                         s_a[(gid + 8) * half + w0 + 4]};
        int k = kt * 16 + 2 * tig;
        uint32_t b0 = 0x3F803F80u, b1 = 0x3F803F80u;
        if (kt == kt_last) {
          b0 = bf16_one(k <= j) | bf16_one(k + 1 <= j) << 16;
          b1 = bf16_one(k + 8 <= j) | bf16_one(k + 9 <= j) << 16;
        }
        mma_bf16(d[q], a, b0, b1);
      }
    }
    __syncthreads();
    long long t2 = stamp(0);
#pragma unroll
    for (int q = 0; q < 10; ++q) {
      int nt = warp + kWarps * q;
      for (int i = 0; i < 4; ++i) {
        int r = gid + (i >> 1) * 8, c = nt * 8 + 2 * tig + (i & 1);
        if (c < W) s_v[r * Wp + c] = (int)d[q][i] & 63;
      }
    }
    __syncthreads();
    long long t3 = stamp(0);
    acc[0] += t1 - t0;
    acc[1] += t2 - t1;
    acc[2] += t3 - t2;
  }
  int* ob = out + (long long)b * sub * W;
  for (int i = threadIdx.x; i < kCumRows * Wp; i += blockDim.x) {
    int r = i / Wp, c = i - r * Wp;
    if (y0 + r < sub && c < W) ob[(long long)(y0 + r) * W + c] = s_v[i];
  }
  if (threadIdx.x == 0) {
    long long u = (long long)b * gridDim.x + blockIdx.x;
    for (int k = 0; k < 3; ++k) cyc[u * 3 + k] = acc[k];
  }
}

// nbmin8 (int32): one frame per cluster of 8 blocks, a block's rows in
// shared memory with a halo row above and below; each step the lane part
// in place, a cluster barrier, the halos from the neighbours' edge rows,
// a cluster barrier, the row part down each column, a block barrier.
__global__ void __launch_bounds__(kCrossThreads)
    k_nbmin8(const int* x, int sub, int W, int R, int iters, int* out,
             long long* cyc) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  int* s = reinterpret_cast<int*>(s_raw);
  cg::cluster_group cluster = cg::this_cluster();
  int c = (int)cluster.block_rank(), b = blockIdx.y;
  int y0 = c * R, n = max(0, min(R, sub - y0));
  int last = (sub - 1) / R;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int warps = blockDim.x >> 5;
  int* own = s + W;
  const int* xb = x + (long long)b * sub * W + (long long)y0 * W;
  for (int i = threadIdx.x; i < n * W; i += blockDim.x) own[i] = xb[i];
  const int* up = nullptr;
  const int* down = nullptr;
  if (n > 0 && c > 0) up = cluster.map_shared_rank(s, c - 1) + R * W;
  if (n > 0 && c < last) down = cluster.map_shared_rank(s, c + 1) + W;
  __syncthreads();
  long long acc[5] = {0, 0, 0, 0, 0};
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    long long t0 = stamp(0);
    for (int y = warp; y < n; y += warps) {
      int* line = own + (long long)y * W;
      int r[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int xx = 32 * j + lane;
        if (xx >= W) continue;
        int l = xx > 0 ? line[xx - 1] : 63;
        int rr = xx + 1 < W ? line[xx + 1] : 63;
        r[j] = min(line[xx], min(l, rr));
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int xx = 32 * j + lane;
        if (xx < W) line[xx] = r[j];
      }
      __syncwarp();
    }
    __syncthreads();
    long long t1 = stamp(0);
    cluster.sync();
    long long t2 = stamp(0);
    if (n > 0) {
      int* below = own + (long long)n * W;
      for (int xx = threadIdx.x; xx < W; xx += blockDim.x) {
        s[xx] = up ? up[xx] : 63;
        below[xx] = down ? down[xx] : 63;
      }
    }
    __syncthreads();
    long long t3 = stamp(0);
    cluster.sync();
    long long t4 = stamp(0);
    for (int xx = threadIdx.x; xx < W; xx += blockDim.x) {
      int prev = s[xx];
      for (int y = 0; y < n; ++y) {
        int* p = own + (long long)y * W + xx;
        int cur = *p, nv = min(min(cur, prev), p[W]);
        *p = nv;
        prev = cur;
      }
    }
    __syncthreads();
    long long t5 = stamp(0);
    acc[0] += t1 - t0;
    acc[1] += t2 - t1;
    acc[2] += t3 - t2;
    acc[3] += t4 - t3;
    acc[4] += t5 - t4;
  }
  __syncthreads();
  int* ob = out + (long long)b * sub * W + (long long)y0 * W;
  for (int i = threadIdx.x; i < n * W; i += blockDim.x) ob[i] = own[i];
  if (threadIdx.x == 0) {
    long long u = (long long)b * kCluster + c;
    for (int k = 0; k < 5; ++k) cyc[u * 5 + k] = acc[k];
  }
  cluster.sync();              // no block leaves while another reads it
}

}  // namespace

// kernel: 0 min_scan_step, 1 cumsum_ladder, 2 transpose_pair,
// 3 mxu_cumsum, 4 nbmin8; x and out int32 [B, sub, W]; cyc int64
// [units, phases].
extern "C" int hd_stamped_step(int kernel, const int* x, int B, int sub,
                               int W, int iters, int* out, long long* cyc) {
  if (kernel == 0 || kernel == 1) {
    dim3 grid((sub + kWarps - 1) / kWarps, B);
    if (kernel == 0)
      k_rows<false><<<grid, kWarps * 32>>>(x, sub, W, iters, out, cyc);
    else
      k_rows<true><<<grid, kWarps * 32>>>(x, sub, W, iters, out, cyc);
  } else if (kernel == 2) {
    int tiles = (sub + 31) / 32 * ((W + 31) / 32);
    k_transpose_pair<<<dim3((tiles + kWarps - 1) / kWarps, B),
                       kWarps * 32>>>(x, sub, W, iters, out, cyc);
  } else if (kernel == 3) {
    int Wp = (W + 15) & ~15;
    size_t smem = (size_t)kCumRows * ((Wp + 8) * 2 + Wp * 4);
    cudaError_t e = cudaFuncSetAttribute(
        k_mxu_cumsum, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    k_mxu_cumsum<<<dim3((sub + kCumRows - 1) / kCumRows, B), kWarps * 32,
                   smem>>>(x, sub, W, iters, out, cyc);
  } else {
    int R = (sub + kCluster - 1) / kCluster;
    size_t smem = (size_t)(R + 2) * W * 4;
    cudaError_t e = cudaFuncSetAttribute(
        k_nbmin8, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, B);
    cfg.blockDim = dim3(kCrossThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, k_nbmin8, x, sub, W, R, iters, out, cyc);
    if (e != cudaSuccess) return (int)e;
  }
  HD_CHECK();
  return 0;
}
"""
KERNELS = ("min_scan_step", "cumsum_ladder", "transpose_pair", "mxu_cumsum",
           "nbmin8")


def build(tmp: Path) -> ctypes.CDLL:
    cu = tmp / "primitives_stamped.cu"
    cu.write_text(_SOURCE)
    so = tmp / "primitives_stamped.so"
    subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I",
                    str(_cuda.CSRC), "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.hd_stamped_step.argtypes = [I, P, I, I, I, I, P, P]
    return lib


def units(name: str, B: int, sub: int, W: int) -> int:
    if name in ("min_scan_step", "cumsum_ladder"):
        return B * sub
    if name == "transpose_pair":
        return B * -(-sub // 32) * -(-W // 32)
    if name == "mxu_cumsum":
        return B * -(-sub // 16)
    return B * 8


def run(lib, name: str, x: torch.Tensor) -> dict:
    B, sub, W = x.shape
    out = torch.empty_like(x)
    phases = PHASES[name]
    cyc = torch.zeros((units(name, B, sub, W), len(phases)),
                      dtype=torch.int64, device=x.device)
    err = lib.hd_stamped_step(KERNELS.index(name), x.data_ptr(), B, sub, W,
                              N_STEPS, out.data_ptr(), cyc.data_ptr())
    if err:
        raise RuntimeError(f"hd_stamped_step ({name}): CUDA error {err}")
    torch.cuda.synchronize()
    want = pr.primitive_steps_reference(x, name, N_STEPS, sub)
    per_step = cyc.double().cpu().numpy() / N_STEPS
    mean = per_step.mean(axis=0)
    return {"equal": bool(torch.equal(out, want)),
            "cycles_per_step": {p: float(mean[k])
                                for k, p in enumerate(phases)},
            "share": {p: float(mean[k] / mean.sum())
                      for k, p in enumerate(phases)},
            "total": float(mean.sum()),
            "max_total": float(per_step.sum(axis=1).max())}


def main() -> dict:
    timing.require_card()
    print(timing.card(), flush=True)
    planes = {name: p for name, dtype, p in pr.inputs()
              if dtype == "int32" and name in KERNELS}
    out = {"card": timing.card(), "steps": N_STEPS, "batch": pr.B}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        for name in KERNELS:
            x = torch.from_numpy(np.ascontiguousarray(planes[name])).cuda()
            out[name] = r = run(lib, name, x)
            print(f"{name}: equal {r['equal']}; cycles a step (mean over "
                  f"units) " + ", ".join(
                      f"{p} {c:.1f} ({100 * r['share'][p]:.1f}%)"
                      for p, c in r["cycles_per_step"].items())
                  + f"; total {r['total']:.1f}, slowest unit "
                  f"{r['max_total']:.1f}", flush=True)
    out["sm_clock_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"SM clock {out['sm_clock_mhz']}", flush=True)
    print(json.dumps(out), flush=True)
    if not all(out[n]["equal"] for n in KERNELS):
        raise SystemExit("a stamped copy differs from its plain version")
    return out


if __name__ == "__main__":
    main()
