// The sweep probes' phases on a thread-block cluster (ccl_sweeps.cu's
// k_sweep_ccl_cluster, joint_label.cu's k_joint_label_cluster): one frame
// a cluster of C blocks whose shared memory holds the frame's two label
// planes, so that a phase reads the previous plane and writes the next one
// without a trip through device memory.
//
// Block c of the cluster holds rows [c * H / C, (c + 1) * H / C) of both
// planes, each with one halo row above and one below (copied from the
// neighbours' shared memory at the start of each phase), and takes columns
// [c * ceil(W / C), ...) in a column phase.  The guard rows of the guarded
// plane are not stored: they hold background, whose label never lowers a
// min, so a phase over the frame's H rows gives the same labels; the run
// ids keep the guarded layout (Plane).
//
//   row phase     each warp takes one of the block's rows: the candidates
//                 into the next plane's row, the packed ladder over it in
//                 place, then out() (the sweep CCL skips the rows and the
//                 columns that hold no foreground);
//   column phase  the candidates of the block's rows are staged in the
//                 next plane; after a cluster barrier each block loads its
//                 columns over the whole height, P at a time, into a tile
//                 of [H][P + 1] ints through the cluster's window, runs one
//                 warp a column's ladder in the tile and hands the results
//                 to out() with the owners' rows (the ladder's reach, 2^steps
//                 - 1 rows or the whole column, spans blocks for free);
//   certificates  an OR over the cluster: each block's OR written into
//                 every block's flags, then a cluster barrier.
//
// A cluster barrier (barrier.cluster, release / acquire) ends every phase.
// Device memory sees the mask and the run ids in and the outputs out.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBandWarps = 16;     // 512 threads, one block an SM
constexpr int kMaxCluster = 16;    // 16 needs the non-portable opt-in

// One frame over a cluster: H x W frame, C blocks, P columns a pass of the
// column phase, rows = ceil(H / C) rows a block at most, cols = ceil(W / C)
// columns a block takes in a column phase; mask: the blocks also hold
// their rows of the mask with a halo row on each side (the joint exchange).
struct Band {
  int H, W, C, P, rows, cols, mask;
};

inline Band band_of(int H, int W, int C, int P, int mask) {
  return Band{H, W, C, P, (H + C - 1) / C, (W + C - 1) / C, mask};
}

// Shared memory of a block in bytes (ops/ccl_sweeps.py::band_bytes): two
// planes of rows + 2 rows, the tile, two sets of kMaxCluster flags, a
// pass's 32 column flags and the frame's row map (an int16 a row), then the
// mask rows.
inline size_t band_bytes(const Band& b) {
  size_t ints = 2 * (size_t)(b.rows + 2) * b.W + (size_t)b.H * (b.P + 1) +
                2 * kMaxCluster + 32 + (size_t)(b.H + 1) / 2;
  return 4 * ints + (b.mask ? (size_t)(b.rows + 2) * b.W : 0);
}

inline bool band_valid(const Band& b) {
  return (b.C == 1 || b.C == 2 || b.C == 4 || b.C == 8 || b.C == 16) &&
         (b.P == 8 || b.P == 16 || b.P == 32) && b.W <= 32 * kMaxPerLane &&
         b.H <= 32 * kMaxPerLane;
}

// This block's part of its frame.
struct BandFrame {
  Band bd;
  cg::cluster_group cl;
  int rank, r0, r1, c0, c1, parity;
  int *A, *B, *tile, *flags, *busy;
  int16_t* rowmap;      // row y: its owner << 11 | its row in the owner's
                        // planes (1 .. 1024; the halo row is 0)
  uint8_t* mrows;       // mask rows r0 - 1 .. r1, or null
  int lane, warp;

  __device__ BandFrame(const Band& b, int* smem)
      : bd(b), cl(cg::this_cluster()), parity(0) {
    rank = (int)cl.block_rank();
    r0 = lo(rank);
    r1 = lo(rank + 1);
    c0 = min(b.W, rank * b.cols);
    c1 = min(b.W, c0 + b.cols);
    size_t plane = (size_t)(b.rows + 2) * b.W;
    A = smem;
    B = A + plane;
    tile = B + plane;
    flags = tile + (size_t)b.H * (b.P + 1);
    busy = flags + 2 * kMaxCluster;
    rowmap = reinterpret_cast<int16_t*>(busy + 32);
    mrows = b.mask ? reinterpret_cast<uint8_t*>(busy + 32 + (b.H + 1) / 2)
                   : nullptr;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    for (int y = threadIdx.x; y < b.H; y += blockDim.x) {
      int o = owner(y);
      rowmap[y] = (int16_t)(o << 11 | (y - lo(o) + 1));
    }
  }

  // body(y, x) for every pixel of this block's rows: a warp a row, a lane
  // a column.
  template <typename Body>
  __device__ __forceinline__ void for_own(Body body) {
    for (int y = r0 + warp; y < r1; y += kBandWarps)
      for (int x = lane; x < bd.W; x += 32) body(y, x);
  }

  __device__ int lo(int c) const { return c * bd.H / bd.C; }
  __device__ int owner(int y) const { return ((y + 1) * bd.C - 1) / bd.H; }
  // Row y of a local plane (r0 - 1 <= y <= r1), or null outside the frame.
  __device__ int* row(int* p, int y) const {
    return y < 0 || y >= bd.H ? nullptr : p + (long long)(y - r0 + 1) * bd.W;
  }
  __device__ const uint8_t* mrow(int y) const {
    return y < 0 || y >= bd.H ? nullptr
                              : mrows + (long long)(y - r0 + 1) * bd.W;
  }
  // Row y of the frame (any row) of plane p in its owner's shared memory
  // (after a barrier that follows the constructor).
  __device__ int* remote_row(int* p, int y) {
    int e = rowmap[y];
    return cl.map_shared_rank(p, e >> 11) + (e & 2047) * bd.W;
  }

  // The mask rows r0 - 1 .. r1 of the frame's mask m [H, W] from device
  // memory.
  __device__ void load_mask(const uint8_t* m) {
    int y_lo = max(r0 - 1, 0), y_hi = min(r1 + 1, bd.H);
    long long n = (long long)(y_hi - y_lo) * bd.W;
    uint8_t* dst = mrows + (long long)(y_lo - r0 + 1) * bd.W;
    const uint8_t* src = m + (long long)y_lo * bd.W;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }

  // The halo rows r0 - 1 and r1 of plane p from their owners.
  __device__ void copy_halo(int* p) {
    if (r1 > r0) {
      for (int i = threadIdx.x; i < 2 * bd.W; i += blockDim.x) {
        int s = i >= bd.W, x = i - s * bd.W, y = s ? r1 : r0 - 1;
        if (y >= 0 && y < bd.H) row(p, y)[x] = remote_row(p, y)[x];
      }
    }
    __syncthreads();
  }

  // The OR of v over the cluster, in every thread.  Two sets of flags in
  // turn: a block may start the next OR before another has read this one,
  // but not the one after (a cluster barrier lies between).
  __device__ int any(int v) {
    v = __syncthreads_or(v);
    int* set = flags + parity * kMaxCluster;
    if ((int)threadIdx.x < bd.C)
      *cl.map_shared_rank(set + rank, (int)threadIdx.x) = v;
    cl.sync();
    int r = 0;
    for (int i = 0; i < bd.C; ++i) r |= set[i];
    parity ^= 1;
    return r;
  }
};

// One min phase of a sweep on the cluster, from plane cur into plane nxt:
// for every position of the frame, cand(y, x) (this block's rows, reading
// cur's rows y - 1 .. y + 1 through f.row), then the min over each run of
// the line (run ids `runs` of the guarded plane pl times big: [Hg, W] along
// the rows, [W, Hg] along the columns; ladder of `steps`), handed to
// out(y, x, v, c, nxt's row y) with c cur's value there (with kReadCur;
// else 0).  With kSkipEmpty the runs are the foreground's and a line
// without one (its run id at its end is 0) is skipped: its candidates and
// its outputs are background, which nxt already holds there.  Ends with a
// cluster barrier.  A lane holds kPer positions of a line (kPerR of a row,
// kPerC of a column): the frame has at most 32 * kPerR columns and
// 32 * kPerC rows.
template <int kPerR, int kPerC, bool kCols, bool kReadCur, bool kSkipEmpty,
          typename Cand, typename Out>
__device__ __forceinline__ void band_phase(BandFrame& f, const Plane& pl,
                                           const int16_t* runs, int big,
                                           int steps, int* cur, int* nxt,
                                           Cand cand, Out out) {
  constexpr int kPer = kCols ? kPerC : kPerR;
  int lane = f.lane, warp = f.warp;
  int H = f.bd.H, W = f.bd.W;
  int v[kPer], rb[kPer];
  f.copy_halo(cur);
  if (!kCols) {
    for (int y = f.r0 + warp; y < f.r1; y += kBandWarps) {
      const int16_t* rr = runs + (long long)(y + pl.G) * W;
      if (kSkipEmpty && rr[W - 1] == 0) continue;
      int* line = f.row(nxt, y);
      for (int x = lane; x < W; x += 32) line[x] = cand(y, x);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int x = 32 * j + lane;
        bool in = x < W;
        v[j] = in ? line[x] : 0;
        rb[j] = in ? big * rr[x] : 0;
      }
      run_min<kScanMasked>(v, rb, line, W, steps, lane);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int x = 32 * j + lane;
        if (x < W) line[x] = v[j];
      }
      int* cr = f.row(cur, y);
      for (int x = lane; x < W; x += 32)
        out(y, x, line[x], kReadCur ? cr[x] : 0, line);
      __syncwarp();
    }
    f.cl.sync();
    return;
  }
  // stage the candidates of this block's rows in nxt
  f.for_own([&](int y, int x) { f.row(nxt, y)[x] = cand(y, x); });
  f.cl.sync();
  int P = f.bd.P, ps = P == 32 ? 5 : (P == 16 ? 4 : 3), stride = P + 1;
  auto line_runs = [&](int x) { return runs + (long long)x * pl.Hg + pl.G; };
  for (int x0 = f.c0; x0 < f.c1; x0 += P) {
    int pc = min(P, f.c1 - x0);
    if ((int)threadIdx.x < P)
      f.busy[threadIdx.x] =
          (int)threadIdx.x < pc &&
          (!kSkipEmpty || line_runs(x0 + threadIdx.x)[pl.Hg - pl.G - 1] != 0);
    if (!__syncthreads_or((int)threadIdx.x < P && f.busy[threadIdx.x]))
      continue;
    for (int i = threadIdx.x; i < H * P; i += blockDim.x) {
      int y = i >> ps, c = i & (P - 1);
      if (f.busy[c]) f.tile[y * stride + c] = f.remote_row(nxt, y)[x0 + c];
    }
    __syncthreads();
    for (int c = warp; c < pc; c += kBandWarps) {
      if (!f.busy[c]) continue;
      const int16_t* rc = line_runs(x0 + c);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int y = 32 * j + lane;
        bool in = y < H;
        v[j] = in ? f.tile[y * stride + c] : 0;
        rb[j] = in ? big * rc[y] : 0;
      }
      run_min<kScanMasked>(v, rb, f.tile + c, H, steps, lane, stride);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int y = 32 * j + lane;
        if (y < H) f.tile[y * stride + c] = v[j];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < H * P; i += blockDim.x) {
      int y = i >> ps, c = i & (P - 1);
      if (f.busy[c])
        out(y, x0 + c, f.tile[y * stride + c],
            kReadCur ? f.remote_row(cur, y)[x0 + c] : 0,
            f.remote_row(nxt, y));
    }
    __syncthreads();
  }
  f.cl.sync();
}

// A lane's positions of a row and of a column in the instantiation a frame
// takes: the bench's 640 x 480 and smaller frames <20, 16>, all others
// <kMaxPerLane, kMaxPerLane>.
inline bool band_small(const Band& b) { return b.W <= 640 && b.H <= 512; }

// A cluster launch of a band kernel: C blocks a frame, B frames.
template <typename... Params, typename... Args>
int band_launch(void (*kernel)(Params...), const Band& bd, int B,
                cudaStream_t st, Args... args) {
  size_t smem = band_bytes(bd);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && bd.C > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = bd.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bd.C, B);
  cfg.blockDim = dim3(kBandWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (B == 0) return 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  HD_CHECK();
  return 0;
}

// How many clusters of a band kernel the current device runs at once, or
// minus a CUDA error.
template <typename... Params>
int band_clusters(void (*kernel)(Params...), const Band& bd) {
  size_t smem = band_bytes(bd);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && bd.C > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = bd.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bd.C, 1);
  cfg.blockDim = dim3(kBandWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// Whether a band fits the current device's shared memory (a block's
// opt-in maximum).
inline int band_fits(const Band& bd, bool* fits) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  *fits = band_valid(bd) && band_bytes(bd) <= (size_t)optin;
  return 0;
}

}  // namespace
