// The per-step primitive microbench (ops/primitives.py): one primitive of
// the sweep kernels applied `iters` times to each frame's plane [sub, W]
// with a data-dependent carry, then rows [0, out_rows) stored as int32.
// Replaces the Pallas kernel of heimdall_tpu's scripts/microbench_vpu.py
// (make_call's kernel, :280-306, launched at :296), whose 27 variants time
// the TPU's per-step costs by differencing N = 36 against N = 4.
//
// What bounds it: the steps' integer operations (and mxu_cumsum's
// tensor-core products): device memory is read once and written once per
// call, and that cancels in the difference.  So the carry stays on chip for
// all N steps, as the TPU keeps it in VMEM:
//
// * row-local steps (every step but the four cross-row ones): a warp per
//   row, its values in registers at x = 32 * j + lane, shifted reads
//   through the warp's line buffer in shared memory, as the port's sweep
//   kernels read (common.cuh: sweep_phase, max_scan's masked and iota
//   reads), and the ladders' rungs in a loop that is not unrolled, as
//   max_scan's (unrolled over compile-time shifts, the compiler hoists
//   every rung's indices out of the step loop, into 255 registers);
// * mxu_cumsum: 16 rows per block in shared memory, the triangular product
//   on the tensor cores (mma_bf16, the triangle's fragments from indices,
//   the k tiles above the diagonal skipped, as k_run_ids);
// * transpose_pair: a warp per 32 x 32 tile in registers, each transpose
//   through a padded [32][33] shared tile (the TPU transposes the whole
//   plane on its XLU; the result is the same);
// * cross-row steps (nbmin8, nbmin_guard, nbmin_masked_sub,
//   sublane_mask_add): one frame per cluster of kCluster blocks, each
//   holding a band of rows in shared memory with a halo row above and
//   below, filled from its neighbours' edge rows through distributed
//   shared memory between two cluster barriers.
//
// The i16 and i8 variants keep their planes in their own type in memory
// and shared memory and compute per element in int registers (no packed
// SIMD), wrapping to the type where an add may leave it.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// ops/primitives.py: STEPS, in order
enum Step {
  kMinScan, kMaxScan, kOrRoll, kNbmin8, kAdd, kSelect, kTransposePair,
  kSegMin, kMxuCumsum, kCumsumLadder, kMaskedMin, kMaskedLadder5,
  kNbminGuard, kNbminMaskedSub, kOrAndMask, kMaxLadderFull, kSublaneMaskAdd
};

constexpr int kMaxW = 640;           // the widest plane: 20 values a lane
constexpr int kPer = kMaxW / 32;
constexpr int kWarps = 8;            // row-local and transpose blocks
constexpr int kCluster = 8;          // blocks of a cross-row frame
constexpr int kCrossThreads = 640;
constexpr int kCumRows = 16;         // mxu_cumsum: rows of one mma tile
constexpr int kGuard = 1 << 24;      // nbmin_guard's and sublane's masks
constexpr int kFloor = -(1 << 22);   // max_ladder_full's

template <typename T>
constexpr int dtype_code() {
  return sizeof(T) == 4 ? 0 : (sizeof(T) == 2 ? 1 : 2);
}

// a + b with two's-complement wrap-around (the plain version's int add)
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// v in T, as the plain version's narrow add leaves it
template <typename T>
__device__ __forceinline__ int wrap(int v) {
  return (int)(T)v;
}

// v, hidden from the compiler, so that steps with no shared-memory read
// (add, select) are not folded across the loop (N adds into one).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// The value at x - d of a line of W in shared memory (d > 0 reads lower
// positions, d < 0 higher ones), or fill where x - d leaves the line: the
// index test and select of the TPU code's _roll_fill.
template <typename T>
__device__ __forceinline__ int sh_at(const T* line, int x, int d, int W,
                                     int fill) {
  int s = x - d;
  return (d > 0 ? s >= 0 : s < W) ? (int)line[s] : fill;
}

// roll(line, d)[x], plus p where the read wrapped: the TPU code's roll and
// precomputed edge mask, as max_scan's masked read.  |d| <= W.
template <typename T>
__device__ __forceinline__ int pen_at(const T* line, int x, int d, int W,
                                      int p) {
  int s = x - d;
  int w = (d > 0 ? s : W - 1 - s) >> 31;       // -1 where the read wraps
  return wadd((int)line[d > 0 ? s + (w & W) : s - (w & W)], w & p);
}

// Writes the warp's line v (position 32 * j + lane in v[j]) to its buffer;
// the reads that follow see every lane's values.
template <typename T>
__device__ __forceinline__ void publish(const int (&v)[kPer], T* line, int W,
                                        int lane) {
  __syncwarp();                      // the previous reads are done
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int x = 32 * j + lane;
    if (x < W) line[x] = (T)v[j];
  }
  __syncwarp();
}

// v[j] = f(v[j], x) for every position x of the line, after publishing v
// (f reads the buffer).
template <typename T, typename F>
__device__ __forceinline__ void lane_pass(int (&v)[kPer], T* line, int W,
                                          int lane, F f) {
  publish(v, line, W, lane);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int x = 32 * j + lane;
    if (x < W) v[j] = f(v[j], x);
  }
}

// One ladder rung: v = max (kMax) or min (else) of v and its roll by
// d > 0 plus p where the read wrapped.  The roll is by e = d mod W, and
// every position takes p when d >= W (planes narrower than the shift).
template <bool kMax, typename T>
__device__ __forceinline__ void pen_rung(int (&v)[kPer], T* line, int W,
                                         int lane, int d, int p) {
  int e = d < W ? d : d % W, all = d < W ? 0 : p;
  lane_pass(v, line, W, lane, [&](int a, int x) {
    int s = x - e, w = s >> 31;                // -1 where the read wraps
    int u = wadd((int)line[s + (w & W)], (w & p) | all);
    return kMax ? max(a, u) : min(a, u);
  });
}

// One step of a row-local primitive on the warp's row v (seg_min_step:
// values v, flags f).
template <int kS, typename T>
__device__ __forceinline__ void row_step(int (&v)[kPer], int (&f)[kPer],
                                         T* line, int W, int lane) {
  if constexpr (kS == kMinScan) {
    lane_pass(v, line, W, lane, [&](int a, int x) {
      return min(a, sh_at(line, x, 1, W, 63));
    });
  } else if constexpr (kS == kMaxScan) {
    lane_pass(v, line, W, lane, [&](int a, int x) {
      return max(a, sh_at(line, x, 1, W, -1));
    });
  } else if constexpr (kS == kOrRoll) {
    lane_pass(v, line, W, lane, [&](int a, int x) {
      int s = x - 1;
      return a | (int)line[s + ((s >> 31) & W)];
    });
  } else if constexpr (kS == kAdd) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = opaque(wrap<T>(v[j] + 1));
  } else if constexpr (kS == kSelect) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = opaque(v[j] > 0 ? v[j] : wrap<T>(v[j] + 1));
  } else if constexpr (kS == kSegMin) {
    publish(v, line, W, lane);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int x = 32 * j + lane;
      if (x < W && f[j] <= 0) v[j] = min(v[j], sh_at(line, x, 1, W, 63));
    }
    lane_pass(f, line, W, lane, [&](int a, int x) {
      return a | sh_at(line, x, 1, W, 1);
    });
  } else if constexpr (kS == kCumsumLadder) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] &= 1;
#pragma unroll 1
    for (int d = 1; d < 1024; d *= 2)
      lane_pass(v, line, W, lane, [&](int a, int x) {
        int s = x - d;
        return wadd(a, s >= 0 ? (int)line[s] : 0);
      });
  } else if constexpr (kS == kMaskedMin) {
    pen_rung<false>(v, line, W, lane, 1, kPen);
  } else if constexpr (kS == kMaskedLadder5) {
#pragma unroll 1
    for (int d = 1; d < 32; d *= 2) pen_rung<false>(v, line, W, lane, d, kPen);
  } else if constexpr (kS == kOrAndMask) {
    lane_pass(v, line, W, lane, [&](int a, int x) {
      return a | sh_at(line, x, 1, W, 0);
    });
  } else if constexpr (kS == kMaxLadderFull) {
#pragma unroll 1
    for (int d = 1; d < 1024; d *= 2) pen_rung<true>(v, line, W, lane, d, kFloor);
  }
}

// Row-local steps: a warp per row (seg_min_step: per pair of rows r and
// r + sub / 2), blocks of kWarps rows of one frame (blockIdx.y).
template <int kS, typename T>
__global__ void __launch_bounds__(kWarps * 32)
    k_rows(const T* x, int sub, int W, int iters, int out_rows,
           int32_t* out) {
  __shared__ T s_line[kWarps][kMaxW];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int units = kS == kSegMin ? sub / 2 : sub;
  int row = blockIdx.x * kWarps + warp, b = blockIdx.y;
  if (row >= units) return;
  const T* xb = x + (long long)b * sub * W;
  int v[kPer], f[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int xx = 32 * j + lane;
    v[j] = xx < W ? (int)xb[(long long)row * W + xx] : 0;
    f[j] = kS == kSegMin && xx < W ? (int)xb[(long long)(row + units) * W + xx]
                                   : 0;
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) row_step<kS, T>(v, f, s_line[warp], W, lane);
  if (out_rows == 1 && row > 0) return;
  int32_t* ob = out + (long long)b * out_rows * W;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int xx = 32 * j + lane;
    if (xx >= W) continue;
    ob[(long long)row * W + xx] = v[j];
    if (kS == kSegMin && out_rows > 1)
      ob[(long long)(row + units) * W + xx] = f[j];
  }
}

// transpose_pair: a warp per 32 x 32 tile (v[r] = row y0 + r, column x0 +
// lane), blocks of kWarps tiles of one frame.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    k_transpose_pair(const T* x, int sub, int W, int iters, int out_rows,
                     int32_t* out) {
  __shared__ T s_tile[kWarps][32][33];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int tiles_x = (W + 31) / 32, tiles = (sub + 31) / 32 * tiles_x;
  int t = blockIdx.x * kWarps + warp, b = blockIdx.y;
  if (t >= tiles) return;
  int y0 = t / tiles_x * 32, xx = t % tiles_x * 32 + lane;
  const T* xb = x + (long long)b * sub * W;
  T(*s)[33] = s_tile[warp];
  int v[32];
#pragma unroll
  for (int r = 0; r < 32; ++r)
    v[r] = y0 + r < sub && xx < W ? (int)xb[(long long)(y0 + r) * W + xx] : 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 32; ++r) s[lane][r] = (T)v[r];   // s = v's transpose
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = min((int)s[i][lane], 63);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i][lane] = (T)v[i];   // and back
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 32; ++r) v[r] = (int)s[lane][r];
  }
  int32_t* ob = out + (long long)b * out_rows * W;
#pragma unroll
  for (int r = 0; r < 32; ++r)
    if (y0 + r < out_rows && xx < W) ob[(long long)(y0 + r) * W + xx] = v[r];
}

// mxu_cumsum: kCumRows rows of one frame per block in shared memory (int
// carry s_v [16][Wp], its low bits as bf16 s_a [16][Wp + 8]); each step
// s_v = (s_a x U) & 63 with U[k][j] = k <= j, each warp taking 8-wide
// column tiles and only the k tiles at or below them.
__global__ void __launch_bounds__(kWarps * 32)
    k_mxu_cumsum(const int32_t* x, int sub, int W, int iters, int out_rows,
                 int32_t* out) {
  extern __shared__ uint32_t s_mem[];
  int Wp = (W + 15) & ~15, stride = Wp + 8, half = stride / 2;
  uint32_t* s_a = s_mem;
  uint16_t* s16 = reinterpret_cast<uint16_t*>(s_a);
  int32_t* s_v = reinterpret_cast<int32_t*>(s_mem + kCumRows * half);
  int y0 = blockIdx.x * kCumRows, b = blockIdx.y;
  const int32_t* xb = x + (long long)b * sub * W;
  for (int i = threadIdx.x; i < kCumRows * Wp; i += blockDim.x) {
    int r = i / Wp, c = i - r * Wp;
    s_v[i] = y0 + r < sub && c < W ? xb[(long long)(y0 + r) * W + c] : 0;
  }
  __syncthreads();
  int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < kCumRows * Wp; i += blockDim.x) {
      int r = i / Wp;
      s16[r * stride + i - r * Wp] = (uint16_t)bf16_one(s_v[i] & 1);
    }
    __syncthreads();
    for (int nt = threadIdx.x >> 5; nt * 8 < W; nt += kWarps) {
      int j = nt * 8 + gid;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      int kt_last = (nt * 8 + 7) >> 4;
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
        mma_bf16(d, a, b0, b1);
      }
      for (int i = 0; i < 4; ++i) {
        int r = gid + (i >> 1) * 8, c = nt * 8 + 2 * tig + (i & 1);
        if (c < W) s_v[r * Wp + c] = (int)d[i] & 63;
      }
    }
    __syncthreads();
  }
  int32_t* ob = out + (long long)b * out_rows * W;
  for (int i = threadIdx.x; i < kCumRows * Wp; i += blockDim.x) {
    int r = i / Wp, c = i - r * Wp;
    if (y0 + r < out_rows && c < W) ob[(long long)(y0 + r) * W + c] = s_v[i];
  }
}

// Cross-row steps: one frame (blockIdx.y) per cluster of kCluster blocks;
// block c holds rows [c * R, c * R + n) in s rows 1..n, a halo row above
// (s row 0) and below (s row n + 1).  A step: the lane part in place (a
// warp per row, reading its own row), a cluster barrier, the halos from
// the neighbours' edge rows (distributed shared memory; the wrap variants
// take block 0's upper halo from the last block's last row and the last
// block's lower one from block 0's first row), a cluster barrier, then the
// row part in place, down each column with the previous row's old value
// in a register.
template <int kS, typename T>
__global__ void __launch_bounds__(kCrossThreads)
    k_cross_rows(const T* x, int sub, int W, int R, int iters, int out_rows,
                 int32_t* out) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s = reinterpret_cast<T*>(s_raw);
  cg::cluster_group cluster = cg::this_cluster();
  constexpr bool kWrapRows = kS == kNbminGuard || kS == kSublaneMaskAdd;
  int c = (int)cluster.block_rank(), b = blockIdx.y;
  int y0 = c * R, n = max(0, min(R, sub - y0));
  int last = (sub - 1) / R, n_last = sub - last * R;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int warps = blockDim.x >> 5;
  T* own = s + W;
  const T* xb = x + (long long)b * sub * W + (long long)y0 * W;
  for (int i = threadIdx.x; i < n * W; i += blockDim.x) own[i] = xb[i];
  // the rows above and below this block's, in their blocks' buffers
  const T* up = nullptr;
  const T* down = nullptr;
  if (n > 0 && (c > 0 || kWrapRows))
    up = cluster.map_shared_rank(s, c > 0 ? c - 1 : last) +
         (c > 0 ? R : n_last) * W;
  if (kS != kSublaneMaskAdd && n > 0 && (c < last || kWrapRows))
    down = cluster.map_shared_rank(s, c < last ? c + 1 : 0) + W;
  __syncthreads();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if constexpr (kS != kSublaneMaskAdd) {
      for (int y = warp; y < n; y += warps) {
        T* line = own + (long long)y * W;
        int r[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          int xx = 32 * j + lane;
          if (xx >= W) continue;
          int a = (int)line[xx], l, rr;
          if (kS == kNbmin8) {
            l = sh_at(line, xx, 1, W, 63);
            rr = sh_at(line, xx, -1, W, 63);
          } else {
            l = pen_at(line, xx, 1, W, kGuard);
            rr = pen_at(line, xx, -1, W, kGuard);
          }
          r[j] = min(a, min(l, rr));
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          int xx = 32 * j + lane;
          if (xx < W) line[xx] = (T)r[j];
        }
        __syncwarp();
      }
    }
    cluster.sync();                  // every block's rows hold the lane part
    if (n > 0) {
      T* below = own + (long long)n * W;
      for (int xx = threadIdx.x; xx < W; xx += blockDim.x) {
        int top = up ? (int)up[xx] : 63;
        if (kS == kSublaneMaskAdd && c == 0) top = wadd(top, kGuard);
        s[xx] = (T)top;
        if (kS != kSublaneMaskAdd) below[xx] = down ? down[xx] : (T)63;
      }
    }
    cluster.sync();                  // the halos are read
    for (int xx = threadIdx.x; xx < W; xx += blockDim.x) {
      int prev = (int)s[xx];
      for (int y = 0; y < n; ++y) {
        T* p = own + (long long)y * W + xx;
        int cur = (int)*p, nv = min(cur, prev);
        if (kS != kSublaneMaskAdd) nv = min(nv, (int)p[W]);
        *p = (T)nv;
        prev = cur;
      }
    }
    __syncthreads();
  }
  __syncthreads();
  int rows = min(n, out_rows - y0);
  int32_t* ob = out + (long long)b * out_rows * W + (long long)y0 * W;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) ob[i] = own[i];
}

template <int kS, typename T>
int launch(const void* xv, int B, int sub, int W, int iters, int out_rows,
           int32_t* out, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  if constexpr (kS == kTransposePair) {
    int tiles = (sub + 31) / 32 * ((W + 31) / 32);
    k_transpose_pair<T><<<dim3((tiles + kWarps - 1) / kWarps, B),
                          kWarps * 32, 0, st>>>(x, sub, W, iters, out_rows,
                                                out);
  } else if constexpr (kS == kMxuCumsum) {
    int Wp = (W + 15) & ~15;
    size_t smem = (size_t)kCumRows * ((Wp + 8) * 2 + Wp * 4);
    cudaError_t e = cudaFuncSetAttribute(
        k_mxu_cumsum, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    k_mxu_cumsum<<<dim3((sub + kCumRows - 1) / kCumRows, B), kWarps * 32,
                   smem, st>>>(x, sub, W, iters, out_rows, out);
  } else if constexpr (kS == kNbmin8 || kS == kNbminGuard ||
                       kS == kNbminMaskedSub || kS == kSublaneMaskAdd) {
    int R = (sub + kCluster - 1) / kCluster;
    size_t smem = (size_t)(R + 2) * W * sizeof(T);
    auto kernel = k_cross_rows<kS, T>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, B);
    cfg.blockDim = dim3(kCrossThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters == 0) return (int)cudaErrorInvalidConfiguration;
    e = cudaLaunchKernelEx(&cfg, kernel, x, sub, W, R, iters, out_rows, out);
    if (e != cudaSuccess) return (int)e;
  } else {
    int units = kS == kSegMin ? sub / 2 : sub;
    k_rows<kS, T><<<dim3((units + kWarps - 1) / kWarps, B), kWarps * 32, 0,
                    st>>>(x, sub, W, iters, out_rows, out);
  }
  HD_CHECK();
  return 0;
}

}  // namespace

// The 27 (step, type) pairs of ops/primitives.py's VARIANTS.
#define HD_PAIRS(X)                                                        \
  X(kMinScan, int32_t) X(kMinScan, int16_t) X(kMinScan, int8_t)            \
  X(kMaxScan, int16_t) X(kOrRoll, int32_t) X(kOrRoll, int16_t)             \
  X(kOrRoll, int8_t) X(kNbmin8, int32_t) X(kNbmin8, int16_t)               \
  X(kNbmin8, int8_t) X(kAdd, int32_t) X(kAdd, int16_t)                     \
  X(kSelect, int32_t) X(kSelect, int16_t) X(kTransposePair, int32_t)       \
  X(kTransposePair, int16_t) X(kSegMin, int32_t) X(kSegMin, int16_t)       \
  X(kMxuCumsum, int32_t) X(kCumsumLadder, int32_t) X(kMaskedMin, int32_t)  \
  X(kMaskedLadder5, int32_t) X(kNbminGuard, int32_t)                       \
  X(kNbminMaskedSub, int32_t) X(kOrAndMask, int32_t)                       \
  X(kMaxLadderFull, int32_t) X(kSublaneMaskAdd, int32_t)

// x: B planes [sub, W] of the step's type (dtype 0 int32, 1 int16, 2 int8);
// out: int32 [B, out_rows, W] (out_rows 1 or sub).  Returns 0, or a CUDA
// error (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int hd_primitive_steps(const void* x, int B, int sub, int W,
                                  int step, int dtype, int iters,
                                  int out_rows, int32_t* out,
                                  cudaStream_t st) {
  if (B < 1 || B > 65535 || sub < 1 || W < 1 || W > kMaxW || iters < 0 ||
      (out_rows != 1 && out_rows != sub) || (step == kSegMin && sub % 2) ||
      step < 0 || step > kSublaneMaskAdd || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  switch (step * 3 + dtype) {
#define HD_CASE(S, T)             \
  case S * 3 + dtype_code<T>():   \
    return launch<S, T>(x, B, sub, W, iters, out_rows, out, st);
    HD_PAIRS(HD_CASE)
#undef HD_CASE
  }
  return (int)cudaErrorInvalidValue;
}
