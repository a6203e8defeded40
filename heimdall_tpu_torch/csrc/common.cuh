// Device helpers shared by the port's kernels (fused_detect.cu,
// ccl_tiled.cu, stats_tiled.cu, runtable_tiled.cu, pre_variants.cu,
// fill_sweeps.cu): the 32 x 8 pixel mapping and its per-frame skip, the
// preprocess's taps, borders and gray, union-find with atomicMin hooking,
// block scans and sums for 256-thread blocks, a search in a sorted root
// table, the slot-list writer, the launch check of the entry points, and
// the sweep probes' machinery
// (fill_sweeps.cu, ccl_sweeps.cu, joint_label.cu): the guarded plane, the
// run ids of its lines on the tensor cores, and the warp's doubling ladder
// over run-packed keys.  Each .cu that includes this file is its own
// library, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// In an entry point: return the error of the launch just queued, if any.
#define HD_CHECK()                                 \
  do {                                             \
    cudaError_t hd_err = cudaGetLastError();       \
    if (hd_err != cudaSuccess) return (int)hd_err; \
  } while (0)

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileW = 32;        // one warp = 32 consecutive pixels of a row
constexpr int kTileH = 8;         // 8 warps per block
constexpr int kScanThreads = 256; // block size of every scan/sum kernel
constexpr int kMaxSlots = 1024;   // largest K of the slot-incidence kernels
// Rows of tiles a block column covers at most when frames may be skipped
// (tile_grid): a skipped frame then costs few blocks, not one per tile.
constexpr int kSkipTileRows = 4;

// A frame batch as the entry points receive it: C = 1 (gray only) or 3
// (b, g, r at data + b*fstride + p*pstride + c*cstride).
struct Frames {
  const uint8_t* data;
  int C;
  long long fstride, cstride, pstride;
};

// Frame geometry; the band-tiled kernels also set the band layout: R =
// ceil(H / band) bands of `band` rows, the last one maybe shorter.  Planes
// are [B, H, W], unpadded.  With `active` (int32 [B] on the device) the
// kernels skip every frame b whose active[b] is 0 and leave its outputs
// unwritten: two routes share one set of outputs, each writing its frames,
// with no host sync to choose.
struct Geom {
  int H, W;
  long long HW;
  int band, R;
  const int* active = nullptr;
};

__device__ __forceinline__ bool frame_skipped(const Geom& g, int b) {
  return g.active != nullptr && g.active[b] == 0;
}

__device__ __forceinline__ long long band_lo(const Geom& g, int r) {
  return (long long)r * g.band * g.W;
}

__device__ __forceinline__ long long band_hi(const Geom& g, int r) {
  return (long long)min((r + 1) * g.band, g.H) * g.W;
}

struct Pix {
  int x, y, b, lane;
  bool in;
  long long p;   // linear index within the frame
};

// This thread's pixel in the tile of column blockIdx.x, tile row ty and
// frame blockIdx.z.
__device__ __forceinline__ Pix pix_at(const Geom& g, int ty) {
  Pix q;
  q.lane = threadIdx.x;
  q.x = blockIdx.x * kTileW + threadIdx.x;
  q.y = ty * kTileH + threadIdx.y;
  q.b = blockIdx.z;
  q.in = q.x < g.W && q.y < g.H;
  q.p = (long long)q.y * g.W + q.x;
  return q;
}

__device__ __forceinline__ Pix pix(const Geom& g) {
  return pix_at(g, blockIdx.y);
}

// The preprocess's taps: the Q8 blur5 and the f32 mean11.
struct Taps {
  int q8[5];
  float k11[11];
};

inline Taps taps_of(const int* q8, const float* k11) {
  Taps t;
  memcpy(t.q8, q8, sizeof(t.q8));
  memcpy(t.k11, k11, sizeof(t.k11));
  return t;
}

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

__device__ __forceinline__ int clampi(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

__device__ __forceinline__ int gray_at(const Frames& f, int b, long long p) {
  const uint8_t* d = f.data + b * f.fstride + p * f.pstride;
  if (f.C == 3) {
    int bb = d[0], gg = d[f.cstride], rr = d[2 * f.cstride];
    return (bb * 3735 + gg * 19235 + rr * 9798 + (1 << 14)) >> 15;
  }
  return d[0];
}

// Calls body(q) for every tile row this block covers: its own tile when no
// frame is skipped (the grid has one block per tile), else tile rows
// blockIdx.y, then steps of gridDim.y, unless the frame is skipped.  The
// first case keeps its own straight-line copy of body, which the band
// route's kernels run when called directly.  Every thread of the block
// runs the same rows, so body may use warp votes; a `return` in body ends
// that tile only.
template <typename Body>
__device__ __forceinline__ void for_each_tile(const Geom& g, Body body) {
  if (g.active == nullptr) {
    body(pix(g));
    return;
  }
  if (g.active[blockIdx.z] == 0) return;
  int rows = (g.H + kTileH - 1) / kTileH;
  for (int ty = blockIdx.y; ty < rows; ty += gridDim.y) body(pix_at(g, ty));
}

// Launch grid of the for_each_tile kernels: one block per tile, or, when
// frames may be skipped, at most kSkipTileRows tile rows per frame.
inline dim3 tile_grid(const Geom& g, int B) {
  int rows = (g.H + kTileH - 1) / kTileH;
  if (g.active != nullptr && rows > kSkipTileRows) rows = kSkipTileRows;
  return dim3((g.W + kTileW - 1) / kTileW, rows, B);
}

__device__ __forceinline__ int find_root(const volatile int32_t* P, int x) {
  int p = P[x];
  while (p != x) {
    x = p;
    p = P[x];
  }
  return x;
}

// Hook the larger root under the smaller one, so that every root is the
// minimum linear index of its tree.  A failed atomicMin means another thread
// re-parented b first: carry on with b's new parent.
__device__ void unite(int32_t* P, int a, int b) {
  while (true) {
    a = find_root(P, a);
    b = find_root(P, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(&P[b], a);
    if (old == b) return;
    b = old;
  }
}

// Exclusive scan over a 256-thread block; *total gets the block's sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int all;
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sum[wid] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) {
      int s = warp_sum[w];
      warp_sum[w] = run;
      run += s;
    }
    all = run;
  }
  __syncthreads();
  int excl = incl - v + warp_sum[wid];
  *total = all;
  __syncthreads();
  return excl;
}

// Sum over a 256-thread block; the result is valid in thread 0.
__device__ int block_sum(int v) {
  __shared__ int part[kScanThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) part[wid] = v;
  __syncthreads();
  int t = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kScanThreads / 32; ++w) t += part[w];
  __syncthreads();
  return t;
}

// Position of `v` in the ascending table t[0..n), or -1.
__device__ __forceinline__ int find_slot(const int* t, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (t[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < n && t[lo] == v ? lo : -1;
}

// One band's slot list from its presence flags pres[0..K): the present
// slots ascending, then the absent ones ascending; *count gets the number
// present.  Run by one thread.
__device__ void write_slot_list(const int* pres, int K, int32_t* list,
                                int32_t* count) {
  int c = 0;
  for (int k = 0; k < K; ++k)
    if (pres[k]) list[c++] = k;
  *count = c;
  for (int k = 0; k < K; ++k)
    if (!pres[k]) list[c++] = k;
}

// ------------------------------------------------------------ sweep probes
//
// The sweep probes (the TPU code's _fill_holes_sweeps, _ccl_sweeps and
// _label_flood_joint with one ingredient swapped) scan lines of a guarded
// plane: the frame's H rows between G rows of guard above and below (G = 0
// or kGuardRows).  A line is a row (W px) or a column (Hg px) of it, at most
// 32 * kMaxPerLane px, held by one warp as v[j] = position 32 * j + lane.

constexpr int kPen = 1 << 30;       // the TPU code's _PEN
constexpr int kGuardRows = 8;
constexpr int kMaxPerLane = 32;     // lines of at most 32 x 32 = 1024 px
constexpr int kPackWarps = 8;       // k_run_ids: 16 lines per block

enum Pack { kPackMxu = 0, kPackLadder = 1 };
enum Scan { kScanMasked = 0, kScanIota = 1 };
// Whose runs k_run_ids numbers: background's, foreground's, or every
// maximal stretch of one class (foreground or background) along the line.
enum Runs { kRunsBg = 0, kRunsFg = 1, kRunsClass = 2 };

// The guarded plane: the frame's H rows below G guard rows and above G
// more, Wp 32-bit words per row of bits.
struct Plane {
  int H, W, G, Hg, Wp;
};

inline Plane plane_of(int H, int W, int guard) {
  int G = guard ? kGuardRows : 0;
  return Plane{H, W, G, H + 2 * G, (W + 31) / 32};
}

// Foreground of the guarded plane (mask u8 [H, W], nonzero = foreground):
// guard rows are background.
__device__ __forceinline__ int fg_at(const Plane& pl, const uint8_t* mask,
                                     int y, int x) {
  int yf = y - pl.G;
  return yf >= 0 && yf < pl.H && mask[(long long)yf * pl.W + x] != 0;
}

__device__ __forceinline__ int bg_at(const Plane& pl, const uint8_t* mask,
                                     int y, int x) {
  return !fg_at(pl, mask, y, x);
}

inline int ceil_log2(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return s > 0 ? s : 1;
}

__device__ __forceinline__ uint32_t bf16_one(bool v) {
  return v ? 0x3F80u : 0u;
}

// d += a * b over one 16 x 8 x 16 tile, bf16 in, f32 accumulate.
// Fragments (g = lane / 4, t = lane % 4; two bf16 per register, the lower
// index in the low half): a0 (row g, cols 2t, 2t + 1), a1 (g + 8, 2t ..),
// a2 (g, 2t + 8 ..), a3 (g + 8, 2t + 8 ..); b0 (rows 2t, 2t + 1, col g),
// b1 (rows 2t + 8, 2t + 9, col g); d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8,
// 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Run ids along the lines of the guarded plane: out[line][j] = scale * (the
// number of run starts at positions <= j) of kRuns' runs.  kCols: the lines
// are the columns (length Hg, out [B, W, Hg]); else the rows (length W, out
// [B, Hg, W]).  One block per 16 lines of one frame: the start flags go to
// shared memory as bf16, then out = starts x U (U[k][j] = k <= j) on the
// tensor cores, each warp taking 8-wide column tiles j and only the k tiles
// at or below them.  kPack (background runs only): the start flag reads the
// previous position clamped ("mxu") or wrapped with the penalty clamp
// ("ladder", pallas_kernels.py:241-244); the other runs read it clamped.
// A class run starts at position 0 and wherever the class changes.
// kSkip: frames whose skip[b] is nonzero are left unwritten, and *ran
// counts the frames numbered (one add a frame).
template <bool kCols, int kPack, int kRuns, bool kSkip = false>
__global__ void k_run_ids(Plane pl, const uint8_t* mask, int scale,
                          int16_t* out, const int32_t* skip = nullptr,
                          int32_t* ran = nullptr) {
  extern __shared__ uint32_t s_start[];     // [16][stride / 2] bf16 pairs
  int nlines = kCols ? pl.W : pl.Hg, L = kCols ? pl.Hg : pl.W;
  int Lp = (L + 15) & ~15, stride = Lp + 8;  // in bf16; +8 spreads banks
  int line0 = blockIdx.x * 16, b = blockIdx.y;
  if (kSkip) {
    if (skip[b]) return;
    if (ran != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
      atomicAdd(ran, 1);
  }
  const uint8_t* m = mask + (long long)b * pl.H * pl.W;
  uint16_t* s16 = reinterpret_cast<uint16_t*>(s_start);
  for (int i = threadIdx.x; i < 16 * Lp; i += blockDim.x) {
    // kCols: neighbouring threads take neighbouring columns of one row
    int r = kCols ? i & 15 : i / Lp, k = kCols ? i >> 4 : i - r * Lp;
    int line = line0 + r;
    bool start = false;
    if (line < nlines && k < L) {
      auto at = [&](int kk) {
        int f = kCols ? fg_at(pl, m, kk, line) : fg_at(pl, m, line, kk);
        return kRuns == kRunsBg ? 1 - f : f;
      };
      if (kRuns == kRunsClass) {
        start = k == 0 || at(k) != at(k - 1);
      } else {
        int prev;
        if (kPack == kPackMxu) {
          prev = k > 0 ? at(k - 1) : 0;          // clamped read, fill 0
        } else {
          int w = (k - 1) >> 31;                 // -1 where the read wraps
          prev = max(at(k - 1 + (w & L)) - (w & kPen), 0);
        }
        start = at(k) && !prev;
      }
    }
    s16[r * stride + k] = (uint16_t)bf16_one(start);
  }
  __syncthreads();

  int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  int half = stride / 2;                     // 32-bit words per line
  for (int nt = threadIdx.x >> 5; nt * 8 < L; nt += kPackWarps) {
    int j = nt * 8 + gid;                    // this lane's column of U
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    // the k tiles below the last one lie wholly at or below the tile's
    // columns: U is all ones there
    int kt_last = (nt * 8 + 7) >> 4;
    for (int kt = 0; kt <= kt_last; ++kt) {
      int w0 = kt * 8 + tig;                 // word of (k0 + 2t, k0 + 2t + 1)
      uint32_t a[4] = {s_start[gid * half + w0],
                       s_start[(gid + 8) * half + w0],
                       s_start[gid * half + w0 + 4],
                       s_start[(gid + 8) * half + w0 + 4]};
      int k = kt * 16 + 2 * tig;
      uint32_t b0 = 0x3F803F80u, b1 = 0x3F803F80u;
      if (kt == kt_last) {
        b0 = bf16_one(k <= j) | bf16_one(k + 1 <= j) << 16;
        b1 = bf16_one(k + 8 <= j) | bf16_one(k + 9 <= j) << 16;
      }
      mma_bf16(d, a, b0, b1);
    }
    for (int i = 0; i < 4; ++i) {
      int line = line0 + gid + (i >> 1) * 8, c = nt * 8 + 2 * tig + (i & 1);
      if (line < nlines && c < L)
        out[((long long)b * nlines + line) * L + c] =
            (int16_t)(scale * (int)d[i]);
    }
  }
}

template <bool kCols, int kPack, int kRuns, bool kSkip = false>
int launch_run_ids(const Plane& pl, int B, const uint8_t* mask, int scale,
                   int16_t* out, cudaStream_t st,
                   const int32_t* skip = nullptr, int32_t* ran = nullptr) {
  int nlines = kCols ? pl.W : pl.Hg, L = kCols ? pl.Hg : pl.W;
  size_t smem = (size_t)16 * (((L + 15) & ~15) + 8) * 2;
  auto kernel = k_run_ids<kCols, kPack, kRuns, kSkip>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((nlines + 15) / 16, B), kPackWarps * 32, smem, st>>>(
      pl, mask, scale, out, skip, ran);
  HD_CHECK();
  return 0;
}

// Both orientations' run ids (rows into rb_r, columns into rb_t); with
// kSkip only of the frames whose skip[b] is 0, counted in *ran by the rows'
// launch.
template <int kPack, int kRuns, bool kSkip = false>
int launch_run_ids_rc(const Plane& pl, int B, const uint8_t* mask, int scale,
                      int16_t* rb_r, int16_t* rb_t, cudaStream_t st,
                      const int32_t* skip = nullptr, int32_t* ran = nullptr) {
  int err = launch_run_ids<false, kPack, kRuns, kSkip>(pl, B, mask, scale,
                                                       rb_r, st, skip, ran);
  if (err) return err;
  return launch_run_ids<true, kPack, kRuns, kSkip>(pl, B, mask, scale, rb_t,
                                                   st, skip, nullptr);
}

// In-place doubling max-scan of one warp's line v (position 32 * j + lane
// in v[j], n positions, n <= 32 * kPer) over `steps` steps of shifts 1, 2,
// 4, ...: from lower positions, or with kBack from higher ones.  The line
// goes through the warp's buffer (position x at line[x * stride]) at every
// step.  A read past the line's end is the fill: a wrapped read less the
// penalty ("masked", the TPU code's _max_scan_masked) or an index test
// ("iota").
template <int kScan, bool kBack, int kPer>
__device__ __forceinline__ void max_scan(int (&v)[kPer], int* line, int n,
                                         int steps, int lane, int stride) {
  for (int s = 0; s < steps; ++s) {
    int d = 1 << s;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int x = 32 * j + lane;
      if (x < n) line[x * stride] = v[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int x = 32 * j + lane;
      if (x >= n) continue;
      int src = kBack ? x + d : x - d, u;
      if (kScan == kScanIota) {
        u = (kBack ? src < n : src >= 0) ? line[src * stride] : -kPen;
      } else {
        int w = (kBack ? n - 1 - src : src) >> 31;   // -1 where it wraps
        u = line[(kBack ? src - (w & n) : src + (w & n)) * stride] -
            (w & kPen);
      }
      v[j] = max(v[j], u);
    }
    __syncwarp();
  }
}

// The max over each run of a warp's line, by max-scans of packed keys: v +
// rb forward, then v - rb backward (rb: the run ids times a step above
// every value's spread, so no run's keys reach another's).  The ladder's
// reach is 2^steps - 1 positions each way.
template <int kScan, int kPer>
__device__ __forceinline__ void run_max(int (&v)[kPer],
                                        const int (&rb)[kPer], int* line,
                                        int n, int steps, int lane,
                                        int stride = 1) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] += rb[j];
  max_scan<kScan, false>(v, line, n, steps, lane, stride);
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] -= 2 * rb[j];
  max_scan<kScan, true>(v, line, n, steps, lane, stride);
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] += rb[j];
}

// The min over each run (the TPU code's _run_min_packed: min-scans of v -
// rb forward, v + rb backward): run_max of -v.
template <int kScan, int kPer>
__device__ __forceinline__ void run_min(int (&v)[kPer],
                                        const int (&rb)[kPer], int* line,
                                        int n, int steps, int lane,
                                        int stride = 1) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = -v[j];
  run_max<kScan>(v, rb, line, n, steps, lane, stride);
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = -v[j];
}

// One min phase of a sweep over int32 planes [Hg, W] by a block of `warps`
// warps: for every position, cand(y, x) (y in [0, Hg)), then the min over
// each run of the line (run ids `runs` times `big`: [Hg, W] along the rows,
// [W, Hg] along the columns; ladder of `steps`), handed to out(y, x, v) for
// the rows y_lo <= y < y_hi.  Rows: one warp per row, through its line
// buffer.  kCols: 32 columns at a time through a tile of [Hg][33] ints in
// shared memory (coalesced reads and writes; the 33 spreads the banks), one
// warp per column of the tile.  smem holds max(warps * W, 33 * Hg) ints.
// Ends with the block synchronised.
template <bool kCols, typename Cand, typename Out>
__device__ __forceinline__ void sweep_phase(const Plane& pl, int y_lo,
                                            int y_hi, const int16_t* runs,
                                            int big, int steps, int* smem,
                                            int warps, Cand cand, Out out) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v[kMaxPerLane], rb[kMaxPerLane];
  if (!kCols) {
    // cand and out run in loops that are not unrolled (they may be long);
    // each lane touches only its own positions 32 * j + lane of the line
    // outside the ladder
    int* line = smem + warp * pl.W;
    for (int y = y_lo + warp; y < y_hi; y += warps) {
      for (int x = lane; x < pl.W; x += 32) line[x] = cand(y, x);
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        int x = 32 * j + lane;
        bool in = x < pl.W;
        v[j] = in ? line[x] : 0;
        rb[j] = in ? big * runs[(long long)y * pl.W + x] : 0;
      }
      run_min<kScanMasked>(v, rb, line, pl.W, steps, lane);
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        int x = 32 * j + lane;
        if (x < pl.W) line[x] = v[j];
      }
      for (int x = lane; x < pl.W; x += 32) out(y, x, line[x]);
      __syncwarp();
    }
    __syncthreads();
    return;
  }
  for (int x0 = 0; x0 < pl.W; x0 += 32) {
    for (int i = threadIdx.x; i < pl.Hg * 32; i += blockDim.x) {
      int y = i >> 5, c = i & 31;
      if (x0 + c < pl.W) smem[y * 33 + c] = cand(y, x0 + c);
    }
    __syncthreads();
    for (int c = warp; c < 32 && x0 + c < pl.W; c += warps) {
      int x = x0 + c;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        int y = 32 * j + lane;
        bool in = y < pl.Hg;
        v[j] = in ? smem[y * 33 + c] : 0;
        rb[j] = in ? big * runs[(long long)x * pl.Hg + y] : 0;
      }
      run_min<kScanMasked>(v, rb, smem + c, pl.Hg, steps, lane, 33);
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        int y = 32 * j + lane;
        if (y < pl.Hg) smem[y * 33 + c] = v[j];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (y_hi - y_lo) * 32; i += blockDim.x) {
      int y = y_lo + (i >> 5), c = i & 31;
      if (x0 + c < pl.W) out(y, x0 + c, smem[y * 33 + c]);
    }
    __syncthreads();
  }
}

// Shared memory of sweep_phase, in bytes.
inline size_t sweep_phase_smem(const Plane& pl, int warps) {
  size_t rows = (size_t)warps * pl.W, cols = (size_t)33 * pl.Hg;
  return 4 * (rows > cols ? rows : cols);
}

}  // namespace
