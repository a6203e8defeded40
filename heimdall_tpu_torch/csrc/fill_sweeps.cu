// Sweep hole fill for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (heimdall_tpu_torch/ops/_cuda.py, wrapped by
// heimdall_tpu_torch/ops/fill_sweeps.py).
//
// Replaces the Pallas kernel of heimdall_tpu's timing probe
// scripts/profile_fill_variants.py:211 (fill_param :107-166, variants
// :168-186): the preprocess, then the sweep hole fill of
// pallas_kernels.py::_fill_holes_sweeps (:432-496) with one ingredient
// swapped.  The contract is the hole fill's: exterior = background
// 4-connected to the frame border, filled = 1 - exterior.  The preprocess
// is hd_label's "pre" stage (the wrapper runs it first); this file does the
// fill, per frame:
//   seeds    e = background on the border (and on the guard rows);
//   row      grow4(e) & bg, then an OR over each background run of the row:
//            a doubling max-scan over the whole width of packed keys
//            runid*2 + f forward, then f - runid*2 backward;
//   column   the same along each column, the ladder cut to 5 steps (reach
//            31 rows: a deeper flood takes more sweeps);
//   repeat row + column until one grow4 adds nothing (the certificate).
// The variants pick the GPU counterpart of each ingredient of the TPU
// code as it stands:
//   pack   the run ids' start flags from a clamped read ("mxu") or from a
//          wrapped read with the penalty clamp ("ladder",
//          pallas_kernels.py:241-244); both then take the run ids from a
//          tensor-core product with the triangular 0/1 matrix, as
//          _lane_cumsum_mxu (:211-227) does (bf16 0/1 in, f32 sums below
//          2^24: exact), over the tiles of the matrix that are not all zero;
//   scan   each ladder step reads the wrapped neighbour and subtracts a
//          penalty where it wrapped, in branch-free arithmetic ("masked",
//          :155-165), or tests the index and selects a fill ("iota",
//          profile_fill_variants.py:89-105);
//   grow   four independent shifted ORs with constant-0 fills ("old",
//          :126-130), or a row max of masked lane reads then an up/down max
//          ("new", :131-140);
//   guard  8 rows of seeded background above and below the frame, so the
//          up/down reads of the frame's rows need no bounds test, and the
//          column ladder runs over H + 16 rows (or none).
// All nine give one function, which is also hd_label's "fill" stage.
//
// Design: the run ids take one launch per orientation (common.cuh's
// k_run_ids, one block per 16 lines, shared with the CCL probes).  Then one block per frame iterates the sweeps and the
// certificate with no host sync (k_sweep_fill): the exterior and background
// planes live as bits in shared memory (2 x (H + 16) x W / 8 bytes), each
// warp scans one row or column at a time through a line buffer in shared
// memory, and a phase updates the exterior in place (a row read after its
// neighbour's update only floods sooner: the fixpoint is the same).
//
// What bounds it on an H100 SXM: bytes, 0.37 us per 640x480 frame at 3.35
// TB/s for the whole probe (frame in, filled plane out; the run-id planes
// are scratch).  This first design is far from that: one block per frame
// (under two waves of 132 SMs at batch 256) and a 10-step ladder per row
// per sweep, as the TPU code does.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kFillWarps = 16;      // k_sweep_fill: one block per frame

enum Grow { kGrowNew = 0, kGrowOld = 1 };

// ------------------------------------------------------------ sweeps

__device__ __forceinline__ int bit(const uint32_t* p, int Wp, int y, int x) {
  return (p[y * Wp + (x >> 5)] >> (x & 31)) & 1;
}

// grow4(e) & bg at (y, x) of the guarded plane.
template <int kGrow, bool kGuard>
__device__ __forceinline__ int grow4(const Plane& pl, const uint32_t* eb,
                                     const uint32_t* bgb, int y, int x) {
  int Wp = pl.Wp;
  int e = bit(eb, Wp, y, x), g;
  if (kGrow == kGrowOld) {
    g = e | (y > 0 ? bit(eb, Wp, y - 1, x) : 0) |
        (y < pl.Hg - 1 ? bit(eb, Wp, y + 1, x) : 0) |
        (x > 0 ? bit(eb, Wp, y, x - 1) : 0) |
        (x < pl.W - 1 ? bit(eb, Wp, y, x + 1) : 0);
  } else {
    int wl = (x - 1) >> 31, wr = (pl.W - 2 - x) >> 31;   // -1: wrapped
    int left = bit(eb, Wp, y, x - 1 + (wl & pl.W)) - (wl & kPen);
    int right = bit(eb, Wp, y, x + 1 - (wr & pl.W)) - (wr & kPen);
    int row = max(e, max(left, right));
    // with guard rows, only the frame's rows get here: no bounds test
    int up = kGuard || y > 0 ? bit(eb, Wp, y - 1, x) : 0;
    int dn = kGuard || y < pl.Hg - 1 ? bit(eb, Wp, y + 1, x) : 0;
    g = max(row, max(up, dn));
  }
  return g & bit(bgb, Wp, y, x);
}

// One block per frame: the sweeps to the certificate, then filled u8
// [B, H, W] = 1 - exterior.  rb_r [B, Hg, W] and rb_t [B, W, Hg] are
// k_run_ids' outputs.  Shared memory: exterior and background bits
// [Hg][Wp] each, then one line buffer of max(W, Hg) ints per warp.
template <int kScan, int kGrow, bool kGuard>
__global__ void __launch_bounds__(kFillWarps * 32, 1)
    k_sweep_fill(Plane pl, const uint8_t* mask, const int16_t* rb_r,
                 const int16_t* rb_t, int row_steps, int col_steps,
                 uint8_t* filled) {
  extern __shared__ uint32_t sm[];
  int nwords = pl.Hg * pl.Wp, Wp = pl.Wp;
  uint32_t* eb = sm;
  uint32_t* bgb = sm + nwords;
  int lstride = max(pl.W, pl.Hg);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* line = reinterpret_cast<int*>(sm + 2 * nwords) + warp * lstride;
  int b = blockIdx.x;
  const uint8_t* m = mask + (long long)b * pl.H * pl.W;
  const int16_t* rr = rb_r + (long long)b * pl.Hg * pl.W;
  const int16_t* rt = rb_t + (long long)b * pl.W * pl.Hg;

  // background bits, and the seeds: background on the frame's border rows
  // and columns and on the guard rows
  for (int y = warp; y < pl.Hg; y += kFillWarps) {
    bool edge_row = y <= pl.G || y >= pl.G + pl.H - 1;
    for (int w = 0; w < Wp; ++w) {
      int x = 32 * w + lane;
      int bgv = x < pl.W && bg_at(pl, m, y, x);
      unsigned bgw = __ballot_sync(kFull, bgv);
      unsigned seed = __ballot_sync(
          kFull, bgv && (edge_row || x == 0 || x == pl.W - 1));
      if (lane == 0) {
        bgb[y * Wp + w] = bgw;
        eb[y * Wp + w] = seed;
      }
    }
  }
  __syncthreads();

  // rows the phases update: with guard rows, the frame's (the guard rows
  // stay exterior)
  int y_lo = kGuard ? pl.G : 0, y_hi = y_lo + pl.H;
  int v[kMaxPerLane], rb[kMaxPerLane];
  while (true) {
    // row phase: each warp one row per round
    for (int y0 = y_lo; y0 < y_hi; y0 += kFillWarps) {
      int y = y0 + warp;
      bool act = y < y_hi;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        int x = 32 * j + lane;
        bool in = act && x < pl.W;
        v[j] = in ? grow4<kGrow, kGuard>(pl, eb, bgb, y, x) : 0;
        rb[j] = in ? rr[(long long)y * pl.W + x] : 0;
      }
      __syncthreads();     // every grow of the round has read the exterior
      if (act) {
        run_max<kScan>(v, rb, line, pl.W, row_steps, lane);
#pragma unroll
        for (int j = 0; j < kMaxPerLane; ++j) {
          int x = 32 * j + lane;
          if (32 * j >= pl.W) break;
          unsigned word = __ballot_sync(
              kFull, x < pl.W && (v[j] & bit(bgb, Wp, y, x)));
          if (lane == 0) eb[y * Wp + j] = word;
        }
      }
      __syncthreads();
    }
    // column phase: each warp one column per round, 16 columns a round
    for (int x0 = 0; x0 < pl.W; x0 += kFillWarps) {
      int x = x0 + warp;
      bool act = x < pl.W;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        int y = 32 * j + lane;
        bool in = act && y < pl.Hg;
        bool guard_row = kGuard && (y < y_lo || y >= y_hi);
        v[j] = !in        ? 0
               : guard_row ? 1
                           : grow4<kGrow, kGuard>(pl, eb, bgb, y, x);
        rb[j] = in ? rt[(long long)x * pl.Hg + y] : 0;
      }
      __syncthreads();
      if (act) {
        run_max<kScan>(v, rb, line, pl.Hg, col_steps, lane);
#pragma unroll
        for (int j = 0; j < kMaxPerLane; ++j) {
          int y = 32 * j + lane;
          if (y < pl.Hg) line[y] = v[j] & bit(bgb, Wp, y, x);
        }
      }
      __syncthreads();
      // the round's 16 columns into the exterior bits, one row per thread
      int* lines = reinterpret_cast<int*>(sm + 2 * nwords);
      for (int y = threadIdx.x; y < pl.Hg; y += blockDim.x) {
        uint32_t bits = 0;
        for (int c = 0; c < kFillWarps && x0 + c < pl.W; ++c)
          bits |= (uint32_t)(lines[c * lstride + y] & 1) << c;
        eb[y * Wp + (x0 >> 5)] |= bits << (x0 & 31);
      }
      __syncthreads();
    }
    // the certificate: does one more grow4 add anything?
    int more = 0;
    for (int y = y_lo + warp; y < y_hi; y += kFillWarps)
      for (int x = lane; x < pl.W; x += 32)
        more |= !bit(eb, Wp, y, x) && grow4<kGrow, kGuard>(pl, eb, bgb, y, x);
    if (!__syncthreads_or(more)) break;
  }

  uint8_t* out = filled + (long long)b * pl.H * pl.W;
  for (int y = warp; y < pl.H; y += kFillWarps)
    for (int x = lane; x < pl.W; x += 32)
      out[(long long)y * pl.W + x] = !bit(eb, Wp, y + pl.G, x);
}

size_t sweep_smem(const Plane& pl) {
  return (size_t)2 * pl.Hg * pl.Wp * 4 +
         (size_t)kFillWarps * std::max(pl.W, pl.Hg) * 4;
}

template <int kScan, int kGrow, bool kGuard>
int launch_sweep(const Plane& pl, int B, const uint8_t* mask,
                 const int16_t* rb_r, const int16_t* rb_t, uint8_t* filled,
                 cudaStream_t st) {
  auto kernel = k_sweep_fill<kScan, kGrow, kGuard>;
  size_t smem = sweep_smem(pl);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int col_steps = std::min(ceil_log2(pl.Hg), 5);
  kernel<<<B, kFillWarps * 32, smem, st>>>(pl, mask, rb_r, rb_t,
                                           ceil_log2(pl.W), col_steps, filled);
  HD_CHECK();
  return 0;
}

}  // namespace

// Run ids of the background of mask u8 [B, H, W] (1 = foreground), with
// `guard` rows of background above and below (0 or 1: 8 rows): rb_r int16
// [B, H + 16 guard, W] along the rows and rb_t int16 [B, W, H + 16 guard]
// along the columns, each 2 * (number of run starts up to the position).
// pack: 0 "mxu" (clamped start read), 1 "ladder" (wrapped read and the
// penalty clamp).  W and H + 16 guard at most 1024.  Returns the first CUDA
// error.
extern "C" int hd_run_ids(const uint8_t* mask, int B, int H, int W,
                          int guard, int pack, int16_t* rb_r, int16_t* rb_t,
                          void* stream) {
  Plane pl = plane_of(H, W, guard);
  if (pl.W > 32 * kMaxPerLane || pl.Hg > 32 * kMaxPerLane)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return pack ? launch_run_ids_rc<kPackLadder, kRunsBg>(pl, B, mask, 2, rb_r,
                                                        rb_t, st)
              : launch_run_ids_rc<kPackMxu, kRunsBg>(pl, B, mask, 2, rb_r,
                                                     rb_t, st);
}

// The sweep fill of mask u8 [B, H, W] (1 = foreground) with hd_run_ids'
// rb_r / rb_t (the same guard): filled u8 [B, H, W] (0/1).  scan: 0
// "masked", 1 "iota"; grow: 0 "new", 1 "old"; guard 0 or 1.  W and H + 16
// at most 1024, and the bit planes and line buffers must fit one block's
// shared memory.  Returns the first CUDA error.
extern "C" int hd_sweep_fill(const uint8_t* mask, int B, int H, int W,
                             int guard, int scan, int grow,
                             const int16_t* rb_r, const int16_t* rb_t,
                             uint8_t* filled, void* stream) {
  Plane pl = plane_of(H, W, guard);
  if (pl.W > 32 * kMaxPerLane || pl.Hg > 32 * kMaxPerLane ||
      sweep_smem(pl) > 232448)
    return (int)cudaErrorInvalidValue;
  int v = (scan ? 4 : 0) | (grow ? 2 : 0) | (guard ? 1 : 0);
  using Launch = int (*)(const Plane&, int, const uint8_t*, const int16_t*,
                         const int16_t*, uint8_t*, cudaStream_t);
  Launch launch;
  switch (v) {
    case 0: launch = launch_sweep<0, 0, false>; break;
    case 1: launch = launch_sweep<0, 0, true>; break;
    case 2: launch = launch_sweep<0, 1, false>; break;
    case 3: launch = launch_sweep<0, 1, true>; break;
    case 4: launch = launch_sweep<1, 0, false>; break;
    case 5: launch = launch_sweep<1, 0, true>; break;
    case 6: launch = launch_sweep<1, 1, false>; break;
    default: launch = launch_sweep<1, 1, true>; break;
  }
  return launch(pl, B, mask, rb_r, rb_t, filled, (cudaStream_t)stream);
}
