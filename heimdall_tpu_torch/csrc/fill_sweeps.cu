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
//   row      grow4(e) & bg, then an OR over each background run of the row;
//   column   the same along each column;
//   repeat row + column until one grow4 adds nothing (the certificate).
// The TPU code takes each run-OR as a doubling max-scan of run-packed keys
// (a ladder of log2(W) steps, the column ladder cut to 5 steps, reach 31
// rows).  Here a run-OR is carry arithmetic on bit words, with full reach
// both ways, so no sweep stops short of a run's end and no run ids are
// needed.  Of the variants' ingredients two have counterparts in words:
//   grow   "old": four shifted ORs with constant-0 fills at the row's ends;
//          "new": the row rotated by one bit each way (the wrapped bit
//          taken in) and the edge masks clearing what wrapped;
//   guard  8 rows of seeded background above and below the frame, so the
//          up/down reads of the frame's rows need no bounds test (or none).
// "pack" and "scan" are ingredients of the ladder and its run ids, which
// this design does not have: variants that differ only there run the same
// (grow, guard) instance.  All give one function, which is also hd_label's
// "fill" stage.
//
// Design: one block of 512 threads a frame iterates the sweeps and the
// certificate with no host sync (k_carry_fill).  The exterior and
// background planes live as bit words in shared memory, (H + 16) x ceil(W /
// 32) words each (79 KB for both at 640x480 with guard rows), so two frames
// share an SM and a batch of 256 runs in one wave of 132 SMs.
//   load     16-byte loads of the mask (rows whose width is a multiple of
//            16), 32 bytes to a word; else a warp a row of byte loads and
//            ballots;
//   row      a warp a row, a lane a word (W <= 1024): for seeds s within
//            the background b, ((b + s) ^ b) & b | s fills each run from
//            its lowest seed upward (the carry runs through the ones of b;
//            `| s` puts back seeds that a carry passed through), with the
//            carries between words by a carry-lookahead over the warp's
//            ballots of generate (the word's sum overflowed) and propagate
//            (it is all ones); the downward fill is the same on the row
//            reversed (__brev of the words in reverse lane order);
//   column   a thread a word column and a segment of rows: in the segment,
//            the seeds, the carry out of its last row with none coming in,
//            the carry out of its first row upward, and whether the column
//            is background all through it (AND of b); one thread a word
//            column chains the segments' carries both ways; each segment
//            then fills its rows from its carries in, downward and upward;
//   certificate an OR over the block of grow4(e) & b & ~e.
// A phase updates the exterior in place: a word read while its neighbour
// is being written is either value, both sets of exterior pixels, so a
// race only floods sooner and the fixpoint is the same.
//
// What bounds it on an H100 SXM: bytes, 0.18 us per 640x480 frame at 3.35
// TB/s for the fill (mask in, filled plane out, 1 B/px each), 0.37 for the
// whole probe (the frame's 3 B/px in instead of the mask).
//
// hd_run_ids, the run ids of the first design's ladders (common.cuh's
// k_run_ids, one launch per orientation, a tensor-core product with the
// triangular 0/1 matrix), stays as a probe entry of its own: the sweep CCL
// probes (ccl_sweeps.cu, joint_label.cu) run the same kernels.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kFillThreads = 512;
constexpr int kFillWarps = kFillThreads / 32;

enum Grow { kGrowNew = 0, kGrowOld = 1 };

// The segments of the column phase: thread t takes word column t % Wp and
// rows [seg * len, (seg + 1) * len) of the guarded plane, seg = t / Wp <
// nseg.
struct Segs {
  int len, nseg;
};

inline Segs segs_of(const Plane& pl) {
  int per = std::max(1, std::min(kFillThreads / pl.Wp, pl.Hg));
  int len = (pl.Hg + per - 1) / per;
  return Segs{len, (pl.Hg + len - 1) / len};
}

size_t carry_smem(const Plane& pl) {
  return (size_t)2 * pl.Hg * pl.Wp * 4 + (size_t)3 * kFillThreads * 4;
}

// The bits of a row's word w that lie in the frame (W columns).
__device__ __forceinline__ uint32_t in_row(const Plane& pl, int w) {
  int n = pl.W - 32 * w;
  return n >= 32 ? kFull : (1u << n) - 1u;
}

// grow4 of the exterior word e (word w of its row) from the words above
// and below (0 outside the plane), before and after it in the row (prev,
// next; 0 past the row's ends) and the row's first and last words (for
// kGrowNew: a rotation wraps them in, the edge masks take that out).
template <int kGrow>
__device__ __forceinline__ uint32_t grow_word(const Plane& pl, int w,
                                              uint32_t e, uint32_t up,
                                              uint32_t dn, uint32_t prev,
                                              uint32_t next, uint32_t first,
                                              uint32_t last) {
  uint32_t left, right;     // bit x of left is e's bit x - 1, of right x + 1
  if (kGrow == kGrowOld) {
    left = e << 1 | prev >> 31;
    right = e >> 1 | next << 31;
  } else {
    int r = (pl.W - 1) & 31;                  // the row's last bit
    bool w0 = w == 0, wl = w == pl.Wp - 1;
    left = e << 1 | (w0 ? last << (31 - r) : prev) >> 31;
    left &= w0 ? ~1u : kFull;
    right = e >> 1 | (wl ? (first & 1u) << r : next << 31);
    right &= wl ? ~(1u << r) : kFull;
  }
  return e | up | dn | left | right;
}

// Row y's words: lane w < Wp takes word w, the other lanes 0.  Returns s =
// grow4(e) & b of this lane's word and sets its e and b.  Every lane of
// the warp calls it.
template <int kGrow, bool kGuard>
__device__ __forceinline__ uint32_t row_seeds(const Plane& pl,
                                              const uint32_t* eb,
                                              const uint32_t* bgb, int y,
                                              int lane, uint32_t& e,
                                              uint32_t& b) {
  bool in = lane < pl.Wp;
  const int o = y * pl.Wp + lane;
  e = in ? eb[o] : 0u;
  b = in ? bgb[o] : 0u;
  // with guard rows, only the frame's rows get here: no bounds test
  uint32_t up = in && (kGuard || y > 0) ? eb[o - pl.Wp] : 0u;
  uint32_t dn = in && (kGuard || y < pl.Hg - 1) ? eb[o + pl.Wp] : 0u;
  uint32_t prev = __shfl_up_sync(kFull, e, 1);
  uint32_t next = __shfl_down_sync(kFull, e, 1);
  prev = lane > 0 ? prev : 0u;
  next = lane < pl.Wp - 1 ? next : 0u;
  uint32_t first = __shfl_sync(kFull, e, 0);
  uint32_t last = __shfl_sync(kFull, e, (pl.Wp - 1) & 31);
  return grow_word<kGrow>(pl, lane, e, up, dn, prev, next, first, last) & b;
}

// The warp's row of words (b, s), lane = word, s within b: each run of b
// filled from its lowest bit in s upward.  Every lane calls it; lanes past
// the row hold b = s = 0.
__device__ __forceinline__ uint32_t fill_up(uint32_t b, uint32_t s,
                                            int lane) {
  uint32_t sum = b + s;
  unsigned g = __ballot_sync(kFull, sum < b);          // carry out
  unsigned p = __ballot_sync(kFull, sum == kFull);     // carry through
  // carry into lane k: a generate at some lane j < k and a propagate at
  // every lane between; the carries of the sum g + (g | p), bit by bit
  unsigned cin = (g + (g | p)) ^ p;
  sum += (cin >> lane) & 1u;
  return ((sum ^ b) & b) | s;
}

// The run-OR of a row: each run of b that holds a bit of s, whole.
__device__ __forceinline__ uint32_t row_run_or(const Plane& pl, uint32_t b,
                                               uint32_t s, int lane) {
  uint32_t up = fill_up(b, s, lane);
  int src = (pl.Wp - 1 - lane) & 31;        // the row reversed
  bool in = lane < pl.Wp;
  // every lane shuffles (a lane that skips a full-mask shuffle stalls the
  // warp); lanes past the row then drop what they got
  uint32_t rb = __brev(__shfl_sync(kFull, b, src));
  uint32_t rs = __brev(__shfl_sync(kFull, s, src));
  rb = in ? rb : 0u;
  rs = in ? rs : 0u;
  uint32_t down = __brev(__shfl_sync(kFull, fill_up(rb, rs, lane), src));
  return up | down;
}

// One block per frame: the sweeps to the certificate, then filled u8
// [B, H, W] = 1 - exterior.  Shared memory: exterior and background bits
// [Hg][Wp] each, then the column phase's carries and pass-through words,
// [3][kFillThreads].
template <int kGrow, bool kGuard>
__global__ void __launch_bounds__(kFillThreads, 2)
    k_carry_fill(Plane pl, Segs sg, const uint8_t* mask, uint8_t* filled,
                 bool vec) {
  extern __shared__ uint32_t sm[];
  const int Wp = pl.Wp, nwords = pl.Hg * Wp;
  uint32_t* eb = sm;
  uint32_t* bgb = sm + nwords;
  uint32_t* cdown = sm + 2 * nwords;     // [nseg][Wp] each
  uint32_t* cup = cdown + kFillThreads;
  uint32_t* pass = cup + kFillThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const long long HW = (long long)pl.H * pl.W;
  const uint8_t* m = mask + b * HW;
  const int r = (pl.W - 1) & 31;

  // background bits, and the seeds: background on the frame's border rows
  // and columns; the guard rows background and exterior
  auto seeds = [&](int y, int w, uint32_t bg) {
    bool edge_row = y == pl.G || y == pl.G + pl.H - 1;
    uint32_t cols = (w == 0 ? 1u : 0u) | (w == Wp - 1 ? 1u << r : 0u);
    bgb[y * Wp + w] = bg;
    eb[y * Wp + w] = bg & (edge_row ? kFull : cols);
  };
  for (int i = threadIdx.x; i < 2 * pl.G * Wp; i += kFillThreads) {
    int y = i / Wp, w = i % Wp;
    if (y >= pl.G) y += pl.H;
    bgb[y * Wp + w] = eb[y * Wp + w] = in_row(pl, w);
  }
  if (vec) {                   // 16-byte loads, 32 bytes to a word
    for (int i = threadIdx.x; i < pl.H * Wp; i += kFillThreads) {
      int yf = i / Wp, w = i % Wp;
      const uint4* p = reinterpret_cast<const uint4*>(
          m + (long long)yf * pl.W + 32 * w);
      uint4 lo = p[0];
      uint4 hi = 32 * w + 16 < pl.W ? p[1] : make_uint4(0, 0, 0, 0);
      uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint32_t fg = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k)  // a byte's nonzero flag to bit 4k + j
        fg |= ((__vcmpne4(v[k], 0u) & 0x01010101u) * 0x10204080u) >> 28
              << (4 * k);
      seeds(yf + pl.G, w, ~fg & in_row(pl, w));
    }
  } else {                     // a warp a row: bytes, ballotted
    for (int yf = warp; yf < pl.H; yf += kFillWarps) {
      const uint8_t* row = m + (long long)yf * pl.W;
      for (int w = 0; w < Wp; ++w) {
        int x = 32 * w + lane;
        uint8_t v = row[min(x, pl.W - 1)];
        uint32_t bg = __ballot_sync(kFull, x < pl.W && v == 0);
        if (lane == 0) seeds(yf + pl.G, w, bg);
      }
    }
  }
  __syncthreads();

  // rows the phases update: with guard rows, the frame's (the guard rows
  // stay exterior)
  const int y_lo = pl.G, y_hi = pl.G + pl.H;
  const int cw = threadIdx.x % Wp, seg = threadIdx.x / Wp;
  const bool col_in = seg < sg.nseg;
  const int c0 = seg * sg.len, c1 = min(pl.Hg, c0 + sg.len);
  while (true) {
    // row phase: a warp a row, a lane a word
    for (int y = y_lo + warp; y < y_hi; y += kFillWarps) {
      uint32_t e, bg;
      uint32_t s = row_seeds<kGrow, kGuard>(pl, eb, bgb, y, lane, e, bg);
      uint32_t f = row_run_or(pl, bg, s, lane);
      if (lane < Wp) eb[y * Wp + lane] = f;
    }
    __syncthreads();

    // column phase, 1: each segment's seeds (written into the exterior),
    // its carries out downward and upward with none coming in, and its
    // pass-through (background on every row)
    if (col_in) {
      uint32_t c = 0, through = kFull;
      for (int y = c0; y < c1; ++y) {
        int o = y * Wp + cw;
        uint32_t bg = bgb[o], s = eb[o];
        if (y >= y_lo && y < y_hi) {
          uint32_t up = kGuard || y > 0 ? eb[o - Wp] : 0u;
          uint32_t dn = kGuard || y < pl.Hg - 1 ? eb[o + Wp] : 0u;
          uint32_t prev = 0, next = 0, first = 0, last = 0;
          if (kGrow == kGrowOld) {
            prev = cw > 0 ? eb[o - 1] : 0u;
            next = cw < Wp - 1 ? eb[o + 1] : 0u;
          } else {
            prev = eb[o - (cw > 0)];
            next = eb[o + (cw < Wp - 1)];
            first = eb[y * Wp];
            last = eb[y * Wp + Wp - 1];
          }
          s = grow_word<kGrow>(pl, cw, s, up, dn, prev, next, first, last) &
              bg;
          eb[o] = s;
        }
        c = (c & bg) | s;
        through &= bg;
      }
      uint32_t cu = 0;
      for (int y = c1 - 1; y >= c0; --y) {
        int o = y * Wp + cw;
        cu = (cu & bgb[o]) | eb[o];
      }
      cdown[seg * Wp + cw] = c;
      cup[seg * Wp + cw] = cu;
      pass[seg * Wp + cw] = through;
    }
    __syncthreads();
    // 2: the carries into each segment, chained down (threads 0 .. Wp - 1)
    //    and up (Wp .. 2 Wp - 1) each word column
    if (threadIdx.x < 2 * Wp) {
      int w = threadIdx.x % Wp;
      uint32_t cin = 0;
      if (threadIdx.x < Wp) {
        for (int k = 0; k < sg.nseg; ++k) {
          uint32_t out = cdown[k * Wp + w] | (pass[k * Wp + w] & cin);
          cdown[k * Wp + w] = cin;
          cin = out;
        }
      } else {
        for (int k = sg.nseg - 1; k >= 0; --k) {
          uint32_t out = cup[k * Wp + w] | (pass[k * Wp + w] & cin);
          cup[k * Wp + w] = cin;
          cin = out;
        }
      }
    }
    __syncthreads();
    // 3: each segment filled from its carries in, downward, then upward
    //    over what that filled
    if (col_in) {
      uint32_t c = cdown[seg * Wp + cw];
      for (int y = c0; y < c1; ++y) {
        int o = y * Wp + cw;
        c = (c & bgb[o]) | eb[o];
        eb[o] = c;
      }
      c = cup[seg * Wp + cw];
      for (int y = c1 - 1; y >= c0; --y) {
        int o = y * Wp + cw;
        c = (c & bgb[o]) | eb[o];
        eb[o] = c;
      }
    }
    __syncthreads();

    // the certificate: does one more grow4 add anything?
    int more = 0;
    for (int y = y_lo + warp; y < y_hi; y += kFillWarps) {
      uint32_t e, bg;
      uint32_t s = row_seeds<kGrow, kGuard>(pl, eb, bgb, y, lane, e, bg);
      more |= (s & ~e) != 0;
    }
    if (!__syncthreads_or(more)) break;
  }

  uint8_t* out = filled + b * HW;
  if (vec) {                   // 16-byte stores, a word to 32 bytes
    for (int i = threadIdx.x; i < pl.H * Wp; i += kFillThreads) {
      int yf = i / Wp, w = i % Wp;
      uint32_t f = ~eb[(yf + pl.G) * Wp + w];
      uint32_t v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)  // bit 4k + j to byte j of v[k]
        v[k] = ((f >> (4 * k) & 15u) * 0x00204081u) & 0x01010101u;
      uint4* p = reinterpret_cast<uint4*>(out + (long long)yf * pl.W + 32 * w);
      p[0] = make_uint4(v[0], v[1], v[2], v[3]);
      if (32 * w + 16 < pl.W) p[1] = make_uint4(v[4], v[5], v[6], v[7]);
    }
  } else {
    for (int yf = warp; yf < pl.H; yf += kFillWarps)
      for (int w = 0; w < Wp; ++w) {
        int x = 32 * w + lane;
        if (x < pl.W)
          out[(long long)yf * pl.W + x] =
              !((eb[(yf + pl.G) * Wp + w] >> lane) & 1u);
      }
  }
}

template <int kGrow, bool kGuard>
int launch_carry_fill(const Plane& pl, int B, const uint8_t* mask,
                      uint8_t* filled, cudaStream_t st) {
  auto kernel = k_carry_fill<kGrow, kGuard>;
  size_t smem = carry_smem(pl);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // rows of a multiple of 16 bytes on 16-byte aligned planes
  bool vec = pl.W % 16 == 0 && (uintptr_t)mask % 16 == 0 &&
             (uintptr_t)filled % 16 == 0;
  kernel<<<B, kFillThreads, smem, st>>>(pl, segs_of(pl), mask, filled, vec);
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

// The sweep fill of mask u8 [B, H, W] (1 = foreground): filled u8 [B, H, W]
// (0/1), one launch.  grow: 0 "new", 1 "old"; guard 0 or 1.  W at most
// 1024, and the bit planes (8 (H + 16 guard) ceil(W / 32) bytes) and 6 KB
// of carries must fit one block's shared memory.  Returns the first CUDA
// error.
extern "C" int hd_sweep_fill(const uint8_t* mask, int B, int H, int W,
                             int guard, int grow, uint8_t* filled,
                             void* stream) {
  Plane pl = plane_of(H, W, guard);
  if (H < 1 || W < 1 || pl.W > 1024 || carry_smem(pl) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((grow ? 2 : 0) | (guard ? 1 : 0)) {
    case 0: return launch_carry_fill<kGrowNew, false>(pl, B, mask, filled, st);
    case 1: return launch_carry_fill<kGrowNew, true>(pl, B, mask, filled, st);
    case 2: return launch_carry_fill<kGrowOld, false>(pl, B, mask, filled, st);
    default: return launch_carry_fill<kGrowOld, true>(pl, B, mask, filled, st);
  }
}
