// The one-pass tile preprocess, shared by fused_detect.cu (hd_preprocess,
// the fused detect B1, the label kernel's stages) and pre_variants.cu (the
// preprocess probes S2-roll and S3): gray -> Q8 blur5 (reflect-101) -> f32
// mean11 with rint (replicate) -> INV threshold -> open, close (3x3, cv2
// borders), per frame, with the probes' ingredients as template
// parameters that the main path's instances leave at their defaults.
//
// One launch, one block per output tile of kPreTY x kPreTX pixels of a
// frame.  The block loads the tile with an 11-pixel halo (2 for the blur,
// 5 for the mean, 1 for each of the four 3x3 passes), clipped to the
// frame, into shared memory once, computing gray as it loads; every stage
// then computes exactly the region its successor reads, shrinking by its
// reach, and only the frame read and the gray and binary writes touch
// device memory.  Borders are taken in frame coordinates (reflect-101 for
// the blur, replicate for the mean) and mapped into the tile's buffers: a
// reflected or clamped index moves at most 2 or 5 pixels inward, which the
// halo holds, so a stage only ever computes in-frame positions; a tile
// whose halo lies inside the frame (most of them) takes a copy of the code
// with no border arithmetic and no frame checks (kI), and, for planar
// frames with word-aligned rows, 32-bit loads and stores.  The horizontal
// passes give each thread a row and a run of kRun outputs whose taps stay
// in registers (one shared load per output and a few more per run); the
// vertical passes a column and a run of rows the same way.  The block
// takes 384 threads, four blocks an SM: the stencil phases are bound by
// instruction issue and shared-memory latency, and the tile's load is not
// overlapped with its compute.  The blur sums exact integers; the mean
// keeps its strict tap order (row pass, then column pass over the
// unrounded row sums, __fmul_rn/__fadd_rn, rounded half to even).  The
// threshold is ballotted into words of 32 pixels, and the open and close
// run on those words (erode = AND of the shifted words, dilate = OR), with
// positions outside the frame holding each pass's neutral value, so no
// out-of-frame neighbour wins.
//
// The instances: kStop, the last stage (kBlur5, kMean11 or kPre), whose
// plane goes out from shared memory (the Q8 blur u8, the threshold 0/255
// or the closed mask 0/1); kGrayOut, the tile's gray goes out too (the
// main path's <kPre, true>); and the probes' ingredients, each exact:
//   kWrap  the blur5 and mean11 correlations with wrap-around borders,
//          x[(i + j - r) mod n] (S2-roll): a border tile loads its halo at
//          the wrapped frame positions (a true modulo: at 6 x 6 the halo
//          wraps more than once), so every stencil stage reads its halo
//          as an interior tile does; the threshold's bits and the
//          morphology still take the frame's own border, each pass's
//          neutral value outside it;
//   kPair  the Q8 blur's paired taps t2*c + t1*(a+b) + t0*(a'+b') in both
//          passes (exact in int: the same plane);
//   kMma   the f32 mean11 as banded products on the tensor cores (below),
//          over the tile's planes C (blurred) and D (the row sums).

#pragma once

#include "common.cuh"

namespace {

// The stages of hd_label, in order: it stops after `stage`.
enum Stage { kGray = 0, kBlur5, kMean11, kPre, kFill, kCcl, kNumStages };

constexpr int kPreTY = 64, kPreTX = 120, kPreThreads = 384, kRun = 8;
// the threshold's run: its kRE / kRunV x kNW tasks split evenly over the
// block's warps
constexpr int kRunV = 9;
// Regions, as (rows, columns) and their origin relative to the tile's:
constexpr int kRA = kPreTY + 22, kCA = kPreTX + 22;  // gray        (-11, -11)
constexpr int kCB = kPreTX + 18;                     // blur rows   (-11, -9)
constexpr int kRC = kPreTY + 18;                     // blurred     (-9, -9)
constexpr int kCD = kPreTX + 8, kSD = kCD + 1;       // mean rows   (-9, -4)
constexpr int kRE = kPreTY + 8;                      // binary bits (-4, -4)
constexpr int kNW = (kCD + 31) / 32;                 // words per bit row
constexpr int kOffB = kRA * kCA;                     // u16 blur rows after gray
constexpr int kOffC = (kOffB + kRA * kCB * 2 > kRC * kSD * 4)
                          ? kOffB + kRA * kCB * 2 : kRC * kSD * 4;
constexpr int kOffE = kOffC + kRC * kCB;
constexpr int kPreSmem = kOffE + 2 * kRE * kNW * 4;
static_assert(kOffB % 2 == 0 && kOffC % 4 == 0 && kOffE % 4 == 0,
              "shared buffers misaligned");

__device__ __forceinline__ bool inside(int i, int n) {
  return i >= 0 && i < n;
}

// inside(i, n), known true in a tile whose halo lies inside the frame
template <bool kI>
__device__ __forceinline__ bool in_frame(int i, int n) {
  return kI || inside(i, n);
}

// (i mod n) for any i: the wrap-around read of a roll.
__device__ __forceinline__ int wrap_mod(int i, int n) {
  int m = i % n;
  return m < 0 ? m + n : m;
}

// ------------------------------------------ the mean on the tensor cores
//
// mxu_conv's f32 mean11 as two banded matrix products (mma.sync m16n8k8,
// TF32 in, f32 accumulate) over the tile's shared-memory planes, the
// replicate border folded into the edge weights by a band table that
// pre_variants.cu's k_band_table writes once a call: band[c * 11 + d] =
// T[c + d - 5][c] of the W axis, then of the H axis at band + 11 * W.
// Every f32 operand that is not exact in TF32 goes in as hi + lo TF32
// parts: the row pass (the blurred plane, 0-255, is exact) takes 2
// products a k tile, the column pass 3 (hi*hi, hi*lo, lo*hi), which keeps
// the mean within ~1e-4 of an f32 product.  Its rounding is not the
// sequential tap sum's, so the threshold may flip where the mean lies near
// a half-integer.

// x rounded to TF32 (nearest, ties away), as the .b32 operand of mma.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (a residual below 2^-22 |x|), both parts TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b over one 16 x 8 x 8 tile.  Fragments (g = lane / 4,
// t = lane % 4): a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (row t, col g), b1 (t + 4, g); d0 (g, 2t),
// d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// T[k][c] of an axis of n from its band table: 0 where c leaves the axis
// or k the band (the table holds 0 where k leaves the axis).
__device__ __forceinline__ float band_at(const float* band, int k, int c,
                                         int n) {
  int d = k - c + 5;
  return (unsigned)c < (unsigned)n && (unsigned)d < 11u ? band[c * 11 + d]
                                                        : 0.f;
}

// In an interior tile every output of both passes lies at least 5 from the
// frame's edge, so its weights are the taps themselves: T[k][c] = k11[d],
// d = k - c + 5 in [0, 10], and a lane's d in a k tile is 8 kt + t - g
// (+- 4, - 8), the same for every task.  Their TF32 parts for d in
// [-kTapLo, kTapSpan - kTapLo) sit in a table in the second bit plane (E),
// written with the tile's load and unused until the open.
constexpr int kTapLo = 16, kTapSpan = 48;

__device__ __forceinline__ void tap_parts(const Taps& t, uint32_t* tab) {
  for (int i = threadIdx.x; i < kTapSpan; i += kPreThreads) {
    int d = i - kTapLo;
    split_tf32((unsigned)d < 11u ? t.k11[d] : 0.f, tab[i], tab[kTapSpan + i]);
  }
}

// The row pass of a tile: D[r][c] = sum_k C[r][k] Tw[k][c] over region D,
// a warp per 16 x 8 tile of D; its band reaches C's columns c0 .. c0 + 17,
// three k tiles.  C reads 0 outside the frame (a border tile does not write
// those positions), so D is finite everywhere.  kI: the weights from the
// taps' table.
template <bool kI>
__device__ __forceinline__ void mma_mean_rows(const uint8_t* C, float* D,
                                              const float* band_w,
                                              const uint32_t* tab, int x0,
                                              int W, int y0, int H) {
  constexpr int kRowTiles = (kRC + 15) / 16, kColTiles = kCD / 8;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  auto at = [&](int r, int k) -> uint32_t {
    bool ok = r < kRC && k < kCB && in_frame<kI>(y0 - 9 + r, H) &&
              in_frame<kI>(x0 - 9 + k, W);
    return __float_as_uint(ok ? (float)C[r * kCB + k] : 0.f);
  };
  for (int task = threadIdx.x >> 5; task < kRowTiles * kColTiles;
       task += kPreThreads / 32) {
    int r0 = task / kColTiles * 16, c0 = task % kColTiles * 8;
    int cx = x0 - 4 + c0 + gid;            // this lane's column of Tw
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) {
      int k = c0 + 8 * kt + tig;
      uint32_t a[4] = {at(r0 + gid, k), at(r0 + gid + 8, k),
                       at(r0 + gid, k + 4), at(r0 + gid + 8, k + 4)};
      uint32_t h0, l0, h1, l1;
      if (kI) {
        int i = kTapLo + 8 * kt + tig - gid;
        h0 = tab[i];
        l0 = tab[kTapSpan + i];
        h1 = tab[i + 4];
        l1 = tab[kTapSpan + i + 4];
      } else {
        split_tf32(band_at(band_w, x0 - 9 + k, cx, W), h0, l0);
        split_tf32(band_at(band_w, x0 - 5 + k, cx, W), h1, l1);
      }
      mma_tf32(d, a, h0, h1);
      mma_tf32(d, a, l0, l1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = r0 + gid + (i >> 1) * 8, c = c0 + 2 * tig + (i & 1);
      if (r < kRC) D[r * kSD + c] = d[i];
    }
  }
}

// The column pass and the INV threshold: mean[r][c] = sum_k Th[k][r]
// D[k][c] over region E, a warp per 16 x 8 tile, its band D's rows r0 ..
// r0 + 25 (four k tiles); each bit ORed into E's zeroed words, 1 outside
// the frame (the erode's neutral value).  kI: the weights from the taps'
// table.
template <bool kI>
__device__ __forceinline__ void mma_mean_cols_threshold(
    const uint8_t* C, const float* D, uint32_t* E, const float* band_h,
    const uint32_t* tab, int x0, int W, int y0, int H, int ct) {
  constexpr int kRowTiles = (kRE + 15) / 16, kColTiles = kCD / 8;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  for (int task = threadIdx.x >> 5; task < kRowTiles * kColTiles;
       task += kPreThreads / 32) {
    int r0 = task / kColTiles * 16, c0 = task % kColTiles * 8;
    int ya = y0 - 4 + r0 + gid, yb = ya + 8;   // this lane's rows of Th^T
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      int k = r0 + 8 * kt + tig, ky = y0 - 9 + k;
      uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
      if (kI) {
        int i = kTapLo + 8 * kt + tig - gid;
#pragma unroll
        for (int j = 0; j < 4; ++j) {    // a0 .. a3: d, d - 8, d + 4, d - 4
          int o = i + (j & 1 ? -8 : 0) + (j & 2 ? 4 : 0);
          ah[j] = tab[o];
          al[j] = tab[kTapSpan + o];
        }
      } else {
        split_tf32(band_at(band_h, ky, ya, H), ah[0], al[0]);
        split_tf32(band_at(band_h, ky, yb, H), ah[1], al[1]);
        split_tf32(band_at(band_h, ky + 4, ya, H), ah[2], al[2]);
        split_tf32(band_at(band_h, ky + 4, yb, H), ah[3], al[3]);
      }
      split_tf32(k < kRC ? D[k * kSD + c0 + gid] : 0.f, bh0, bl0);
      split_tf32(k + 4 < kRC ? D[(k + 4) * kSD + c0 + gid] : 0.f, bh1, bl1);
      mma_tf32(d, ah, bh0, bh1);
      mma_tf32(d, ah, bl0, bl1);
      mma_tf32(d, al, bh0, bh1);
    }
    uint32_t bits[2] = {0u, 0u};   // rows r0 + gid and r0 + gid + 8
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = r0 + gid + (i >> 1) * 8, c = c0 + 2 * tig + (i & 1);
      bool bit = true;
      if (r < kRE && in_frame<kI>(y0 - 4 + r, H) &&
          in_frame<kI>(x0 - 4 + c, W))
        bit = (int)C[(r + 5) * kCB + c + 5] <= __float2int_rn(d[i]) - ct;
      bits[i >> 1] |= (uint32_t)bit << (2 * tig + (i & 1));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {       // the quad's 8 columns of the row
      bits[h] |= __shfl_xor_sync(kFull, bits[h], 1);
      bits[h] |= __shfl_xor_sync(kFull, bits[h], 2);
      int r = r0 + gid + 8 * h;
      if (tig == 0 && r < kRE)
        atomicOr(&E[r * kNW + c0 / 32], bits[h] << (c0 % 32));
    }
  }
}

// One tile of the preprocess.  kI: the tile and its halo lie inside the
// frame, so no tap needs a border and no position a frame check.  kStop:
// the last stage (kBlur5, kMean11 or kPre), whose plane goes to `binary`;
// kGrayOut: the tile's gray goes to gray_out; kWrap, kPair, kMma: the
// probes' ingredients (above); band: kMma's band tables.
template <bool kI, int kStop, bool kGrayOut, bool kWrap = false,
          bool kPair = false, bool kMma = false>
__device__ __forceinline__ void preprocess_tile(const Frames& f, int H, int W,
                                                const Taps& t, int ct,
                                                uint8_t* gray_out,
                                                uint8_t* binary,
                                                uint8_t* smem, bool vec,
                                                const float* band = nullptr) {
  static_assert(!(kWrap && (kGrayOut || kMma)), "no such instance");
  // the stencils need no border: the tile is interior, or its halo holds
  // the wrapped frame
  constexpr bool kS = kI || kWrap;
  uint8_t* A = smem;                                       // gray
  uint16_t* Bh = reinterpret_cast<uint16_t*>(smem + kOffB);  // blur rows
  float* D = reinterpret_cast<float*>(smem);          // mean rows, over A, B
  uint8_t* C = smem + kOffC;                               // blurred
  uint32_t* E = reinterpret_cast<uint32_t*>(smem + kOffE); // 2 bit planes
  const int b = blockIdx.z, y0 = blockIdx.y * kPreTY, x0 = blockIdx.x * kPreTX;
  const int ty = min(kPreTY, H - y0), tx = min(kPreTX, W - x0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = kPreThreads / 32;
  const long long HW = (long long)H * W, obase = b * HW;

  // 1. gray of the tile and its halo; the tile's own gray goes out.  A
  //    warp takes two rows at a time, all their loads in flight at once:
  //    aligned 32-bit words of each plane where the tile is interior and
  //    the planes' rows are word-aligned (vec), else bytes.  (kMma in an
  //    interior tile: the taps' TF32 parts too.)
  if constexpr (kMma) {
    if (kI) tap_parts(t, E + kRE * kNW);
  }
  if (kI && vec) {
    constexpr int kWords = (kCA + 1 + 3) / 4;   // columns -12 .. kCA - 11
    constexpr int kPer = (kWords + 31) / 32, kRowsAtOnce = 2;
    for (int r0 = warp * kRowsAtOnce; r0 < kRA; r0 += warps * kRowsAtOnce) {
      uint32_t v[kRowsAtOnce][kPer][3];
#pragma unroll
      for (int rr = 0; rr < kRowsAtOnce; ++rr) {
        int r = r0 + rr;
        const uint8_t* row = f.data + b * f.fstride +
                             (long long)(y0 - 11 + r) * W + x0 - 12;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          int w = lane + 32 * k;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            v[rr][k][ch] = 0;
            if (r < kRA && w < kWords && (ch == 0 || f.C == 3))
              v[rr][k][ch] = *reinterpret_cast<const uint32_t*>(
                  row + ch * f.cstride + 4 * w);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowsAtOnce; ++rr) {
        int r = r0 + rr;
        if (r >= kRA) break;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          int w = lane + 32 * k;
          if (w >= kWords) continue;
          uint32_t g4 = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int c = 4 * w + j - 1;
            int bb = v[rr][k][0] >> (8 * j) & 255;
            int g = f.C == 3 ? (bb * 3735 + (v[rr][k][1] >> (8 * j) & 255) *
                                19235 + (v[rr][k][2] >> (8 * j) & 255) * 9798 +
                                (1 << 14)) >> 15
                             : bb;
            g4 |= (uint32_t)g << (8 * j);
            if (c >= 0 && c < kCA) A[r * kCA + c] = (uint8_t)g;
          }
          // words 3 .. 3 + kPreTX / 4 hold the tile's own columns
          if (kGrayOut && inside(r - 11, kPreTY) && inside(w - 3, kPreTX / 4))
            *reinterpret_cast<uint32_t*>(
                gray_out + obase + (long long)(y0 - 11 + r) * W + x0 +
                4 * (w - 3)) = g4;
        }
      }
    }
  } else {
    constexpr int kPer = (kCA + 31) / 32, kRowsAtOnce = 2;
    for (int r0 = warp * kRowsAtOnce; r0 < kRA; r0 += warps * kRowsAtOnce) {
      int v[kRowsAtOnce][kPer];
#pragma unroll
      for (int rr = 0; rr < kRowsAtOnce; ++rr) {
        int r = r0 + rr, gy = y0 - 11 + r;
        if (kWrap && !kI) gy = wrap_mod(gy, H);
        bool row_in = r < kRA && in_frame<kS>(gy, H);
        const uint8_t* row =
            f.data + b * f.fstride + (long long)gy * W * f.pstride;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          int c = lane + 32 * k, gx = x0 - 11 + c;
          if (kWrap && !kI) gx = wrap_mod(gx, W);
          v[rr][k] = 0;
          if (!row_in || c >= kCA || !in_frame<kS>(gx, W)) continue;
          const uint8_t* d = row + (long long)gx * f.pstride;
          v[rr][k] = f.C == 3 ? (d[0] * 3735 + d[f.cstride] * 19235 +
                                 d[2 * f.cstride] * 9798 + (1 << 14)) >> 15
                              : d[0];
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRowsAtOnce; ++rr) {
        int r = r0 + rr, gy = y0 - 11 + r;
        if (r >= kRA || !in_frame<kS>(gy, H)) continue;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          int c = lane + 32 * k, gx = x0 - 11 + c;
          if (c >= kCA || !in_frame<kS>(gx, W)) continue;
          A[r * kCA + c] = (uint8_t)v[rr][k];
          if (kGrayOut && inside(r - 11, ty) && inside(c - 11, tx))
            gray_out[obase + (long long)gy * W + gx] = v[rr][k];
        }
      }
    }
  }
  __syncthreads();

  // 2. the blur's row pass (a thread takes a row and a run of kRun
  //    columns; neighbouring threads neighbouring rows).
  {
    constexpr int runs = (kCB + kRun - 1) / kRun;
    for (int it = threadIdx.x; it < kRA * runs; it += kPreThreads) {
      int r = it % kRA, c0 = it / kRA * kRun;
      int gy = y0 - 11 + r, gx0 = x0 - 9 + c0;
      if (!in_frame<kS>(gy, H)) continue;
      int v[kRun + 4];
#pragma unroll
      for (int k = 0; k < kRun + 4; ++k) {
        int src = (kS ? gx0 + k - 2 : reflect101(gx0 + k - 2, W)) - (x0 - 11);
        v[k] = inside(src, kCA) ? A[r * kCA + src] : 0;
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        int c = c0 + j;
        if (c >= kCB || !in_frame<kS>(gx0 + j, W)) continue;
        int s = 0;
        if constexpr (kPair) {
          s = t.q8[2] * v[j + 2] + t.q8[1] * (v[j + 1] + v[j + 3]) +
              t.q8[0] * (v[j] + v[j + 4]);
        } else {
#pragma unroll
          for (int i = 0; i < 5; ++i) s += t.q8[i] * v[j + i];
        }
        Bh[r * kCB + c] = (uint16_t)s;
      }
    }
  }
  __syncthreads();

  // 3. the blur's column pass (a thread takes a column and a run of kRun
  //    rows; neighbouring threads neighbouring columns).
  {
    constexpr int runs = (kRC + kRun - 1) / kRun;
    for (int it = threadIdx.x; it < kCB * runs; it += kPreThreads) {
      int c = it % kCB, r0 = it / kCB * kRun;
      int gx = x0 - 9 + c, gy0 = y0 - 9 + r0;
      if (!in_frame<kS>(gx, W)) continue;
      int v[kRun + 4];
#pragma unroll
      for (int k = 0; k < kRun + 4; ++k) {
        int src = (kS ? gy0 + k - 2 : reflect101(gy0 + k - 2, H)) - (y0 - 11);
        v[k] = inside(src, kRA) ? Bh[src * kCB + c] : 0;
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        int r = r0 + j;
        if (r >= kRC || !in_frame<kS>(gy0 + j, H)) continue;
        int s = 0;
        if constexpr (kPair) {
          s = t.q8[2] * v[j + 2] + t.q8[1] * (v[j + 1] + v[j + 3]) +
              t.q8[0] * (v[j] + v[j + 4]);
        } else {
#pragma unroll
          for (int i = 0; i < 5; ++i) s += t.q8[i] * v[j + i];
        }
        C[r * kCB + c] = (uint8_t)clampi((s + (1 << 15)) >> 16, 0, 255);
      }
    }
  }
  __syncthreads();
  if (kStop == kBlur5) {        // the tile's blurred plane goes out
    for (int r = warp; r < ty; r += warps)
      for (int c = lane; c < tx; c += 32)
        binary[obase + (long long)(y0 + r) * W + x0 + c] =
            C[(r + 9) * kCB + c + 9];
    return;
  }

  // 4. the mean's row pass (as the blur's), over the gray and blur-row
  //    buffers, which are no longer read; kMma: as banded products on the
  //    tensor cores.
  if constexpr (kMma) {
    mma_mean_rows<kI>(C, D, band, E + kRE * kNW, x0, W, y0, H);
    // the threshold's bits are ORed into zeroed words
    for (int k = threadIdx.x; k < kRE * kNW; k += kPreThreads) E[k] = 0u;
  } else {
    constexpr int runs = (kCD + kRun - 1) / kRun;
    for (int it = threadIdx.x; it < kRC * runs; it += kPreThreads) {
      int r = it % kRC, c0 = it / kRC * kRun;
      int gy = y0 - 9 + r, gx0 = x0 - 4 + c0;
      if (!in_frame<kS>(gy, H)) continue;
      float v[kRun + 10];
#pragma unroll
      for (int k = 0; k < kRun + 10; ++k) {
        int src = (kS ? gx0 + k - 5 : clampi(gx0 + k - 5, 0, W - 1)) - (x0 - 9);
        v[k] = inside(src, kCB) ? (float)C[r * kCB + src] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        int c = c0 + j;
        if (c >= kCD || !in_frame<kS>(gx0 + j, W)) continue;
        float s = __fmul_rn(t.k11[0], v[j]);
#pragma unroll
        for (int i = 1; i < 11; ++i)
          s = __fadd_rn(s, __fmul_rn(t.k11[i], v[j + i]));
        D[r * kSD + c] = s;
      }
    }
  }
  __syncthreads();

  // 5. the mean's column pass and the INV threshold (lane = column, a run
  //    of kRun rows), ballotted into bit words; outside the frame a bit is 1,
  //    the erode's neutral value (also with kWrap, whose halo holds the
  //    wrapped frame for the stencils only).  kMma: banded products.
  if constexpr (kMma) {
    mma_mean_cols_threshold<kI>(C, D, E, band + 11 * W, E + kRE * kNW, x0,
                                W, y0, H, ct);
  } else {
    constexpr int runs = (kRE + kRunV - 1) / kRunV;
    for (int task = warp; task < runs * kNW; task += warps) {
      int g = task / runs, r0 = task % runs * kRunV, c = g * 32 + lane;
      int gx = x0 - 4 + c, gy0 = y0 - 4 + r0;
      bool col = c < kCD && in_frame<kI>(gx, W);
      float v[kRunV + 10];
#pragma unroll
      for (int k = 0; k < kRunV + 10; ++k) {
        int src = (kS ? gy0 + k - 5 : clampi(gy0 + k - 5, 0, H - 1)) - (y0 - 9);
        v[k] = col && inside(src, kRC) ? D[src * kSD + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRunV; ++j) {
        int r = r0 + j;
        if (r >= kRE) break;                 // uniform over the warp
        bool bit = true;
        if (col && in_frame<kI>(gy0 + j, H)) {
          float s = __fmul_rn(t.k11[0], v[j]);
#pragma unroll
          for (int i = 1; i < 11; ++i)
            s = __fadd_rn(s, __fmul_rn(t.k11[i], v[j + i]));
          bit = (int)C[(r + 5) * kCB + c + 5] <= __float2int_rn(s) - ct;
        }
        unsigned word = __ballot_sync(kFull, bit);
        if (lane == 0) E[r * kNW + g] = word;
      }
    }
  }
  __syncthreads();

  // 6. open (erode, dilate) and close (dilate, erode) on the bit words; after
  //    each pass the positions outside the frame take the next pass's
  //    neutral value (1 before an erode, 0 before a dilate).
#pragma unroll
  for (int pass = 0; pass < (kStop == kPre ? 4 : 0); ++pass) {
    const bool erode = pass == 0 || pass == 3;
    const uint32_t fill = erode ? kFull : 0u;
    const uint32_t next_neutral = pass == 2 ? kFull : 0u;
    const uint32_t* in = E + (pass & 1) * kRE * kNW;
    uint32_t* out = E + ((pass + 1) & 1) * kRE * kNW;
    for (int k = threadIdx.x; k < kRE * kNW; k += kPreThreads) {
      int r = k / kNW, w = k % kNW;
      uint32_t acc = fill;
      for (int dy = -1; dy <= 1; ++dy) {
        int rr = r + dy;
        uint32_t x = fill, prev = fill, next = fill;
        if (inside(rr, kRE)) {
          x = in[rr * kNW + w];
          if (w > 0) prev = in[rr * kNW + w - 1];
          if (w < kNW - 1) next = in[rr * kNW + w + 1];
        }
        uint32_t left = (x << 1) | (prev >> 31);
        uint32_t right = (x >> 1) | (next << 31);
        uint32_t h = erode ? (x & left & right) : (x | left | right);
        acc = erode ? (acc & h) : (acc | h);
      }
      // in-frame columns of this word, and whether its row is in the frame
      int gx = x0 - 4 + w * 32, gy = y0 - 4 + r;
      uint32_t cols = 0;
      if (in_frame<kI>(gy, H)) {
        int lo = max(0, -gx), hi = min(32, min(W - gx, kCD - w * 32));
        if (hi > lo)
          cols = (hi - lo == 32 ? kFull : ((1u << (hi - lo)) - 1u)) << lo;
      }
      out[k] = (acc & cols) | (next_neutral & ~cols);
    }
    __syncthreads();
  }

  // 7. the tile's binary plane goes out (the closed mask 0/1, or stopped
  //    at the threshold 0/255), four pixels a store where the tile is
  //    interior and the rows word-aligned.
  constexpr uint32_t on = kStop == kMean11 ? 255u : 1u;
  if (kI && vec) {
    for (int it = threadIdx.x; it < kPreTY * (kPreTX / 4); it += kPreThreads) {
      int r = it / (kPreTX / 4), c = it % (kPreTX / 4) * 4, cc = c + 4;
      uint32_t x = E[(r + 4) * kNW + cc / 32] >> (cc % 32) & 15u;  // 4 | cc
      *reinterpret_cast<uint32_t*>(binary + obase + (long long)(y0 + r) * W +
                                   x0 + c) =
          ((x & 1u) | (x & 2u) << 7 | (x & 4u) << 14 | (x & 8u) << 21) * on;
    }
    return;
  }
  for (int r = warp; r < ty; r += warps)
    for (int c = lane; c < tx; c += 32) {
      int cc = c + 4;
      uint32_t word = E[(r + 4) * kNW + cc / 32];
      binary[obase + (long long)(y0 + r) * W + x0 + c] =
          ((word >> (cc % 32)) & 1u) * on;
    }
}

}  // namespace
