// Preprocess probes for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (heimdall_tpu_torch/ops/_cuda.py, wrapped by
// heimdall_tpu_torch/ops/pre_variants.py).
//
// Replaces the Pallas kernels of two TPU timing probes, each the preprocess
// of the fused detect (gray -> Q8 blur5 -> f32 mean11 with rint -> INV
// threshold -> open, close) with one ingredient swapped:
//   scripts/profile_preprocess.py:100, its "_roll" stages (conv_roll
//     :49-56): the blur5 and mean11 correlations with wrap-around borders,
//     x[(i + j - r) mod n], deliberately wrong near the frame edge (a timing
//     probe); the morphology stays exact;
//   scripts/profile_pre_variants.py:186 (bodies :57-157, variants :159-166):
//     roll_conv (rolled interior, exact border band: here an unchecked read
//     path for pixels at least r from the edge and the exact formula for the
//     rest), pair_sym (paired Q8 taps t2*c + t1*(a+b) + t0*(a'+b'), exact in
//     int), roll_pair (both), mxu_conv (paired blur, then the f32 mean11 as
//     two banded matrix products with the replicate border folded into the
//     edge weights).
// The stage encodings are hd_label's: blur5 u8, mean11 0/255, pre 0/1.
//
// mxu_conv's products run on the tensor cores (mma.sync m16n8k8, TF32 in,
// f32 accumulate), over the band's tiles only: an 11-tap band touches 3 of
// the 8-wide k tiles of a row pass tile and 4 of a column pass tile, where a
// dense product would take W/8 and H/8.  Each f32 operand that is not exact
// in TF32 is split into hi + lo TF32 parts: the row pass (the blurred plane,
// 0-255, is exact) takes 2 products per tile, the column pass 3 (hi*hi,
// hi*lo, lo*hi), which keeps the mean within ~1e-4 of an f32 product.  Its
// rounding is not the sequential tap sum's, so the threshold may flip where
// the mean lies near a half-integer: that count is reported, not asserted.
// Every other variant equals the exact preprocess bit for bit: the f32
// mean's taps are summed in sequence with __fmul_rn/__fadd_rn (and the file
// is built with -fmad=false), and the wrap index only moves where each tap
// reads, never the order of the sum.
//
// What bounds it on an H100 SXM: bytes.  A call reads the frame (3 B/px)
// and writes one plane (1 B/px), 0.37 us per 640x480 frame at 3.35 TB/s;
// mxu_conv's band products are far below the tensor cores' rate.  It passes
// every stage through global-memory scratch (8 launches to "pre", 9 with
// mxu_conv's band table), as the TPU probes' separate passes do, so these
// are probes of the ingredients, not of the bound.

#include "common.cuh"

namespace {

enum Stage { kBlur5 = 1, kMean11 = 2, kPre = 3 };   // hd_label's numbers

// (the passes up to the threshold, with their Border and pair template
// parameters, are in common.cuh)

// ------------------------------------------------ mxu_conv on tensor cores

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

// T[k][c] of the 11-tap correlation with replicate border over an axis of
// n (out[c] = sum_k x[k] T[k][c]): the taps i with clamp(c + i - 5, 0,
// n - 1) == k, summed in tap order in f32, as profile_pre_variants.py:89-96
// builds it; 0 outside the n x n matrix.
__device__ __forceinline__ float band_weight(const Taps& t, int k, int c,
                                             int n) {
  float w = 0.f;
  if (k < 0 || k >= n || c < 0 || c >= n) return w;
  for (int i = 0; i < 11; ++i)
    if (clampi(c + i - 5, 0, n - 1) == k) w = __fadd_rn(w, t.k11[i]);
  return w;
}

// The band of T for the W axis then the H axis, 11 entries per column c:
// band[c * 11 + d] = T[c + d - 5][c] (the rest of T is 0).  Built once per
// call, so the products read each weight with one load.
__global__ void k_band_table(Taps t, int W, int H, float* band) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int n = i < 11 * W ? W : H, j = i < 11 * W ? i : i - 11 * W;
  if (j >= 11 * n) return;
  int c = j / 11;
  band[i] = band_weight(t, c + j % 11 - 5, c, n);
}

// T[k][c] from an axis's band table.
__device__ __forceinline__ float band_at(const float* band, int k, int c,
                                         int n) {
  int d = k - c + 5;
  return c < n && (unsigned)d < 11u ? band[c * 11 + d] : 0.f;
}

// One warp per 16 x 8 tile of out; a block of 8 warps covers 16 rows x 64
// columns of one frame.
constexpr int kMmaWarps = 8;

// Row pass: mh[y][c] = sum_k blurred[y][k] Tw[k][c], over the k tiles of
// the band (columns c0 - 5 .. c0 + 12).
__global__ void k_mma_mean_h(Geom g, const float* band_w,
                             const uint8_t* blurred, float* mh) {
  int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  int y0 = blockIdx.y * 16;
  int c0 = (blockIdx.x * kMmaWarps + (threadIdx.x >> 5)) * 8;
  if (c0 >= g.W) return;              // the whole warp leaves together
  const uint8_t* x = blurred + blockIdx.z * g.HW;
  auto px = [&](int y, int k) -> uint32_t {
    if (y >= g.H || k >= g.W) return 0u;
    return __float_as_uint((float)x[(long long)y * g.W + k]);
  };
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  int kt_end = min(c0 + 12, g.W - 1) >> 3;
  for (int kt = max(c0 - 5, 0) >> 3; kt <= kt_end; ++kt) {
    int k = kt * 8 + tig;
    uint32_t a[4] = {px(y0 + gid, k), px(y0 + gid + 8, k),
                     px(y0 + gid, k + 4), px(y0 + gid + 8, k + 4)};
    uint32_t h0, l0, h1, l1;
    split_tf32(band_at(band_w, k, c0 + gid, g.W), h0, l0);
    split_tf32(band_at(band_w, k + 4, c0 + gid, g.W), h1, l1);
    mma_tf32(d, a, h0, h1);
    mma_tf32(d, a, l0, l1);
  }
  float* out = mh + blockIdx.z * g.HW;
  for (int i = 0; i < 4; ++i) {
    int y = y0 + gid + (i >> 1) * 8, c = c0 + 2 * tig + (i & 1);
    if (y < g.H && c < g.W) out[(long long)y * g.W + c] = d[i];
  }
}

// Column pass: m[r][c] = sum_k Th[k][r] mh[k][c], over the k tiles of the
// band (rows r0 - 5 .. r0 + 20).  With `mean` it writes m (f32); else the
// INV threshold of rint(m) against blurred, `on` for foreground.
__global__ void k_mma_mean_v(Geom g, const float* band_h, int ct,
                             uint8_t on, const float* mh,
                             const uint8_t* blurred, uint8_t* bin,
                             float* mean) {
  int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  int r0 = blockIdx.y * 16;
  int c0 = (blockIdx.x * kMmaWarps + (threadIdx.x >> 5)) * 8;
  if (c0 >= g.W) return;
  const float* m = mh + blockIdx.z * g.HW;
  auto mv = [&](int k, int c) -> float {
    return k < g.H && c < g.W ? m[(long long)k * g.W + c] : 0.f;
  };
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  int kt_end = min(r0 + 20, g.H - 1) >> 3;
  for (int kt = max(r0 - 5, 0) >> 3; kt <= kt_end; ++kt) {
    int k = kt * 8 + tig;
    uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
    split_tf32(band_at(band_h, k, r0 + gid, g.H), ah[0], al[0]);
    split_tf32(band_at(band_h, k, r0 + gid + 8, g.H), ah[1], al[1]);
    split_tf32(band_at(band_h, k + 4, r0 + gid, g.H), ah[2], al[2]);
    split_tf32(band_at(band_h, k + 4, r0 + gid + 8, g.H), ah[3], al[3]);
    split_tf32(mv(k, c0 + gid), bh0, bl0);
    split_tf32(mv(k + 4, c0 + gid), bh1, bl1);
    mma_tf32(d, ah, bh0, bh1);
    mma_tf32(d, ah, bl0, bl1);
    mma_tf32(d, al, bh0, bh1);
  }
  long long base = blockIdx.z * g.HW;
  for (int i = 0; i < 4; ++i) {
    int r = r0 + gid + (i >> 1) * 8, c = c0 + 2 * tig + (i & 1);
    if (r >= g.H || c >= g.W) continue;
    long long o = base + (long long)r * g.W + c;
    if (mean)
      mean[o] = d[i];
    else
      bin[o] = (int)blurred[o] <= __float2int_rn(d[i]) - ct ? on : 0;
  }
}

// mxu_conv's mean: the band tables into band (float32 [11 * (W + H)]), the
// row pass into mh, then the column pass: the mean into `mean` if given,
// else the threshold into bin.
int launch_mxu_mean(const Geom& g, int B, const Taps& t, int ct, uint8_t on,
                    const uint8_t* blurred, float* band, float* mh,
                    uint8_t* bin, float* mean, cudaStream_t st) {
  int n = 11 * (g.W + g.H);
  k_band_table<<<(n + 255) / 256, 256, 0, st>>>(t, g.W, g.H, band);
  HD_CHECK();
  dim3 grid((g.W + 8 * kMmaWarps - 1) / (8 * kMmaWarps), (g.H + 15) / 16, B);
  k_mma_mean_h<<<grid, 32 * kMmaWarps, 0, st>>>(g, band, blurred, mh);
  HD_CHECK();
  k_mma_mean_v<<<grid, 32 * kMmaWarps, 0, st>>>(g, band + 11 * g.W, ct, on,
                                                mh, blurred, bin, mean);
  HD_CHECK();
  return 0;
}

// ------------------------------------------------------------ launches

template <int kBorder, bool kPair>
int launch_blur(const Frames& f, const Geom& g, dim3 grid, const Taps& t,
                int32_t* acc, uint8_t* blurred, cudaStream_t st) {
  dim3 blk(kTileW, kTileH);
  k_gray_blur_h<kBorder, kPair><<<grid, blk, 0, st>>>(f, g, t, acc);
  HD_CHECK();
  k_blur_v<kBorder, kPair><<<grid, blk, 0, st>>>(g, t, acc, blurred);
  HD_CHECK();
  return 0;
}

template <int kBorder>
int launch_mean(const Geom& g, dim3 grid, const Taps& t, int ct, uint8_t on,
                const uint8_t* blurred, float* mh, uint8_t* bin,
                cudaStream_t st) {
  dim3 blk(kTileW, kTileH);
  k_mean_h<kBorder><<<grid, blk, 0, st>>>(g, t, blurred, mh);
  HD_CHECK();
  k_mean_v_threshold<kBorder><<<grid, blk, 0, st>>>(g, t, ct, on, mh,
                                                    blurred, bin);
  HD_CHECK();
  return 0;
}


}  // namespace

// Frames [B, 3, H, W] -> the plane of `stage` (1 blur5: plane1, u8; 2
// mean11: plane2, 0/255; 3 pre: plane2, opened and closed, 0/1) with the
// ingredients `border` (0 exact, 1 wrap-around, 2 unchecked interior with
// an exact border band), `pair` (paired blur taps) and `mma` (the mean as
// banded tensor-core products).  Scratch: work int32 [B, H, W] (also used
// as float32), band float32 [11 * (W + H)] (mma only).  H, W >= 6 (the
// mean's wrap reads one turn at most).  Returns the first CUDA error.
extern "C" int hd_pre_variant(const uint8_t* frames, int B, int H, int W,
                              int ct, int stage, int border, int pair,
                              int mma, const int* q8, const float* k11,
                              uint8_t* plane1, uint8_t* plane2, int32_t* work,
                              float* band, void* stream) {
  if (stage < kBlur5 || stage > kPre || border < kExact || border > kSplit ||
      H < 6 || W < 6)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Geom g{H, W, (long long)H * W, H, 1};
  Frames f{frames, 3, 3 * g.HW, g.HW, 1};
  Taps t = taps_of(q8, k11);
  dim3 blk(kTileW, kTileH);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  float* fwork = reinterpret_cast<float*>(work);
  int err;
  if (border == kWrap)
    err = pair ? launch_blur<kWrap, true>(f, g, grid, t, work, plane1, st)
               : launch_blur<kWrap, false>(f, g, grid, t, work, plane1, st);
  else if (border == kSplit)
    err = pair ? launch_blur<kSplit, true>(f, g, grid, t, work, plane1, st)
               : launch_blur<kSplit, false>(f, g, grid, t, work, plane1, st);
  else
    err = pair ? launch_blur<kExact, true>(f, g, grid, t, work, plane1, st)
               : launch_blur<kExact, false>(f, g, grid, t, work, plane1, st);
  if (err || stage == kBlur5) return err;
  uint8_t on = stage == kMean11 ? 255 : 1;
  if (mma) {
    err = launch_mxu_mean(g, B, t, ct, on, plane1, band, fwork, plane2,
                          nullptr, st);
  } else if (border == kWrap) {
    err = launch_mean<kWrap>(g, grid, t, ct, on, plane1, fwork, plane2, st);
  } else if (border == kSplit) {
    err = launch_mean<kSplit>(g, grid, t, ct, on, plane1, fwork, plane2, st);
  } else {
    err = launch_mean<kExact>(g, grid, t, ct, on, plane1, fwork, plane2, st);
  }
  if (err || stage == kMean11) return err;
  k_morph<<<grid, blk, 0, st>>>(g, plane2, plane1, 1);   // open: erode
  HD_CHECK();
  k_morph<<<grid, blk, 0, st>>>(g, plane1, plane2, 0);   //       dilate
  HD_CHECK();
  k_morph<<<grid, blk, 0, st>>>(g, plane2, plane1, 0);   // close: dilate
  HD_CHECK();
  k_morph<<<grid, blk, 0, st>>>(g, plane1, plane2, 1);   //        erode
  HD_CHECK();
  return 0;
}

// mxu_conv's f32 mean11 alone: blurred u8 [B, H, W] -> mean float32
// [B, H, W], the two banded tensor-core products (no rounding, no
// threshold).  Scratch: work float32 [B, H, W], band float32
// [11 * (W + H)].  Returns the first CUDA error.
extern "C" int hd_mxu_mean(const uint8_t* blurred, int B, int H, int W,
                           const float* k11, float* band, float* work,
                           float* mean, void* stream) {
  Geom g{H, W, (long long)H * W, H, 1};
  int q8[5] = {0, 0, 0, 0, 0};
  return launch_mxu_mean(g, B, taps_of(q8, k11), 0, 0, blurred, band, work,
                         nullptr, mean, (cudaStream_t)stream);
}
