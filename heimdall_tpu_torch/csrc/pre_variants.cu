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
//     roll_conv (rolled interior, exact border band), pair_sym (paired Q8
//     taps t2*c + t1*(a+b) + t0*(a'+b'), exact in int), roll_pair (both),
//     mxu_conv (paired blur, then the f32 mean11 as two banded matrix
//     products with the replicate border folded into the edge weights).
// The stage encodings are hd_label's: blur5 u8, mean11 0/255, pre 0/1.
//
// Design: every roll stage and variant is one launch of the one-pass tile
// preprocess (preprocess_tile.cuh, the kernel of hd_preprocess and of
// hd_label's stages), an instance with the probe's ingredient as a template
// parameter; mxu_conv adds one launch before it for its band tables.  The
// stages never leave shared memory; device memory sees the frame in and the
// plane out.
//   wrap       <kWrap>: a border tile loads its halo at the wrapped frame
//              positions (a true modulo), so its stencils run as an interior
//              tile's; the threshold's bits and the open and close keep the
//              frame's own border;
//   split      roll_conv and roll_pair: a rolled interior with an exact
//              border band is the exact preprocess, and the tile design
//              already runs its interior tiles with no border arithmetic
//              (kI) and its border tiles exactly, so these are the same
//              instances as cur and pair_sym, with launch counts of their
//              own;
//   pair       <kPair>: the paired taps in both blur passes;
//   mma        <kMma>: the mean's row pass over the tile's blurred plane and
//              its column pass over the row sums as mma.sync m16n8k8 TF32
//              products (preprocess_tile.cuh), the threshold's bits ORed
//              into the tile's words.
// Every variant but mxu_conv equals the exact preprocess bit for bit: the
// f32 mean's taps are summed in sequence with __fmul_rn/__fadd_rn (and the
// file is built with -fmad=false), and the wrap index only moves where each
// tap reads, never the order of the sum.  mxu_conv's mean rounds otherwise
// (within ~1e-4 of an f32 product), so its threshold may flip where the
// mean lies near a half-integer.
//
// What bounds it on an H100 SXM: the f32 mean's 44 uncontracted operations
// a pixel on the SMs' FP32 lanes (0.404 us per 640x480 frame at 1980 MHz),
// above the bytes (frame 3 B/px in, plane 1 B/px out: 0.367 us at 3.35
// TB/s); mxu_conv's TF32 products take 0.179.  It runs hd_preprocess's
// kernel, which is bound by its stencil phases' instruction issue and
// shared-memory latency (fused_detect.cu).  Batch 256 of the bench's
// 640x480 frames (chip_smoke.py phase 5e, NVIDIA H100 80GB HBM3, 700.00
// W): the exact variants 3.56-3.64 us/frame and full_roll 3.18-3.20, from
// 12.0-12.8 through global-memory passes (8 launches); the wrap instance's
// border tiles run border-free, which is why it beats the exact one.
// mxu_conv takes 5.45-5.51: its fragments' loads and TF32 splits cost
// more than the scalar mean's 44 operations a pixel.  An interior tile's
// mma weights come from a table of the taps' TF32 parts.
//
// hd_mxu_mean, mxu_conv's products alone over device memory (a warp per
// 16 x 8 tile of the output, over the band's k tiles only), is timed beside
// torch.matmul.

#include "preprocess_tile.cuh"

namespace {

// Which border a variant asks for (ops/pre_variants.py's VARIANTS).
enum Border { kExact = 0, kWrapBorder = 1, kSplit = 2 };

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

int launch_band_table(const Taps& t, int W, int H, float* band,
                      cudaStream_t st) {
  int n = 11 * (W + H);
  k_band_table<<<(n + 255) / 256, 256, 0, st>>>(t, W, H, band);
  HD_CHECK();
  return 0;
}

// One tile preprocess over frames [B, 3, H, W] into out [B, H, W]: the
// tile is interior (kI) or a border tile, as in k_preprocess.  The mma
// instance takes three blocks an SM, for the registers of its fragments.
template <int kStop, bool kWrap, bool kPair, bool kMma>
__global__ void __launch_bounds__(kPreThreads, kMma ? 3 : 4)
    k_pre_variant(Frames f, int H, int W, Taps t, int ct, uint8_t* out,
                  bool vec, const float* band) {
  extern __shared__ __align__(16) uint8_t smem[];
  int y0 = blockIdx.y * kPreTY, x0 = blockIdx.x * kPreTX;
  if (y0 >= 11 && x0 >= 11 && y0 + kPreTY + 11 <= H && x0 + kPreTX + 11 <= W)
    preprocess_tile<true, kStop, false, kWrap, kPair, kMma>(
        f, H, W, t, ct, nullptr, out, smem, vec, band);
  else
    preprocess_tile<false, kStop, false, kWrap, kPair, kMma>(
        f, H, W, t, ct, nullptr, out, smem, vec, band);
}

template <int kStop, bool kWrap, bool kPair, bool kMma>
int launch_variant(const Frames& f, int B, int H, int W, const Taps& t,
                   int ct, uint8_t* out, const float* band, cudaStream_t st) {
  auto kernel = k_pre_variant<kStop, kWrap, kPair, kMma>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPreSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kPreTX - 1) / kPreTX, (H + kPreTY - 1) / kPreTY, B);
  // word loads and stores where the rows start on 32-bit words
  bool vec = W % 4 == 0 && (uintptr_t)f.data % 4 == 0 &&
             f.cstride % 4 == 0 && (uintptr_t)out % 4 == 0;
  kernel<<<grid, kPreThreads, kPreSmem, st>>>(f, H, W, t, ct, out, vec,
                                              band);
  HD_CHECK();
  return 0;
}

// ------------------------------------------------ mxu_conv's products alone

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
// band (rows r0 - 5 .. r0 + 20), into mean (f32).
__global__ void k_mma_mean_v(Geom g, const float* band_h, const float* mh,
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
    if (r < g.H && c < g.W) mean[base + (long long)r * g.W + c] = d[i];
  }
}

}  // namespace

// Frames [B, 3, H, W] -> out u8 [B, H, W], the plane of `stage` (1 blur5:
// u8; 2 mean11: 0/255; 3 pre: opened and closed, 0/1) with the ingredients
// `border` (0 exact; 1 wrap-around, any stage, no pair or mma; 2 unchecked
// interior with an exact border band, which is the exact preprocess),
// `pair` (paired blur taps) and `mma` (the mean as banded tensor-core
// products, with pair).  The exact borders run only to pre.  Scratch: band
// float32 [11 * (W + H)] (mma only).  H, W >= 6.  One launch (two with
// mma: the band tables first).  Returns the first CUDA error.
extern "C" int hd_pre_variant(const uint8_t* frames, int B, int H, int W,
                              int ct, int stage, int border, int pair,
                              int mma, const int* q8, const float* k11,
                              uint8_t* out, float* band, void* stream) {
  bool wrap = border == kWrapBorder;
  if (stage < kBlur5 || stage > kPre || border < kExact || border > kSplit ||
      H < 6 || W < 6 || (wrap && (pair || mma)) ||
      (!wrap && stage != kPre) || (mma && !pair))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Frames f{frames, 3, 3LL * H * W, (long long)H * W, 1};
  Taps t = taps_of(q8, k11);
  if (wrap) {
    if (stage == kBlur5)
      return launch_variant<kBlur5, true, false, false>(f, B, H, W, t, ct,
                                                        out, nullptr, st);
    if (stage == kMean11)
      return launch_variant<kMean11, true, false, false>(f, B, H, W, t, ct,
                                                         out, nullptr, st);
    return launch_variant<kPre, true, false, false>(f, B, H, W, t, ct, out,
                                                    nullptr, st);
  }
  if (mma) {
    int err = launch_band_table(t, W, H, band, st);
    if (err) return err;
    return launch_variant<kPre, false, true, true>(f, B, H, W, t, ct, out,
                                                   band, st);
  }
  if (pair)
    return launch_variant<kPre, false, true, false>(f, B, H, W, t, ct, out,
                                                    nullptr, st);
  return launch_variant<kPre, false, false, false>(f, B, H, W, t, ct, out,
                                                   nullptr, st);
}

// mxu_conv's f32 mean11 alone: blurred u8 [B, H, W] -> mean float32
// [B, H, W], the two banded tensor-core products (no rounding, no
// threshold).  Scratch: work float32 [B, H, W], band float32
// [11 * (W + H)].  Returns the first CUDA error.
extern "C" int hd_mxu_mean(const uint8_t* blurred, int B, int H, int W,
                           const float* k11, float* band, float* work,
                           float* mean, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Geom g{H, W, (long long)H * W, H, 1};
  int q8[5] = {0, 0, 0, 0, 0};
  int err = launch_band_table(taps_of(q8, k11), W, H, band, st);
  if (err) return err;
  dim3 grid((W + 8 * kMmaWarps - 1) / (8 * kMmaWarps), (H + 15) / 16, B);
  k_mma_mean_h<<<grid, 32 * kMmaWarps, 0, st>>>(g, band, blurred, work);
  HD_CHECK();
  k_mma_mean_v<<<grid, 32 * kMmaWarps, 0, st>>>(g, band + 11 * W, work,
                                                mean);
  HD_CHECK();
  return 0;
}
