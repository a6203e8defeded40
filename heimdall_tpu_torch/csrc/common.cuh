// Device helpers shared by the port's kernels (fused_detect.cu,
// ccl_tiled.cu, stats_tiled.cu, runtable_tiled.cu, pre_variants.cu,
// fill_sweeps.cu): the 32 x 8 pixel mapping and its per-frame skip, the
// preprocess's taps, borders, gray and 3x3 erode/dilate pass, warp run starts,
// union-find with atomicMin hooking and the background union-find of the
// hole fill, block scans and sums for 256-thread blocks, a search in a sorted
// root table, the slot-list writer, the launch check of the entry points,
// and the preprocess's passes up to the threshold (exact, or with the
// probes' borders and paired taps).  Each .cu that includes this file is
// its own library, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// 3x3 erode (is_min) or dilate over in-frame neighbours: cv2's constant
// border of 255 for erode and 0 for dilate never wins the reduction.
__device__ __forceinline__ int minmax3(const uint8_t* in, const Geom& g,
                                       const Pix& q, bool is_min) {
  int v = is_min ? 255 : 0;
  for (int dy = -1; dy <= 1; ++dy) {
    int yy = q.y + dy;
    if (yy < 0 || yy >= g.H) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      int xx = q.x + dx;
      if (xx < 0 || xx >= g.W) continue;
      int u = in[(long long)yy * g.W + xx];
      v = is_min ? min(v, u) : max(v, u);
    }
  }
  return v;
}

// One 3x3 erode (is_min) or dilate pass over a [B, H, W] u8 batch.
__global__ void k_morph(Geom g, const uint8_t* in, uint8_t* out, int is_min) {
  Pix q = pix(g);
  if (!q.in) return;
  out[q.b * g.HW + q.p] = (uint8_t)minmax3(in + q.b * g.HW, g, q, is_min);
}

// The preprocess's passes up to the threshold, one launch each over [B, H, W]
// planes: gray + the blur's row pass (acc int32), its column pass (blurred
// u8), the mean's row pass (mh float32) and its column pass with the INV
// threshold.  fused_detect.cu runs them exact (<kExact, false>: reflect-101
// for the blur, replicate for the mean); pre_variants.cu swaps in the
// probes' borders and paired taps.  The f32 taps are summed in sequence with
// __fmul_rn/__fadd_rn (never contracted; every file is also built with
// -fmad=false) and rounded half to even: a border only moves where a tap
// reads, never the order of the sum.

// The border of a pass: exact, wrap-around (a roll, (j mod n)), or the exact
// one only where a tap leaves the axis and an unchecked read elsewhere.
enum Border { kExact = 0, kWrap = 1, kSplit = 2 };

// (j mod n) for -n <= j < 2n: the wrap-around read of a roll.
__device__ __forceinline__ int wrapi(int j, int n) {
  return j < 0 ? j + n : (j >= n ? j - n : j);
}

// Source index of the tap at j = x + i - r along an axis of n: the exact
// border (reflect-101 for the blur, replicate for the mean), wrap-around,
// or, with kSplit, j itself where `inner` (no tap leaves the axis).
template <int kBorder, bool kReflect>
__device__ __forceinline__ int tap_src(int j, int n, bool inner) {
  if (kBorder == kWrap) return wrapi(j, n);
  if (kBorder == kSplit && inner) return j;
  return kReflect ? reflect101(j, n) : clampi(j, 0, n - 1);
}

// The Q8 blur's sum over five taps v[0..4]: in tap order, or paired as
// t2*c + t1*(a+b) + t0*(a'+b') (the taps are symmetric; exact in int).
template <bool kPair>
__device__ __forceinline__ int blur_sum(const Taps& t, const int (&v)[5]) {
  if (kPair)
    return t.q8[2] * v[2] + t.q8[1] * (v[1] + v[3]) + t.q8[0] * (v[0] + v[4]);
  int s = 0;
  for (int i = 0; i < 5; ++i) s += t.q8[i] * v[i];
  return s;
}

// The blur's row pass into acc; with kWriteGray also the gray plane.
template <int kBorder, bool kPair, bool kWriteGray>
__global__ void k_gray_blur_h(Frames f, Geom g, Taps t, uint8_t* gray,
                              int32_t* acc) {
  Pix q = pix(g);
  if (!q.in) return;
  long long row = (long long)q.y * g.W;
  bool inner = q.x >= 2 && q.x < g.W - 2;
  int v[5];
  for (int i = 0; i < 5; ++i)
    v[i] = gray_at(f, q.b, row + tap_src<kBorder, true>(q.x + i - 2, g.W,
                                                         inner));
  long long o = q.b * g.HW + q.p;
  if (kWriteGray) gray[o] = (uint8_t)gray_at(f, q.b, q.p);
  acc[o] = blur_sum<kPair>(t, v);
}

template <int kBorder, bool kPair>
__global__ void k_blur_v(Geom g, Taps t, const int32_t* acc,
                         uint8_t* blurred) {
  Pix q = pix(g);
  if (!q.in) return;
  const int32_t* a = acc + q.b * g.HW;
  bool inner = q.y >= 2 && q.y < g.H - 2;
  int v[5];
  for (int i = 0; i < 5; ++i)
    v[i] = a[(long long)tap_src<kBorder, true>(q.y + i - 2, g.H, inner) *
                 g.W + q.x];
  int s = blur_sum<kPair>(t, v);
  blurred[q.b * g.HW + q.p] = (uint8_t)clampi((s + (1 << 15)) >> 16, 0, 255);
}

template <int kBorder>
__global__ void k_mean_h(Geom g, Taps t, const uint8_t* blurred, float* mh) {
  Pix q = pix(g);
  if (!q.in) return;
  const uint8_t* r = blurred + q.b * g.HW + (long long)q.y * g.W;
  bool inner = q.x >= 5 && q.x < g.W - 5;
  float s = __fmul_rn(t.k11[0],
                      (float)r[tap_src<kBorder, false>(q.x - 5, g.W, inner)]);
  for (int i = 1; i < 11; ++i)
    s = __fadd_rn(s, __fmul_rn(t.k11[i], (float)r[tap_src<kBorder, false>(
                                             q.x + i - 5, g.W, inner)]));
  mh[q.b * g.HW + q.p] = s;
}

// Foreground pixels get `on` (1, or 255 for the mean11 stage).
template <int kBorder>
__global__ void k_mean_v_threshold(Geom g, Taps t, int ct, uint8_t on,
                                   const float* mh, const uint8_t* blurred,
                                   uint8_t* bin) {
  Pix q = pix(g);
  if (!q.in) return;
  const float* m = mh + q.b * g.HW;
  bool inner = q.y >= 5 && q.y < g.H - 5;
  float s = __fmul_rn(
      t.k11[0], m[(long long)tap_src<kBorder, false>(q.y - 5, g.H, inner) *
                      g.W + q.x]);
  for (int i = 1; i < 11; ++i)
    s = __fadd_rn(s, __fmul_rn(t.k11[i],
                               m[(long long)tap_src<kBorder, false>(
                                     q.y + i - 5, g.H, inner) * g.W + q.x]));
  long long o = q.b * g.HW + q.p;
  bin[o] = (int)blurred[o] <= __float2int_rn(s) - ct ? on : 0;
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

// Linear index of the first pixel of this lane's run of equal `v` within the
// warp's 32-pixel row segment.  Every lane of the warp must call it.
__device__ __forceinline__ int run_start(bool v, const Pix& q) {
  unsigned bits = __ballot_sync(kFull, v);
  unsigned starts = (bits ^ (bits << 1)) | 1u;
  unsigned upto = starts & ((2u << q.lane) - 1u);
  int start_lane = 31 - __clz(upto);
  return (int)(q.p - (q.lane - start_lane));
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

// Hole fill, background 4-connected, over parents seeded with run starts
// (run_start).  Links inside a warp's row segment are already made by the
// run-start parents; an up link is skipped when the left and up-left pixels
// are background (their own links imply it).
__global__ void k_link_bg(Geom g, const uint8_t* fg, int32_t* parent) {
  for_each_tile(g, [&](Pix q) {
    if (!q.in) return;
    const uint8_t* m = fg + q.b * g.HW;
    int32_t* P = parent + q.b * g.HW;
    int p = (int)q.p;
    if (m[p]) return;
    bool left = q.x > 0 && !m[p - 1];
    if (left && q.lane == 0) unite(P, p, p - 1);
    if (q.y > 0 && !m[p - g.W] && !(left && !m[p - g.W - 1]))
      unite(P, p, p - g.W);
  });
}

// Compress background paths and flag the roots that touch the frame border
// (reach is zeroed beforehand); a background pixel is filled iff its root's
// flag stays 0.
template <typename Reach>
__global__ void k_compress_mark(Geom g, const uint8_t* fg, int32_t* parent,
                                Reach* reach) {
  for_each_tile(g, [&](Pix q) {
    if (!q.in) return;
    long long base = q.b * g.HW;
    if (fg[base + q.p]) return;
    int r = find_root(parent + base, (int)q.p);
    parent[base + q.p] = r;
    if (q.x == 0 || q.y == 0 || q.x == g.W - 1 || q.y == g.H - 1)
      reach[base + r] = 1;
  });
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

}  // namespace
