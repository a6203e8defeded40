// Fused contamination detect for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (heimdall_tpu_torch/ops/_cuda.py).
//
// Replaces heimdall_tpu/ops/pallas_kernels.py::_make_fused_kernel (the one
// Pallas kernel of the 640x480 detect path, launched by contamination_pallas).
// It computes what that kernel computes, per frame:
//   gray (Q15 BT.601) -> Q8 blur5 (reflect-101) -> f32 mean11 with rint
//   (replicate) -> INV threshold -> open, close (3x3, cv2 borders)
//   -> hole fill (background 4-connected to the frame border stays background)
//   -> 8-connected labels = minimum linear index of the component
//   -> for the first K roots in raster order: sums of ones, boundary, x, y,
//      gray, b, g, r; the inclusive bbox; and bbox-window sums of gray, b, g, r.
// Output layout is that of contamination_pallas: sums i32 [B,8,K],
// bbox i32 [B,4,K] (x0,y0,x1,y1), bgsum i32 [B,4,K], n i32 [B]; slots past
// min(n, K) are zero.  The label plane i32 [B,H,W] (background H*W) is a
// by-product and is returned too.
//
// What bounds it on an H100 SXM: the function reads each frame once
// (640x480x3 = 921,600 B) and writes ~4 KB of tables (16 rows x 64 slots x
// 4 B), so the least time is ~0.28 us/frame at 3.35 TB/s; its float work
// (44 flops/pixel in the mean) is ~0.2 us/frame at 67 TFLOP/s.  This first
// design does not approach that bound: it keeps the TPU kernel's arithmetic
// but not its block structure (a 1.2 MB label plane does not fit one SM's
// 227 KB), and passes every stage through global-memory scratch that stays
// partly in the 50 MB L2 (17 launches per batch).  Hole fill and labeling
// are union-find with atomicMin hooking (the larger root goes under the
// smaller, so a root is its component's minimum linear index, which is the
// TPU kernel's label); initial parents are the start of each pixel's
// same-class run within its warp (one ballot), which keeps find paths short.
// Per-slot sums are exact int32 atomics, aggregated per warp and per block in
// shared memory first, so results do not depend on the order of execution.
//
// Numerics: the f32 mean is k0*x0 + k1*x1 + ... + k10*x10 summed strictly in
// sequence, columns first, then rows over the un-rounded intermediate, with
// __fmul_rn/__fadd_rn (never contracted to FMA; the file is also built with
// -fmad=false), and rounded half to even with __float2int_rn.
//
// hd_preprocess (at the end of the file) runs the preprocess stages alone
// for frames of any size, for the band-tiled route; hd_label and
// hd_stats_from_labels are the two-kernel split of the same passes (the
// profiling path, heimdall_tpu_torch/ops/split_kernels.py).

#include <string.h>

#include "common.cuh"

namespace {

constexpr int kStatsRows = 64;    // rows per block in the stats kernel

// ---------------------------------------------------------------- preprocess
// (Taps, reflect101, clampi, gray_at, minmax3, k_morph and the passes up to
// the threshold are in common.cuh; this file runs them <kExact, false>)

// The gray plane alone (hd_label's gray stage).
__global__ void k_gray(Frames f, Geom g, uint8_t* gray) {
  Pix q = pix(g);
  if (!q.in) return;
  gray[q.b * g.HW + q.p] = (uint8_t)gray_at(f, q.b, q.p);
}

// Last erode of the close; also seeds the hole-fill union-find (parents =
// run starts) and clears the border-reach flags.
__global__ void k_close_erode_init(Geom g, const uint8_t* in, uint8_t* fg,
                                   int32_t* parent, int32_t* reach) {
  Pix q = pix(g);
  int v = q.in ? minmax3(in + q.b * g.HW, g, q, true) : 0;
  int start = run_start(v != 0, q);
  if (!q.in) return;
  long long o = q.b * g.HW + q.p;
  fg[o] = (uint8_t)v;
  parent[o] = start;
  reach[o] = 0;
}

// ------------------------------------------------------------- union-find
// (the hole fill's k_link_bg and k_compress_mark are in common.cuh)

// filled = fg | (bg not reached from the border); seeds the labeling
// union-find with run starts of the filled mask.  Each thread reads and
// writes only its own parent entry.
__global__ void k_fill_init(Geom g, uint8_t* fg, int32_t* parent,
                            const int32_t* reach) {
  Pix q = pix(g);
  long long base = q.b * g.HW;
  bool v = false;
  if (q.in) v = fg[base + q.p] || !reach[base + parent[base + q.p]];
  int start = run_start(v, q);
  if (!q.in) return;
  fg[base + q.p] = v;
  parent[base + q.p] = start;
}

// Foreground, 8-connected: left, up-left, up, up-right, with the links that
// the left pixel's (or the up pixel's row) already implies skipped.
__global__ void k_link_fg(Geom g, const uint8_t* fg, int32_t* parent) {
  Pix q = pix(g);
  if (!q.in) return;
  const uint8_t* m = fg + q.b * g.HW;
  int32_t* P = parent + q.b * g.HW;
  int p = (int)q.p;
  if (!m[p]) return;
  bool left = q.x > 0 && m[p - 1];
  if (left && q.lane == 0) unite(P, p, p - 1);
  if (q.y == 0) return;
  int u = p - g.W;
  bool up = m[u];
  bool ul = q.x > 0 && m[u - 1];
  bool ur = q.x < g.W - 1 && m[u + 1];
  if (left) {
    if (!up && ur) unite(P, p, u + 1);
  } else if (up) {
    unite(P, p, u);
  } else {
    if (ul) unite(P, p, u - 1);
    if (ur) unite(P, p, u + 1);
  }
}

__global__ void k_label(Geom g, const uint8_t* fg, int32_t* parent) {
  Pix q = pix(g);
  if (!q.in) return;
  long long base = q.b * g.HW;
  parent[base + q.p] =
      fg[base + q.p] ? find_root(parent + base, (int)q.p) : (int)g.HW;
}

// ------------------------------------------------------------ roots, slots

// hd_stats_from_labels' first pass: gray from the frame, and foreground as
// label != H*W, the planes that the fused detect's stats passes read.
__global__ void k_from_labels(Frames f, Geom g, const int32_t* labels,
                              uint8_t* gray, uint8_t* fg) {
  Pix q = pix(g);
  if (!q.in) return;
  long long o = q.b * g.HW + q.p;
  gray[o] = (uint8_t)gray_at(f, q.b, q.p);
  fg[o] = labels[o] != (int)g.HW;
}

// One block per (row, frame): raster rank of each root within its row
// (written at the root's pixel in `rank`) and the row's root count.
__global__ void k_row_roots(Geom g, const uint8_t* fg, const int32_t* labels,
                            int32_t* rank, int32_t* rowcnt) {
  int y = blockIdx.x, b = blockIdx.y;
  long long base = b * g.HW + (long long)y * g.W;
  int carry = 0;
  for (int x0 = 0; x0 < g.W; x0 += blockDim.x) {
    int x = x0 + threadIdx.x;
    long long p = (long long)y * g.W + x;
    bool root = x < g.W && fg[base + x] && labels[base + x] == (int)p;
    int total;
    int excl = block_exclusive_scan(root ? 1 : 0, &total);
    if (root) rank[base + x] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) rowcnt[(long long)b * g.H + y] = carry;
}

// One block per frame: row offsets (exclusive prefix of row counts), the
// blob count, and the bbox accumulators' initial values.
__global__ void k_frame_roots(Geom g, int K, const int32_t* rowcnt,
                              int32_t* rowoff, int32_t* nblobs,
                              int32_t* bbox) {
  int b = blockIdx.x;
  const int32_t* c = rowcnt + (long long)b * g.H;
  int32_t* o = rowoff + (long long)b * g.H;
  int carry = 0;
  for (int y0 = 0; y0 < g.H; y0 += blockDim.x) {
    int y = y0 + threadIdx.x;
    int v = y < g.H ? c[y] : 0;
    int total;
    int excl = block_exclusive_scan(v, &total);
    if (y < g.H) o[y] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) nblobs[b] = carry;
  int32_t* bb = bbox + (long long)b * 4 * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    bb[k] = 0x7fffffff;      // x0: atomicMin
    bb[K + k] = 0;           // y0: written by the root
    bb[2 * K + k] = -1;      // x1: atomicMax
    bb[3 * K + k] = -1;      // y1: atomicMax
  }
}

// ------------------------------------------------------------------ stats

// Per-slot sums and bbox over a 32 x 64 tile per block: each warp reduces
// when all its lanes share a slot (the common case inside a blob), else its
// lanes add one by one; the block then adds its shared totals to the
// outputs with one atomic per touched slot and statistic.  kAnyLabels (the
// stats kernel from a given label plane) gives a pixel a slot only if its
// label names a root, a pixel whose label is its own index, as the TPU stats
// kernel does; rank holds nothing at other pixels.  The fused detect's
// labels always name a root, so it skips that read.
template <bool kAnyLabels>
__global__ void k_stats(Frames f, Geom g, int K, const uint8_t* fg,
                        const int32_t* labels, const int32_t* rank,
                        const int32_t* rowoff, const uint8_t* gray,
                        int32_t* sums, int32_t* bbox) {
  extern __shared__ int sm[];
  int* s_sum = sm;               // [8][K]
  int* s_x0 = sm + 8 * K;        // [K]
  int* s_x1 = s_x0 + K;
  int* s_y1 = s_x1 + K;
  int tid = threadIdx.y * blockDim.x + threadIdx.x;
  int nthr = blockDim.x * blockDim.y;
  for (int i = tid; i < 8 * K; i += nthr) s_sum[i] = 0;
  for (int i = tid; i < K; i += nthr) {
    s_x0[i] = 0x7fffffff;
    s_x1[i] = -1;
    s_y1[i] = -1;
  }
  __syncthreads();

  int b = blockIdx.z;
  long long base = b * g.HW;
  int x = blockIdx.x * kTileW + threadIdx.x;
  int lane = threadIdx.x;
  for (int r = 0; r < kStatsRows; r += kTileH) {
    int y = blockIdx.y * kStatsRows + r + threadIdx.y;
    bool in = x < g.W && y < g.H;
    long long p = (long long)y * g.W + x;
    int slot = -1;
    int v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (in && fg[base + p]) {
      int root = labels[base + p];
      int s = !kAnyLabels || labels[base + root] == root
                  ? rowoff[(long long)b * g.H + root / g.W] + rank[base + root]
                  : K;
      if (s < K) {
        slot = s;
        bool bnd = x == 0 || y == 0 || x == g.W - 1 || y == g.H - 1 ||
                   !fg[base + p - 1] || !fg[base + p + 1] ||
                   !fg[base + p - g.W] || !fg[base + p + g.W];
        v[0] = 1;
        v[1] = bnd ? 1 : 0;
        v[2] = x;
        v[3] = y;
        v[4] = gray[base + p];
        if (f.C == 3) {
          const uint8_t* d = f.data + b * f.fstride + p * f.pstride;
          v[5] = d[0];
          v[6] = d[f.cstride];
          v[7] = d[2 * f.cstride];
        }
        if (p == root) bbox[(long long)b * 4 * K + K + s] = y;
      }
    }
    int s0 = __shfl_sync(kFull, slot, 0);
    if (__all_sync(kFull, slot == s0)) {
      if (s0 >= 0) {
        int red[8];
        for (int i = 0; i < 8; ++i) red[i] = __reduce_add_sync(kFull, v[i]);
        int xmin = __reduce_min_sync(kFull, x);
        int xmax = __reduce_max_sync(kFull, x);
        int ymax = __reduce_max_sync(kFull, y);
        if (lane == 0) {
          for (int i = 0; i < 8; ++i) atomicAdd(&s_sum[i * K + s0], red[i]);
          atomicMin(&s_x0[s0], xmin);
          atomicMax(&s_x1[s0], xmax);
          atomicMax(&s_y1[s0], ymax);
        }
      }
    } else if (slot >= 0) {
      for (int i = 0; i < 8; ++i) atomicAdd(&s_sum[i * K + slot], v[i]);
      atomicMin(&s_x0[slot], x);
      atomicMax(&s_x1[slot], x);
      atomicMax(&s_y1[slot], y);
    }
  }
  __syncthreads();

  int32_t* gs = sums + (long long)b * 8 * K;
  int32_t* gb = bbox + (long long)b * 4 * K;
  for (int k = tid; k < K; k += nthr) {
    if (s_sum[k] == 0) continue;
    for (int i = 0; i < 8; ++i)
      if (s_sum[i * K + k]) atomicAdd(&gs[i * K + k], s_sum[i * K + k]);
    atomicMin(&gb[k], s_x0[k]);
    atomicMax(&gb[2 * K + k], s_x1[k]);
    atomicMax(&gb[3 * K + k], s_y1[k]);
  }
}

// One block per (slot, frame): zero the bbox of unused slots, and sum gray,
// b, g, r over the inclusive bbox window of used ones.
__global__ void k_bbox_sums(Frames f, Geom g, int K, const int32_t* nblobs,
                            const uint8_t* gray, int32_t* bbox,
                            int32_t* bgsum) {
  int k = blockIdx.x, b = blockIdx.y;
  int32_t* bb = bbox + (long long)b * 4 * K;
  int used = min(nblobs[b], K);
  if (k >= used) {
    if (threadIdx.x < 4) bb[threadIdx.x * K + k] = 0;
    return;
  }
  int x0 = bb[k], y0 = bb[K + k], x1 = bb[2 * K + k], y1 = bb[3 * K + k];
  int bw = x1 - x0 + 1;
  long long n = (long long)bw * (y1 - y0 + 1);
  long long base = b * g.HW;
  int acc[4] = {0, 0, 0, 0};
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    long long p = (long long)(y0 + i / bw) * g.W + x0 + i % bw;
    acc[0] += gray[base + p];
    if (f.C == 3) {
      const uint8_t* d = f.data + b * f.fstride + p * f.pstride;
      acc[1] += d[0];
      acc[2] += d[f.cstride];
      acc[3] += d[2 * f.cstride];
    }
  }
  int32_t* out = bgsum + (long long)b * 4 * K;
  for (int c = 0; c < 4; ++c) {
    int t = block_sum(acc[c]);
    if (threadIdx.x == 0) out[c * K + k] = t;
  }
}

// The stages of hd_label, in order: it stops after `stage`.  Every other
// entry point runs the whole preprocess (kCcl passed as the stage).
enum Stage { kGray = 0, kBlur5, kMean11, kPre, kFill, kCcl, kNumStages };

// The preprocess passes of every entry point, up to the dilate of the
// close: gray in `gray`, the dilated plane in plane1 (plane2 and work are
// scratch).  With stage kGray, kBlur5 or kMean11 it stops after that stage,
// whose plane is then in gray, plane1 or plane2 (threshold 0/255).  Returns
// the first CUDA error.
int launch_to_close_dilate(const Frames& f, const Geom& g, int B, int ct,
                           const int* q8, const float* k11, int stage,
                           uint8_t* gray, uint8_t* plane1, uint8_t* plane2,
                           int32_t* work, cudaStream_t st) {
  Taps t;
  memcpy(t.q8, q8, sizeof(t.q8));
  memcpy(t.k11, k11, sizeof(t.k11));
  dim3 blk(kTileW, kTileH);
  dim3 grid((g.W + kTileW - 1) / kTileW, (g.H + kTileH - 1) / kTileH, B);
  float* fwork = reinterpret_cast<float*>(work);
  if (stage == kGray) {
    k_gray<<<grid, blk, 0, st>>>(f, g, gray);
    HD_CHECK();
    return 0;
  }
  k_gray_blur_h<kExact, false, true><<<grid, blk, 0, st>>>(f, g, t, gray,
                                                        work);
  HD_CHECK();
  k_blur_v<kExact, false><<<grid, blk, 0, st>>>(g, t, work, plane1);
  HD_CHECK();
  if (stage == kBlur5) return 0;
  k_mean_h<kExact><<<grid, blk, 0, st>>>(g, t, plane1, fwork);
  HD_CHECK();
  uint8_t on = stage == kMean11 ? 255 : 1;
  k_mean_v_threshold<kExact><<<grid, blk, 0, st>>>(g, t, ct, on, fwork,
                                                   plane1, plane2);
  HD_CHECK();
  if (stage == kMean11) return 0;
  k_morph<<<grid, blk, 0, st>>>(g, plane2, plane1, 1);   // open: erode
  HD_CHECK();
  k_morph<<<grid, blk, 0, st>>>(g, plane1, plane2, 0);   //       dilate
  HD_CHECK();
  k_morph<<<grid, blk, 0, st>>>(g, plane2, plane1, 0);   // close: dilate
  HD_CHECK();
  return 0;
}

// From the close's dilated plane in plane1: the last erode into plane2
// (seeding the union-finds), the hole fill (plane2 = filled mask, 0/1) and,
// unless stage is kFill, the labels (`labels`, background H*W; the hole
// fill's parents live there before).  work is scratch.
int launch_fill_label(const Geom& g, int B, int stage, uint8_t* plane1,
                      uint8_t* plane2, int32_t* work, int32_t* labels,
                      cudaStream_t st) {
  dim3 blk(kTileW, kTileH);
  dim3 grid((g.W + kTileW - 1) / kTileW, (g.H + kTileH - 1) / kTileH, B);
  k_close_erode_init<<<grid, blk, 0, st>>>(g, plane1, plane2, labels, work);
  HD_CHECK();
  k_link_bg<<<grid, blk, 0, st>>>(g, plane2, labels);
  HD_CHECK();
  k_compress_mark<<<grid, blk, 0, st>>>(g, plane2, labels, work);
  HD_CHECK();
  k_fill_init<<<grid, blk, 0, st>>>(g, plane2, labels, work);
  HD_CHECK();
  if (stage == kFill) return 0;
  k_link_fg<<<grid, blk, 0, st>>>(g, plane2, labels);
  HD_CHECK();
  k_label<<<grid, blk, 0, st>>>(g, plane2, labels);
  HD_CHECK();
  return 0;
}

// The first-K-root statistics from the foreground plane fg (0/1), the label
// plane and the gray plane: slot ranking (rank int32 [B, H, W] and rowcnt /
// rowoff int32 [B, H] are scratch), per-slot sums and bbox, bbox-window sums
// and the blob count.  sums and bgsum must be zeroed by the caller.  With
// any_labels, a label that is not a root's index gives no slot (k_stats).
int launch_stats(const Frames& f, const Geom& g, int B, int K, bool any_labels,
                 const uint8_t* fg, const int32_t* labels, int32_t* rank,
                 int32_t* rowcnt, int32_t* rowoff, const uint8_t* gray,
                 int32_t* sums, int32_t* bbox, int32_t* bgsum,
                 int32_t* nblobs, cudaStream_t st) {
  k_row_roots<<<dim3(g.H, B), 256, 0, st>>>(g, fg, labels, rank, rowcnt);
  HD_CHECK();
  k_frame_roots<<<B, 256, 0, st>>>(g, K, rowcnt, rowoff, nblobs, bbox);
  HD_CHECK();
  dim3 blk(kTileW, kTileH);
  dim3 sgrid((g.W + kTileW - 1) / kTileW, (g.H + kStatsRows - 1) / kStatsRows,
             B);
  size_t smem = (size_t)11 * K * sizeof(int);
  if (any_labels)
    k_stats<true><<<sgrid, blk, smem, st>>>(f, g, K, fg, labels, rank, rowoff,
                                           gray, sums, bbox);
  else
    k_stats<false><<<sgrid, blk, smem, st>>>(f, g, K, fg, labels, rank,
                                            rowoff, gray, sums, bbox);
  HD_CHECK();
  k_bbox_sums<<<dim3(K, B), 256, 0, st>>>(f, g, K, nblobs, gray, bbox, bgsum);
  HD_CHECK();
  return 0;
}

}  // namespace

// Runs the whole detect on `stream`.  Scratch planes are [B, H, W]:
// gray/plane1/plane2 uint8, work int32 (also used as float32), labels int32
// (the output label plane).  rowcnt/rowoff are int32 [B, H].  sums and bgsum
// must be zeroed by the caller.  Returns the first CUDA error (0 = none).
extern "C" int hd_fused_detect(
    const uint8_t* frames, int B, int H, int W, int C, long long cstride,
    long long pstride, int ct, int K, const int* q8, const float* k11,
    uint8_t* gray, uint8_t* plane1, uint8_t* plane2, int32_t* work,
    int32_t* labels, int32_t* rowcnt, int32_t* rowoff, int32_t* sums,
    int32_t* bbox, int32_t* bgsum, int32_t* nblobs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Geom g{H, W, (long long)H * W, H, 1};
  Frames f{frames, C, (long long)C * g.HW, cstride, pstride};
  int err = launch_to_close_dilate(f, g, B, ct, q8, k11, kCcl, gray, plane1,
                                   plane2, work, st);
  if (!err) err = launch_fill_label(g, B, kCcl, plane1, plane2, work, labels,
                                    st);
  if (!err) err = launch_stats(f, g, B, K, false, plane2, labels, work,
                               rowcnt, rowoff, gray, sums, bbox, bgsum, nblobs,
                               st);
  return err;
}

// Number of kernel launches one hd_fused_detect call makes.
extern "C" int hd_fused_detect_launches() { return 17; }

// The preprocess stages of hd_fused_detect alone, for frames of any size
// (the band-tiled route of heimdall_tpu_torch/ops/ccl_tiled.py takes over
// from the closed mask): gray u8 [B, H, W] and the closed binary plane
// binary u8 [B, H, W] (0/1).  Scratch: work int32 [B, H, W] (also used as
// float32), plane1/plane2 u8 [B, H, W].  Returns the first CUDA error.
extern "C" int hd_preprocess(
    const uint8_t* frames, int B, int H, int W, int C, long long cstride,
    long long pstride, int ct, const int* q8, const float* k11,
    uint8_t* gray, uint8_t* plane1, uint8_t* plane2, int32_t* work,
    uint8_t* binary, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Geom g{H, W, (long long)H * W, H, 1};
  Frames f{frames, C, (long long)C * g.HW, cstride, pstride};
  int err = launch_to_close_dilate(f, g, B, ct, q8, k11, kCcl, gray, plane1,
                                   plane2, work, st);
  if (err) return err;
  dim3 blk(kTileW, kTileH);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  k_morph<<<grid, blk, 0, st>>>(g, plane1, binary, 1);   // close: erode
  HD_CHECK();
  return 0;
}

// ------------------------------------------------- the two-kernel split
//
// hd_label and hd_stats_from_labels replace the split of the fused Pallas
// kernel that heimdall_tpu's profiler runs (scripts/profile_fused.py):
// pallas_kernels.py::_make_label_kernel (frame -> label plane) and
// ::_make_stats_kernel (frame + label plane -> the fused kernel's tables),
// and the profilers' truncations of the label kernel
// (scripts/profile_fused.py, scripts/profile_preprocess.py), which are
// hd_label's stages.  Both take BGR planes [B, 3, H, W] and run the fused
// detect's passes above; B6b(frame) then B6a(frame, labels) gives the fused
// detect's outputs.  What bounds them on an H100 SXM: bytes.  hd_label reads
// the frame (3 B/px) and writes one plane (1 B/px, 4 B/px for the labels);
// hd_stats_from_labels reads the frame and the labels (7 B/px) and writes
// ~4 KB of tables.  Like the fused detect, they pass every stage through
// global-memory scratch rather than approach that bound.

// Frame -> the plane of `stage`: gray (gray), Q8 blur5 (plane1), the INV
// threshold of the f32 mean11 as 0/255 (plane2), the opened and closed mask
// (plane2, 0/1), the hole-filled mask (plane2, 0/1) or the 8-connected
// labels (labels, background H*W).  Scratch: gray/plane1/plane2 u8 and
// work/labels int32, all [B, H, W].  Returns the first CUDA error.
extern "C" int hd_label(const uint8_t* frames, int B, int H, int W, int ct,
                        int stage, const int* q8, const float* k11,
                        uint8_t* gray, uint8_t* plane1, uint8_t* plane2,
                        int32_t* work, int32_t* labels, void* stream) {
  if (stage < 0 || stage >= kNumStages) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Geom g{H, W, (long long)H * W, H, 1};
  Frames f{frames, 3, 3 * g.HW, g.HW, 1};
  int err = launch_to_close_dilate(f, g, B, ct, q8, k11, stage, gray, plane1,
                                   plane2, work, st);
  if (err || stage <= kMean11) return err;
  if (stage == kPre) {
    dim3 blk(kTileW, kTileH);
    dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
    k_morph<<<grid, blk, 0, st>>>(g, plane1, plane2, 1);   // close: erode
    HD_CHECK();
    return 0;
  }
  return launch_fill_label(g, B, stage, plane1, plane2, work, labels, st);
}

// Number of kernel launches one hd_label call makes at `stage`.
extern "C" int hd_label_launches(int stage) {
  static const int n[kNumStages] = {1, 2, 4, 8, 11, 13};
  return stage >= 0 && stage < kNumStages ? n[stage] : 0;
}

// Frame + label plane -> the fused detect's tables: sums [B,8,K], bbox
// [B,4,K], bgsum [B,4,K] (sums and bgsum zeroed by the caller) and n [B].
// Foreground is label != H*W and a root is a pixel whose label is its own
// linear index; a pixel belongs to the slot of the root its label names, and
// to none if its label names no root.  labels: int32 in [0, H*W].
// Scratch: gray/fg u8 and rank int32 [B, H, W], rowcnt/rowoff int32 [B, H].
extern "C" int hd_stats_from_labels(
    const uint8_t* frames, int B, int H, int W, int K, const int32_t* labels,
    uint8_t* gray, uint8_t* fg, int32_t* rank, int32_t* rowcnt,
    int32_t* rowoff, int32_t* sums, int32_t* bbox, int32_t* bgsum,
    int32_t* nblobs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Geom g{H, W, (long long)H * W, H, 1};
  Frames f{frames, 3, 3 * g.HW, g.HW, 1};
  dim3 blk(kTileW, kTileH);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  k_from_labels<<<grid, blk, 0, st>>>(f, g, labels, gray, fg);
  HD_CHECK();
  return launch_stats(f, g, B, K, true, fg, labels, rank, rowcnt, rowoff,
                      gray, sums, bbox, bgsum, nblobs, st);
}

// Number of kernel launches one hd_stats_from_labels call makes.
extern "C" int hd_stats_from_labels_launches() { return 5; }
