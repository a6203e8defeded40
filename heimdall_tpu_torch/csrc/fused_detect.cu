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
// 4 B), so its bytes take ~0.28 us/frame at 3.35 TB/s; its float work (the
// mean's 44 uncontracted operations a pixel on the SMs' 128 FP32 lanes)
// takes ~0.40, which bounds it.  A 1.2 MB label plane does not fit one SM's
// 227 KB, so the TPU kernel's one launch does not map over; the detect is
// composed of the port's shared-memory tile kernels instead, 11 launches:
//   1. the one-pass preprocess (k_preprocess below, hd_preprocess's): gray
//      and the closed mask, no other plane;
//   2. the hole fill's block union-find (tile_uf.cuh, hd_flood_fill's, 3
//      launches), in place on the closed mask;
//   3. the foreground tile labeling (tile_uf.cuh, hd_band_ccl's with one
//      band of H rows, 3 launches): labels = minimum linear index of the
//      8-connected component (the TPU kernel's label), each written once
//      and only components joined across tile edges rewritten;
//   4. the first-K-root statistics (launch_stats, 4 launches).
// Scratch beyond the outputs: gray and mask (1 B/px each), the fill's
// per-frame table (L2-resident), and the stats' root ranks.
// Per-slot sums are exact int32 atomics, aggregated per warp and per block in
// shared memory first, so results do not depend on the order of execution.
//
// Numerics: the f32 mean is k0*x0 + k1*x1 + ... + k10*x10 summed strictly in
// sequence, columns first, then rows over the un-rounded intermediate, with
// __fmul_rn/__fadd_rn (never contracted to FMA; the file is also built with
// -fmad=false), and rounded half to even with __float2int_rn.
//
// hd_preprocess runs the preprocess stages alone for frames of any size,
// for the 2 MP routes, as one launch over shared-memory tiles (the tile
// preprocess of preprocess_tile.cuh): no plane of scratch, and its bound
// is the mean's 44 uncontracted float operations a pixel on the SMs' 128
// FP32 lanes, above its 3 (Mono8) or 5 (BGR) bytes a pixel.  hd_label is
// the first kernel of the two-kernel split of the detect (the profiling
// path, heimdall_tpu_torch/ops/split_kernels.py; the second,
// hd_stats_from_labels, is in stats_labels.cu): its stages are the
// profilers' truncations, each reached by the same kernels as the detect
// (the one-pass preprocess stopped at the stage, then the tile fill and
// the tile labels).

#include "preprocess_tile.cuh"
#include "tile_uf.cuh"

namespace {

constexpr int kStatsRows = 64;    // rows per block in the stats kernel

// ---------------------------------------------------------------- preprocess
// (Taps, reflect101, clampi and gray_at are in common.cuh)

// (the stages of hd_label, Stage, are in preprocess_tile.cuh)

// The gray plane alone (hd_label's gray stage).
__global__ void k_gray(Frames f, Geom g, uint8_t* gray) {
  Pix q = pix(g);
  if (!q.in) return;
  gray[q.b * g.HW + q.p] = (uint8_t)gray_at(f, q.b, q.p);
}

// ------------------------------------------------------------ roots, slots

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
// outputs with one atomic per touched slot and statistic.  The fused
// detect's labels always name a root, so a pixel's slot is its root's rank.
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
      int s = rowoff[(long long)b * g.H + root / g.W] + rank[base + root];
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

// The first-K-root statistics from the foreground plane fg (0/1), the label
// plane and the gray plane: slot ranking (rank int32 [B, H, W] and rowcnt /
// rowoff int32 [B, H] are scratch), per-slot sums and bbox, bbox-window sums
// and the blob count.  sums and bgsum must be zeroed by the caller.
int launch_stats(const Frames& f, const Geom& g, int B, int K,
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
  k_stats<<<sgrid, blk, smem, st>>>(f, g, K, fg, labels, rank, rowoff, gray,
                                    sums, bbox);
  HD_CHECK();
  k_bbox_sums<<<dim3(K, B), 256, 0, st>>>(f, g, K, nblobs, gray, bbox, bgsum);
  HD_CHECK();
  return 0;
}

// ------------------------------------------------- the one-pass preprocess
//
// hd_preprocess: one launch of k_preprocess, the tile preprocess of
// preprocess_tile.cuh, whose instances stop at a stage (kStop) and write
// the tile's gray (kGrayOut) or not.  hd_label's stages blur5, mean11 and
// pre run the instances <kBlur5|kMean11|kPre, false>; the main path's
// <kPre, true> holds no test of either.

template <int kStop, bool kGrayOut>
__global__ void __launch_bounds__(kPreThreads, 4)
k_preprocess(Frames f, int H, int W, Taps t, int ct, uint8_t* gray_out,
             uint8_t* binary, bool vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  int y0 = blockIdx.y * kPreTY, x0 = blockIdx.x * kPreTX;
  if (y0 >= 11 && x0 >= 11 && y0 + kPreTY + 11 <= H && x0 + kPreTX + 11 <= W)
    preprocess_tile<true, kStop, kGrayOut>(f, H, W, t, ct, gray_out, binary,
                                           smem, vec);
  else
    preprocess_tile<false, kStop, kGrayOut>(f, H, W, t, ct, gray_out, binary,
                                            smem, vec);
}

// One launch of k_preprocess<kStop, kGrayOut> over B frames.
template <int kStop, bool kGrayOut>
int launch_preprocess(const Frames& f, int B, int H, int W, const Taps& t,
                      int ct, uint8_t* gray, uint8_t* binary,
                      cudaStream_t st) {
  auto kernel = k_preprocess<kStop, kGrayOut>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPreSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kPreTX - 1) / kPreTX, (H + kPreTY - 1) / kPreTY, B);
  // planes whose rows start on 32-bit words (pixel stride 1, W and the
  // plane offsets multiples of 4, aligned bases) take word loads and stores
  bool vec = f.pstride == 1 && W % 4 == 0 && (uintptr_t)f.data % 4 == 0 &&
             (f.C == 1 || f.cstride % 4 == 0) && (uintptr_t)gray % 4 == 0 &&
             (uintptr_t)binary % 4 == 0;
  kernel<<<grid, kPreThreads, kPreSmem, st>>>(f, H, W, t, ct, gray, binary,
                                              vec);
  HD_CHECK();
  return 0;
}

}  // namespace

// The preprocess stages of hd_fused_detect alone, for frames of any size
// (the 2 MP routes take over from the closed mask): gray u8 [B, H, W] and
// the closed binary plane binary u8 [B, H, W] (0/1), in one launch
// (k_preprocess, above).  H, W >= 3.  Returns the first CUDA error.
extern "C" int hd_preprocess(const uint8_t* frames, int B, int H, int W,
                             int C, long long cstride, long long pstride,
                             int ct, const int* q8, const float* k11,
                             uint8_t* gray, uint8_t* binary, void* stream) {
  Frames f{frames, C, (long long)C * H * W, cstride, pstride};
  return launch_preprocess<kPre, true>(f, B, H, W, taps_of(q8, k11), ct, gray,
                                       binary, (cudaStream_t)stream);
}

// Runs the whole detect on `stream` (see the top of this file).  Scratch:
// gray and mask u8 [B, H, W] (the closed mask, filled in place), table
// int32 [B, hd_flood_entries(H, W)] (ccl_tiled.cu's; tile_uf.cuh's
// fill_geom), flags u8 [B, hd_label_tiles(H, W)] (the labels' tile flags),
// rank int32 [B, H, W], rowcnt/rowoff int32 [B, H]; labels int32 [B, H, W]
// is the output label plane.  sums and bgsum must be zeroed by the caller.
// Returns the first CUDA error (0 = none).
extern "C" int hd_fused_detect(
    const uint8_t* frames, int B, int H, int W, int C, long long cstride,
    long long pstride, int ct, int K, const int* q8, const float* k11,
    uint8_t* gray, uint8_t* mask, int32_t* table, uint8_t* flags,
    int32_t* rank, int32_t* labels, int32_t* rowcnt, int32_t* rowoff,
    int32_t* sums, int32_t* bbox, int32_t* bgsum, int32_t* nblobs,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = hd_preprocess(frames, B, H, W, C, cstride, pstride, ct, q8, k11,
                          gray, mask, stream);
  if (!err)
    err = launch_flood_fill(mask, B, H, W, nullptr, table, mask, st);
  LabelGeom lg = label_geom(H, W, H, 8, 1, nullptr);
  int tiles = lg.tx * lg.ty;
  lg = with_flags(lg, flags, tiles, tiles, 0);
  if (!err)
    err = launch_tile_labels<false>(mask, B, lg, labels, nullptr, nullptr,
                                    st);
  Geom g{H, W, (long long)H * W, H, 1};
  Frames f{frames, C, (long long)C * g.HW, cstride, pstride};
  if (!err) err = launch_stats(f, g, B, K, mask, labels, rank, rowcnt, rowoff,
                               gray, sums, bbox, bgsum, nblobs, st);
  return err;
}

// Tile flags a frame of H x W needs in hd_fused_detect: one a label tile.
extern "C" int hd_label_tiles(int H, int W) {
  LabelGeom lg = label_geom(H, W, H, 8, 1, nullptr);
  return lg.tx * lg.ty;
}

// Number of kernel launches one hd_fused_detect call makes on H x W frames:
// the preprocess, the fill and the labels (2 each, and a merge each when
// the frame has more than one tile), the stats (4).
extern "C" int hd_fused_detect_launches(int H, int W) {
  return hd_label_tiles(H, W) > 1 ? 11 : 9;
}

// ------------------------------------------------- the two-kernel split
//
// hd_label replaces the first kernel of the split of the fused Pallas
// kernel that heimdall_tpu's profiler runs (scripts/profile_fused.py):
// pallas_kernels.py::_make_label_kernel (frame -> label plane; the second,
// ::_make_stats_kernel, is stats_labels.cu's hd_stats_from_labels), and
// the profilers' truncations of the label kernel
// (scripts/profile_fused.py, scripts/profile_preprocess.py), which are
// hd_label's stages.  Both take BGR planes [B, 3, H, W]; B6b(frame) then
// B6a(frame, labels) gives the fused detect's outputs.  hd_label reaches
// each stage by hd_fused_detect's own kernels: gray by k_gray; blur5,
// mean11 and pre by one launch of the one-pass preprocess stopped at the
// stage; fill by pre, then the tile fill in place (tile_uf.cuh, 3
// launches, 2 for a frame of one tile); ccl by fill, then the foreground
// tile labels with one band of H rows (3 launches, 2 at one tile).  So it
// launches 1 kernel up to pre, 4 at fill and 7 at ccl.  What bounds it on
// an H100 SXM: it reads the frame (3 B/px) and writes one plane (1 B/px, 4
// B/px for the labels), and from mean11 on computes the mean's 44 float
// operations a pixel, which take longer than those bytes.

// Frame -> the plane of `stage`: gray, the Q8 blur5, the INV threshold of
// the f32 mean11 as 0/255, the opened and closed mask (0/1) or the
// hole-filled mask (0/1), each in `plane` u8 [B, H, W]; or the 8-connected
// labels (`labels` int32 [B, H, W], background H*W; `plane` then holds the
// filled mask).  Scratch from fill on: table int32 [B, hd_flood_entries(H,
// W)] (ccl_tiled.cu's); at ccl: flags u8 [B, hd_label_tiles(H, W)].
// Returns the first CUDA error.
extern "C" int hd_label(const uint8_t* frames, int B, int H, int W, int ct,
                        int stage, const int* q8, const float* k11,
                        int32_t* table, uint8_t* flags, uint8_t* plane,
                        int32_t* labels, void* stream) {
  if (stage < 0 || stage >= kNumStages) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Frames f{frames, 3, 3LL * H * W, (long long)H * W, 1};
  Taps t = taps_of(q8, k11);
  int err;
  switch (stage) {
    case kGray: {
      Geom g{H, W, (long long)H * W, H, 1};
      dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
      k_gray<<<grid, dim3(kTileW, kTileH), 0, st>>>(f, g, plane);
      HD_CHECK();
      return 0;
    }
    case kBlur5:
      return launch_preprocess<kBlur5, false>(f, B, H, W, t, ct, nullptr,
                                              plane, st);
    case kMean11:
      return launch_preprocess<kMean11, false>(f, B, H, W, t, ct, nullptr,
                                               plane, st);
    default:
      err = launch_preprocess<kPre, false>(f, B, H, W, t, ct, nullptr, plane,
                                           st);
  }
  if (!err && stage >= kFill)
    err = launch_flood_fill(plane, B, H, W, nullptr, table, plane, st);
  if (err || stage == kFill || stage == kPre) return err;
  int tiles = hd_label_tiles(H, W);
  LabelGeom lg = with_flags(label_geom(H, W, H, 8, 1, nullptr), flags, tiles,
                            tiles, 0);
  return launch_tile_labels<false>(plane, B, lg, labels, nullptr, nullptr,
                                   st);
}

// Number of kernel launches one hd_label call makes at `stage` on H x W
// frames: 1 up to pre; the fill and the labels 3 each (2 at one tile).
extern "C" int hd_label_launches(int stage, int H, int W) {
  if (stage < 0 || stage >= kNumStages) return 0;
  int per = hd_label_tiles(H, W) > 1 ? 3 : 2;
  return 1 + (stage >= kFill ? per : 0) + (stage >= kCcl ? per : 0);
}
