// Per-blob statistics of the band-tiled route for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (heimdall_tpu_torch/ops/_cuda.py).
//
// Replaces, in heimdall_tpu/ops/stats_tiled.py:
//   B4a  _make_banded_stats_kernel (launched by blob_stats_tiled):
//        hd_banded_stats — per-slot sums of ones, boundary, x, y, gray and,
//        with color, b, g, r (int32 [B, 8, K]; the color rows stay 0
//        without color) and the inclusive bbox (int32 [B, 4, K]: x0, y0,
//        x1, y1; unused slots hold W, H, -1, -1);
//   B4b  _make_bbox_sum_kernel (launched by _bbox_sums_banded):
//        hd_bbox_sums — per-slot sums of gray (and b, g, r) over the bbox
//        window (int32 [B, 4, K]), walking only the (slot, band) pairs of
//        the slot-incidence lists.
//
// A pixel belongs to slot k iff its label equals root_table[k] (ascending),
// found by binary search in shared memory.  The boundary plane is computed
// here from the mask (4 neighbours, the frame edge counting as background)
// instead of being read.  Sums are exact int32 atomics, reduced per warp
// (__reduce_*_sync) when a warp's lanes share a slot and per block in shared
// memory before one global atomic per touched slot, so results do not
// depend on the order of execution; like the TPU kernel they accumulate in
// int32 (the caller guards H * W*(W-1)/2 < 2^31).
//
// What bounds them on an H100 SXM: bytes.  B4a reads labels, mask and gray
// (6 B/px; 9 with color), about 3.7 us (5.6) per 1920x1080 frame at
// 3.35 TB/s.  B4b reads only the bbox windows of the blobs (C bytes per
// window pixel), which is tiny on production frames.

#include "common.cuh"

namespace {

constexpr int kStatsRows = 64;    // rows per block in the stats kernel

__global__ void k_stats_init(int H, int W, int K, int32_t* sums,
                             int32_t* bbox) {
  int b = blockIdx.x;
  int32_t* s = sums + (long long)b * 8 * K;
  int32_t* bb = bbox + (long long)b * 4 * K;
  for (int i = threadIdx.x; i < 8 * K; i += blockDim.x) s[i] = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    bb[k] = W;
    bb[K + k] = H;
    bb[2 * K + k] = -1;
    bb[3 * K + k] = -1;
  }
}

__global__ void k_banded_stats(Frames f, Geom g, int K, const uint8_t* mask,
                               const int32_t* labels, const int32_t* rl,
                               const int32_t* nblobs, const uint8_t* gray,
                               int32_t* sums, int32_t* bbox) {
  extern __shared__ int sm[];
  int* s_rl = sm;                // [K]
  int* s_sum = s_rl + K;         // [8][K]
  int* s_x0 = s_sum + 8 * K;     // [K] each
  int* s_y0 = s_x0 + K;
  int* s_x1 = s_y0 + K;
  int* s_y1 = s_x1 + K;
  int b = blockIdx.z;
  int tid = threadIdx.y * blockDim.x + threadIdx.x;
  int nthr = blockDim.x * blockDim.y;
  int n = min(nblobs[b], K);
  for (int i = tid; i < 8 * K; i += nthr) s_sum[i] = 0;
  for (int k = tid; k < K; k += nthr) {
    s_rl[k] = rl[(long long)b * K + k];
    s_x0[k] = 0x7fffffff;
    s_y0[k] = 0x7fffffff;
    s_x1[k] = -1;
    s_y1[k] = -1;
  }
  __syncthreads();

  long long base = b * g.HW;
  const uint8_t* m = mask + base;
  int x = blockIdx.x * kTileW + threadIdx.x;
  int lane = threadIdx.x;
  for (int r = 0; r < kStatsRows; r += kTileH) {
    int y = blockIdx.y * kStatsRows + r + threadIdx.y;
    bool in = x < g.W && y < g.H;
    long long p = (long long)y * g.W + x;
    int slot = -1;
    int v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (in) {
      int lab = labels[base + p];
      if (lab != g.HW) slot = find_slot(s_rl, n, lab);
    }
    if (slot >= 0) {
      bool bnd = x == 0 || y == 0 || x == g.W - 1 || y == g.H - 1 ||
                 !m[p - 1] || !m[p + 1] || !m[p - g.W] || !m[p + g.W];
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
    }
    int s0 = __shfl_sync(kFull, slot, 0);
    if (__all_sync(kFull, slot == s0)) {
      if (s0 >= 0) {
        int red[8];
        for (int i = 0; i < 8; ++i) red[i] = __reduce_add_sync(kFull, v[i]);
        int xmin = __reduce_min_sync(kFull, x);
        int xmax = __reduce_max_sync(kFull, x);
        if (lane == 0) {
          for (int i = 0; i < 8; ++i)
            if (red[i]) atomicAdd(&s_sum[i * K + s0], red[i]);
          atomicMin(&s_x0[s0], xmin);
          atomicMax(&s_x1[s0], xmax);
          atomicMin(&s_y0[s0], y);   // one row per warp
          atomicMax(&s_y1[s0], y);
        }
      }
    } else if (slot >= 0) {
      for (int i = 0; i < 8; ++i)
        if (v[i]) atomicAdd(&s_sum[i * K + slot], v[i]);
      atomicMin(&s_x0[slot], x);
      atomicMax(&s_x1[slot], x);
      atomicMin(&s_y0[slot], y);
      atomicMax(&s_y1[slot], y);
    }
  }
  __syncthreads();

  int32_t* gs = sums + (long long)b * 8 * K;
  int32_t* gb = bbox + (long long)b * 4 * K;
  for (int k = tid; k < n; k += nthr) {
    if (s_sum[k] == 0) continue;
    for (int i = 0; i < 8; ++i)
      if (s_sum[i * K + k]) atomicAdd(&gs[i * K + k], s_sum[i * K + k]);
    atomicMin(&gb[k], s_x0[k]);
    atomicMin(&gb[K + k], s_y0[k]);
    atomicMax(&gb[2 * K + k], s_x1[k]);
    atomicMax(&gb[3 * K + k], s_y1[k]);
  }
}

// One block per (list position, band, frame): the bbox window of slot
// slot_list[b, r, t] restricted to band r's rows, added to out[b, :, k].
__global__ void k_bbox_sums(Frames f, Geom g, int K, const int32_t* bbox,
                            const int32_t* slot_list,
                            const int32_t* slot_count, const uint8_t* gray,
                            int32_t* out) {
  int t = blockIdx.x, r = blockIdx.y, b = blockIdx.z;
  long long br = (long long)b * g.R + r;
  if (t >= min(slot_count[br], K)) return;
  int k = slot_list[br * K + t];
  const int32_t* bb = bbox + (long long)b * 4 * K;
  int x0 = bb[k], x1 = bb[2 * K + k];
  int y0 = max(bb[K + k], r * g.band);
  int y1 = min(bb[3 * K + k], min((r + 1) * g.band, g.H) - 1);
  if (y0 > y1 || x0 > x1) return;
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
  int32_t* o = out + (long long)b * 4 * K;
  for (int c = 0; c < (f.C == 3 ? 4 : 1); ++c) {
    int s = block_sum(acc[c]);
    if (threadIdx.x == 0 && s) atomicAdd(&o[c * K + k], s);
  }
}

}  // namespace

// labels int32 [B, H, W] (background H*W), mask u8 [B, H, W] (0/1), gray u8
// [B, H, W], color (C = 3) or none (C = 1), root table int32 [B, K]
// (ascending, padded with H*W), nblobs int32 [B] -> sums int32 [B, 8, K],
// bbox int32 [B, 4, K].  K <= 1024.
extern "C" int hd_banded_stats(const uint8_t* color, int C, long long fstride,
                               long long cstride, long long pstride, int B,
                               int H, int W, int K, const uint8_t* mask,
                               const int32_t* labels, const int32_t* rl,
                               const int32_t* nblobs, const uint8_t* gray,
                               int32_t* sums, int32_t* bbox, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Geom g{H, W, (long long)H * W, H, 1};
  Frames f{color, C, fstride, cstride, pstride};
  k_stats_init<<<B, kScanThreads, 0, st>>>(H, W, K, sums, bbox);
  HD_CHECK();
  size_t smem = (size_t)13 * K * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k_banded_stats, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + kTileW - 1) / kTileW, (H + kStatsRows - 1) / kStatsRows, B);
  k_banded_stats<<<grid, dim3(kTileW, kTileH), smem, st>>>(
      f, g, K, mask, labels, rl, nblobs, gray, sums, bbox);
  HD_CHECK();
  return 0;
}

// bbox int32 [B, 4, K] (from hd_banded_stats), slot_list int32 [B, R, K],
// slot_count int32 [B, R] with R = ceil(H / band), gray u8 [B, H, W], color
// or none -> out int32 [B, 4, K], which the caller zeroes (rows 1-3 stay 0
// without color).
extern "C" int hd_bbox_sums(const uint8_t* color, int C, long long fstride,
                            long long cstride, long long pstride, int B,
                            int H, int W, int band, int K,
                            const int32_t* bbox, const int32_t* slot_list,
                            const int32_t* slot_count, const uint8_t* gray,
                            int32_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int R = (H + band - 1) / band;
  Geom g{H, W, (long long)H * W, band, R};
  Frames f{color, C, fstride, cstride, pstride};
  k_bbox_sums<<<dim3(K, R, B), kScanThreads, 0, st>>>(
      f, g, K, bbox, slot_list, slot_count, gray, out);
  HD_CHECK();
  return 0;
}
