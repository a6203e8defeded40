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
// and, in heimdall_tpu/parallel/tiled_sp.py, B4a launched on a shard of a
// frame's rows (one rank's rows on a multi-device mesh):
//   B4a-sp  _make_banded_stats_kernel of blob_stats_tiled_sp (:352):
//           hd_banded_stats_sp — labels in the frame's indices (background
//           the frame's Hg*W), and the boundary across the shard's cut rows
//           read from the neighbours' edge rows of the mask (halo rows),
//           the frame's edge still background.  Its row sums and bbox stay
//           in the shard's rows; the caller moves them to the frame's and
//           reduces them over the shards.  B4b needs no entry of its own:
//           its window walk clamps a bbox given in the shard's rows to the
//           shard's bands.
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
// window pixel), which is tiny on production frames: there one launch's
// fixed cost bounds it.  So B4b's grid does not grow with K or the bands
// (a block a frame finds its listed pairs on the card), it stores its
// outputs itself (no zero fill before it), and a large window's rows are
// dealt out to the block's 32 warps, each walking a row with 16-byte loads
// and 32-bit column offsets.  A frame's windows are read by one SM, so a
// window over the whole frame goes at one SM's rate (about 64 GB/s on an
// H100, PERF.md), under the card's.

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

// Labels equal to bg are background; with kHalo, halo_top / halo_bot (u8
// [B, W], or null for the frame's edge) are the mask rows across the
// plane's first and last row (a template parameter, so that whole frames
// take the plain boundary test).
template <bool kHalo>
__global__ void k_banded_stats(Frames f, Geom g, int K, int bg,
                               const uint8_t* halo_top,
                               const uint8_t* halo_bot, const uint8_t* mask,
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
      if (lab != bg) slot = find_slot(s_rl, n, lab);
    }
    if (slot >= 0) {
      bool bnd;
      if (!kHalo) {
        bnd = x == 0 || y == 0 || x == g.W - 1 || y == g.H - 1 ||
              !m[p - 1] || !m[p + 1] || !m[p - g.W] || !m[p + g.W];
      } else {
        bnd = x == 0 || x == g.W - 1 || !m[p - 1] || !m[p + 1];
        if (!bnd) {
          const uint8_t* hu =
              halo_top ? halo_top + (long long)b * g.W : nullptr;
          const uint8_t* hd =
              halo_bot ? halo_bot + (long long)b * g.W : nullptr;
          bool up = y > 0 ? m[p - g.W] != 0 : hu != nullptr && hu[x] != 0;
          bool dn =
              y < g.H - 1 ? m[p + g.W] != 0 : hd != nullptr && hd[x] != 0;
          bnd = !up || !dn;
        }
      }
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

// B4b's launch: one block of kBoxThreads per frame, at most 64 registers a
// thread, so that a batch of up to 132 frames runs in one wave; its
// kBoxWarps warps share the frame's window rows.
constexpr int kBoxThreads = 1024;
constexpr int kBoxWarps = kBoxThreads / 32;

// Asks L2 for the 128-byte lines of the n bytes at p (a lane a line).
__device__ __forceinline__ void prefetch_row(const uint8_t* p, int n,
                                             int lane) {
  uintptr_t base = (uintptr_t)p & ~(uintptr_t)127;
  int lines = (int)(((uintptr_t)p & 127) + n + 127) >> 7;
  for (int l = lane; l < lines; l += 32)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + 128 * l));
}

// This lane's shares of the sums of the n bytes of one row in each of NP
// planes (p[c]): a byte head up to the plane's first 16-byte boundary
// (lanes 0-15), then 16 bytes a lane as one uint4, the planes' loads
// issued together and added by __dp4a, then a byte tail (lanes 16-31).
// No load carries a predicate (a clamped index, the value selected
// after), so that a lane has all of its head, tail and 2 x NP body loads
// (4 for one plane) in flight at once.
template <int NP>
__device__ __forceinline__ void row_sums(const uint8_t* const* p, int n,
                                         int lane, unsigned* acc) {
  const uint4* v[NP];
  int body[NP], most = 0;
#pragma unroll
  for (int c = 0; c < NP; ++c) {
    int head = min((int)((16 - ((uintptr_t)p[c] & 15)) & 15), n);
    body[c] = (n - head) >> 4;
    int tail = n - head - (body[c] << 4);
    bool in_head = lane < head;
    bool in_tail = lane >= 16 && lane - 16 < tail;
    unsigned e = p[c][in_head ? lane : in_tail ? n - tail + lane - 16 : 0];
    acc[c] += in_head || in_tail ? e : 0;
    // with no body, the aligned 16 bytes that hold p[c] (inside the plane)
    v[c] = reinterpret_cast<const uint4*>(
        body[c] ? p[c] + head : p[c] - ((uintptr_t)p[c] & 15));
    most = max(most, body[c]);
  }
#pragma unroll (NP == 1 ? 4 : 2)
  for (int i = lane; i < most; i += 32) {
    uint4 q[NP];
#pragma unroll
    for (int c = 0; c < NP; ++c)
      q[c] = __ldg(v[c] + min(i, max(body[c] - 1, 0)));
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (i >= body[c]) q[c] = make_uint4(0, 0, 0, 0);
      acc[c] = __dp4a(q[c].x, 0x01010101u, acc[c]);
      acc[c] = __dp4a(q[c].y, 0x01010101u, acc[c]);
      acc[c] = __dp4a(q[c].z, 0x01010101u, acc[c]);
      acc[c] = __dp4a(q[c].w, 0x01010101u, acc[c]);
    }
  }
}

// A block per frame: out[b, c, k] = the sum of plane c (gray, then b, g,
// r) over slot k's bbox window within each band r that lists k, added over
// those bands; rows 1-3 are 0 without color.
//
// Every warp walks the frame's listed (band, slot) pairs itself, 32 at a
// time: the band counts of 32 bands in one load a lane, then a lane per
// listed pair (its band found by a binary search over the counts' warp
// scan) loads its slot and bbox, so the lists cost three dependent loads
// per 32 pairs, not two per band.  The window rows of the pairs are
// numbered in list order and row i goes to warp i mod kBoxWarps, so a
// window over many bands and a run of small windows both spread over all
// of them.  A warp sums its row by row_sums (interleaved color a pixel a
// lane), asking L2 for its next row meanwhile, reduces it with
// __reduce_add_sync and adds it to the block's sums in shared memory,
// which the block then stores: every output written once, no zero fill.
__global__ void __launch_bounds__(kBoxThreads, 1)
    k_bbox_sums(Frames f, Geom g, int K, const int32_t* bbox,
                const int32_t* slot_list, const int32_t* slot_count,
                const uint8_t* gray, int32_t* out) {
  extern __shared__ int s_sum[];     // [nc][K]: the frame's sums
  const int nc = f.C == 3 ? 4 : 1;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned gw = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < nc * K; i += blockDim.x) s_sum[i] = 0;
  __syncthreads();

  const int32_t* bb = bbox + (long long)b * 4 * K;
  const int32_t* sc = slot_count + (long long)b * g.R;
  const int32_t* sl = slot_list + (long long)b * g.R * K;
  const uint8_t* gf = gray + b * g.HW;
  const uint8_t* cf = f.C == 3 ? f.data + b * f.fstride : nullptr;
  unsigned next = 0;   // window rows numbered so far (mod 2^32)
  for (int r0 = 0; r0 < g.R; r0 += 32) {
    int nr = r0 + lane < g.R ? min(sc[r0 + lane], K) : 0;
    int upto = nr;     // pairs listed in bands r0 .. r0 + lane
    for (int d = 1; d < 32; d <<= 1) {
      int v = __shfl_up_sync(kFull, upto, d);
      if (lane >= d) upto += v;
    }
    int pairs = __shfl_sync(kFull, upto, 31);
    for (int p0 = 0; p0 < pairs; p0 += 32) {
      int p = p0 + lane, j = 0;  // j: the first band lane with upto > p
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFull, upto, j + step - 1) <= p) j += step;
      int t = p - __shfl_sync(kFull, upto, j) + __shfl_sync(kFull, nr, j);
      int k = 0, x0 = 0, y0 = 0, bw = 0;
      unsigned rows = 0;
      if (p < pairs) {
        int r = r0 + j, top = r * g.band;
        k = sl[(long long)r * K + t];
        x0 = bb[k];
        int x1 = bb[2 * K + k];
        y0 = max(bb[K + k], top);
        int y1 = min(bb[3 * K + k], min(top + g.band, g.H) - 1);
        if (y0 <= y1 && x0 <= x1) {
          rows = y1 - y0 + 1;
          bw = x1 - x0 + 1;
        }
      }
      unsigned incl = rows;            // rows of this lane's and earlier
      for (int d = 1; d < 32; d <<= 1) {
        unsigned v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      unsigned first = next + incl - rows;
      next += __shfl_sync(kFull, incl, 31);
      for (unsigned todo = __ballot_sync(kFull, rows > 0); todo;
           todo &= todo - 1) {
        int s = __ffs(todo) - 1;
        int ks = __shfl_sync(kFull, k, s), xs = __shfl_sync(kFull, x0, s);
        int ys = __shfl_sync(kFull, y0, s), ws = __shfl_sync(kFull, bw, s);
        unsigned nrows = __shfl_sync(kFull, rows, s);
        unsigned i0 = (gw - __shfl_sync(kFull, first, s)) % kBoxWarps;
        if (i0 >= nrows) continue;     // none of this window's rows
        unsigned acc[4] = {0, 0, 0, 0};
        for (unsigned i = i0; i < nrows; i += kBoxWarps) {
          long long o = (long long)(ys + (int)i) * g.W + xs;
          if (i + kBoxWarps < nrows) {   // this warp's next row, into L2
            long long on = o + (long long)kBoxWarps * g.W;
            prefetch_row(gf + on, ws, lane);
            if (f.C == 3 && f.pstride == 1) {
              for (int c = 0; c < 3; ++c)
                prefetch_row(cf + on + c * f.cstride, ws, lane);
            } else if (f.C == 3) {
              prefetch_row(cf + on * f.pstride, (int)f.pstride * ws, lane);
            }
          }
          if (f.C != 3) {
            const uint8_t* q[1] = {gf + o};
            row_sums<1>(q, ws, lane, acc);
          } else if (f.pstride == 1) {
            const uint8_t* d = cf + o;
            const uint8_t* q[4] = {gf + o, d, d + f.cstride,
                                   d + 2 * f.cstride};
            row_sums<4>(q, ws, lane, acc);
          } else {
            const uint8_t* q[1] = {gf + o};
            row_sums<1>(q, ws, lane, acc);
            const uint8_t* d = cf + o * f.pstride;
            for (int x = lane; x < ws; x += 32) {
              const uint8_t* e = d + x * (int)f.pstride;
              acc[1] += e[0];
              acc[2] += e[f.cstride];
              acc[3] += e[2 * f.cstride];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c == nc) break;
          unsigned v = __reduce_add_sync(kFull, acc[c]);
          if (lane == 0 && v) atomicAdd(&s_sum[c * K + ks], (int)v);
        }
      }
    }
  }
  __syncthreads();
  int32_t* o = out + (long long)b * 4 * K;
  for (int i = threadIdx.x; i < 4 * K; i += blockDim.x)
    o[i] = i < nc * K ? s_sum[i] : 0;
}

}  // namespace

static int banded_stats(const uint8_t* color, int C, long long fstride,
                        long long cstride, long long pstride, int B, int H,
                        int W, int K, int bg, const uint8_t* mask,
                        const int32_t* labels, const int32_t* rl,
                        const int32_t* nblobs, const uint8_t* gray,
                        const uint8_t* halo_top, const uint8_t* halo_bot,
                        int32_t* sums, int32_t* bbox, cudaStream_t st) {
  Geom g{H, W, (long long)H * W, H, 1};
  Frames f{color, C, fstride, cstride, pstride};
  k_stats_init<<<B, kScanThreads, 0, st>>>(H, W, K, sums, bbox);
  HD_CHECK();
  auto kernel = halo_top != nullptr || halo_bot != nullptr
                    ? k_banded_stats<true>
                    : k_banded_stats<false>;
  size_t smem = (size_t)13 * K * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + kTileW - 1) / kTileW, (H + kStatsRows - 1) / kStatsRows, B);
  kernel<<<grid, dim3(kTileW, kTileH), smem, st>>>(
      f, g, K, bg, halo_top, halo_bot, mask, labels, rl, nblobs, gray, sums,
      bbox);
  HD_CHECK();
  return 0;
}

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
  return banded_stats(color, C, fstride, cstride, pstride, B, H, W, K, H * W,
                      mask, labels, rl, nblobs, gray, nullptr, nullptr, sums,
                      bbox, (cudaStream_t)stream);
}

// hd_banded_stats on a shard of a frame's rows: labels and the root table
// in the frame's indices, background bg; halo_top / halo_bot u8 [B, W] the
// mask rows across the shard's first / last row (null at the frame's edge).
// Sums and bbox in the shard's rows (unused slots: W, H, -1, -1).
extern "C" int hd_banded_stats_sp(const uint8_t* color, int C,
                                  long long fstride, long long cstride,
                                  long long pstride, int B, int H, int W,
                                  int K, int bg, const uint8_t* mask,
                                  const int32_t* labels, const int32_t* rl,
                                  const int32_t* nblobs, const uint8_t* gray,
                                  const uint8_t* halo_top,
                                  const uint8_t* halo_bot, int32_t* sums,
                                  int32_t* bbox, void* stream) {
  return banded_stats(color, C, fstride, cstride, pstride, B, H, W, K, bg,
                      mask, labels, rl, nblobs, gray, halo_top, halo_bot,
                      sums, bbox, (cudaStream_t)stream);
}

// bbox int32 [B, 4, K] (from hd_banded_stats), slot_list int32 [B, R, K],
// slot_count int32 [B, R] with R = ceil(H / band), gray u8 [B, H, W], color
// or none -> out int32 [B, 4, K], every element written (rows 1-3 are 0
// without color).  K <= kMaxSlots.
extern "C" int hd_bbox_sums(const uint8_t* color, int C, long long fstride,
                            long long cstride, long long pstride, int B,
                            int H, int W, int band, int K,
                            const int32_t* bbox, const int32_t* slot_list,
                            const int32_t* slot_count, const uint8_t* gray,
                            int32_t* out, void* stream) {
  if (B == 0) return 0;
  int R = (H + band - 1) / band;
  Geom g{H, W, (long long)H * W, band, R};
  Frames f{color, C, fstride, cstride, pstride};
  k_bbox_sums<<<B, kBoxThreads, (size_t)(C == 3 ? 4 : 1) * K * sizeof(int),
                (cudaStream_t)stream>>>(f, g, K, bbox, slot_list, slot_count,
                                        gray, out);
  HD_CHECK();
  return 0;
}
