// The stats kernel from a label plane (B6a) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (heimdall_tpu_torch/ops/_cuda.py).
//
// Replaces heimdall_tpu/ops/pallas_kernels.py::_make_stats_kernel (frame +
// label plane -> the fused kernel's tables), the second half of the split
// of the fused Pallas kernel that heimdall_tpu's profiler runs
// (scripts/profile_fused.py:155).  Per frame: foreground is label != H*W; a
// root is a pixel whose label is its own linear index; the first K roots in
// raster order are the slots, and a pixel belongs to the slot of the root
// its label names, or to none if its label names no root or a root ranked
// K or later.  Outputs (the layout of contamination_pallas): sums i32
// [B,8,K] (ones, boundary, x, y, gray, b, g, r), bbox i32 [B,4,K] (x0, y1 ..
// inclusive; y0 is the root's row), bgsum i32 [B,4,K] (sums of gray, b, g,
// r over the bbox window), n i32 [B] (the exact root count); slots past
// min(n, K) are zero.
//
// What bounds it on an H100 SXM: bytes.  It must read the label plane (4
// B/px) and the frame's bytes of the pixels in a slot or a bbox window (3
// B/px of those), and write ~4 KB of tables a frame; at 640x480 with the
// bench's 9-10 small blobs a frame that is ~1.24 MB, 0.37 us at 3.35
// TB/s (0.64 us if every frame byte is counted).  Three launches, no plane
// of scratch (gray, foreground and ranks are never written), every output
// zeroed or initialised inside the kernels:
//   1. k_chunk_roots, a block per 8192-pixel chunk of a frame: the chunk's
//      labels in 16-byte loads, its roots by warp ballots (label == index)
//      in raster order, its root count and its first K roots in a list,
//      and a flag for each 128-pixel segment: whether it holds foreground
//      (scratch, hd_stats_scratch ints a frame); chunk 0's block also
//      zeroes the frame's sums and sets its bbox accumulators.
//   2. k_slot_sums, a warp per 128 x 32 strip of a frame: each block takes
//      the exclusive prefix of its frame's chunk counts and builds the
//      sorted slot table (the first K roots) in shared memory from the
//      chunks' lists; a warp streams its strip a row at a time (4 labels
//      a lane as one int4; the next row's labels and this row's frame
//      bytes in flight), the boundary test from the labels themselves
//      (the rows above and below in registers, the strip's edge columns
//      by shuffles and two loads), gray from the frame's bytes in
//      registers (the integer formula of common.cuh's gray_at).  A label
//      that is not in the slot table names no root or a root ranked K or
//      later: no gathers.  A lane adds its pixels into registers until its
//      slot changes; the warp then reduces per slot, the block adds per
//      slot in shared memory, and each block adds once per slot and
//      statistic to the outputs.  A strip's row is read only where one of
//      its two segments holds foreground, and frame bytes only for
//      foreground pixels.
//   3. k_window_sums, a block per frame: the used slots' bbox windows
//      walked a row a warp (rows numbered over the windows, row i to warp
//      i mod 16), 16-byte loads of the three planes with gray formed per
//      byte, one store of every bgsum of the frame.

#include "common.cuh"

namespace {

constexpr int kChunkPx = 8192;       // pass 1: a block's pixels
constexpr int kChunkThreads = 256;   // 8 warps x 1024 pixels
constexpr int kMaxChunks = 64;       // a frame of up to 524,288 pixels
constexpr int kStripW = 128;         // pass 2: a warp's columns (4 a lane)
constexpr int kStripRows = 32;       // pass 2: a warp's rows
constexpr int kSumWarps = 8;
constexpr int kWinThreads = 512;     // pass 3
constexpr int kWinWarps = kWinThreads / 32;

struct StatsGeom {
  int H, W, K, chunks;
  long long HW;
  // scratch of frame b: root counts [chunks], the chunks' root lists
  // [chunks][K], then a byte a 128-pixel segment of the frame (64 a chunk):
  // whether it holds foreground
  __host__ __device__ long long frame_ints() const {
    return (long long)chunks * (K + 1 + kChunkPx / 128 / 4);
  }
  __host__ __device__ long long lists() const { return chunks; }
  __host__ __device__ long long segs() const {
    return (long long)chunks * (K + 1);
  }
};

__device__ __forceinline__ int gray_of(int b, int g, int r) {
  return (b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15;
}

// ---------------------------------------------------------------- pass 1

// A lane's labels at p .. p + 3 of the n labels at L (a frame's plane or
// a row of it): one int4 (kVec: n % 4 == 0 and L 16-byte aligned), else
// four loads; labels past n read as the frame's background bg.  Addresses
// are clamped, so no load carries a predicate.
template <bool kVec>
__device__ __forceinline__ void load4(const int32_t* L, long long n,
                                      long long p, int bg, int v[4]) {
  if (kVec) {
    int4 q = *reinterpret_cast<const int4*>(L + min(p, n - 4));
    bool in = p < n;
    v[0] = in ? q.x : bg;
    v[1] = in ? q.y : bg;
    v[2] = in ? q.z : bg;
    v[3] = in ? q.w : bg;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int t = L[min(p + j, n - 1)];
      v[j] = p + j < n ? t : bg;
    }
  }
}

// A block per (chunk, frame): warp w takes pixels [1024 w, 1024 w + 1024)
// of the chunk, 128 a step, 4 a lane, all eight steps' loads in flight.
template <bool kVec>
__global__ void __launch_bounds__(kChunkThreads)
k_chunk_roots(StatsGeom g, const int32_t* labels, int32_t* scratch,
              int32_t* sums, int32_t* bbox) {
  __shared__ int s_warp[kChunkThreads / 32];
  const int c = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* L = labels + b * g.HW;
  int32_t* S = scratch + b * g.frame_ints();
  if (c == 0) {     // the frame's accumulators, before pass 2's atomics
    int32_t* gs = sums + (long long)b * 8 * g.K;
    int32_t* gb = bbox + (long long)b * 4 * g.K;
    for (int i = threadIdx.x; i < 8 * g.K; i += kChunkThreads) gs[i] = 0;
    for (int k = threadIdx.x; k < g.K; k += kChunkThreads) {
      gb[k] = 0x7fffffff;
      gb[g.K + k] = 0;
      gb[2 * g.K + k] = -1;
      gb[3 * g.K + k] = -1;
    }
  }
  const long long lo = (long long)c * kChunkPx + warp * 1024 + 4 * lane;
  int v[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    load4<kVec>(L, g.HW, lo + 128 * i, (int)g.HW, v[i]);
  unsigned roots[8];
  int mine = 0;
  uint8_t* seg = reinterpret_cast<uint8_t*>(S + g.segs()) +
                 (long long)c * (kChunkPx / 128) + warp * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    roots[i] = 0;
    bool fg = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      long long p = lo + 128 * i + j;
      bool in = v[i][j] != (int)g.HW;
      roots[i] |= (unsigned)(in && v[i][j] == p) << j;
      fg |= in;
    }
    mine += __popc(roots[i]);
    fg = __any_sync(kFull, fg);     // the step's 128 pixels: one segment
    if (lane == 0) seg[i] = fg;
  }
  int total_w = __reduce_add_sync(kFull, mine);
  if (lane == 0) s_warp[warp] = total_w;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kChunkThreads / 32; ++w) {
    int t = s_warp[w];
    before += w < warp ? t : 0;
    total += t;
  }
  if (total_w > 0 && before < g.K) {
    // raster order within the warp: step, then lane, then the lane's 4
    int rank = before;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int n = __popc(roots[i]), incl = n;
      for (int o = 1; o < 32; o <<= 1) {
        int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      int r = rank + incl - n;
      for (unsigned m = roots[i]; m; m &= m - 1, ++r)
        if (r < g.K)
          S[g.lists() + (long long)c * g.K + r] =
              (int32_t)(lo + 128 * i + __ffs(m) - 1);
      rank += __shfl_sync(kFull, incl, 31);
    }
  }
  if (threadIdx.x == 0) S[c] = total;
}

// ---------------------------------------------------------------- pass 2

struct Acc {
  int slot;              // -1: none yet
  int v[8];              // ones, boundary, x, y, gray, b, g, r
  int x0, x1, y1;
};

__device__ __forceinline__ void acc_reset(Acc& a, int slot) {
  a.slot = slot;
#pragma unroll
  for (int i = 0; i < 8; ++i) a.v[i] = 0;
  a.x0 = 0x7fffffff;
  a.x1 = -1;
  a.y1 = -1;
}

// Adds a lane's sums to the block's per-slot totals s in shared memory:
// the 8 sums [8][K], then x0, x1, y1 [K] each.
__device__ __forceinline__ void acc_flush(const Acc& a, int K, int* s) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (a.v[i]) atomicAdd(&s[i * K + a.slot], a.v[i]);
  atomicMin(&s[8 * K + a.slot], a.x0);
  atomicMax(&s[9 * K + a.slot], a.x1);
  atomicMax(&s[10 * K + a.slot], a.y1);
}

// A lane's four labels of row y (columns x .. x + 3), background where the
// row is not read (rows outside the frame or whose segments hold no
// foreground) or the column is past the frame.
template <bool kVec>
__device__ __forceinline__ void row_labels(const StatsGeom& g,
                                           const int32_t* L, int y, int x,
                                           bool read, int v[4]) {
  if (read) {
    load4<kVec>(L + (long long)y * g.W, g.W, x, (int)g.HW, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (int)g.HW;
  }
}

// A lane's 4 bytes of row y at column x in each plane (b, g, r), packed
// little-endian; read only where `read` (the lane has foreground there).
template <bool kVec>
__device__ __forceinline__ void row_bytes(const StatsGeom& g,
                                          const uint8_t* F, int y, int x,
                                          bool read, unsigned f[3]) {
  f[0] = f[1] = f[2] = 0;
  if (!read) return;
  long long o = (long long)y * g.W;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint8_t* row = F + c * g.HW + o;
    if (kVec) {
      f[c] = *reinterpret_cast<const unsigned*>(row + x);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[c] |= (unsigned)row[min(x + j, g.W - 1)] << (8 * j);
    }
  }
}

__device__ __forceinline__ unsigned fg_bits(const int v[4], int bg) {
  return (unsigned)(v[0] != bg) | (unsigned)(v[1] != bg) << 1 |
         (unsigned)(v[2] != bg) << 2 | (unsigned)(v[3] != bg) << 3;
}

template <bool kVec>
__global__ void __launch_bounds__(kSumWarps * 32)
k_slot_sums(StatsGeom g, const uint8_t* frames, const int32_t* labels,
            const int32_t* scratch, int32_t* sums, int32_t* bbox,
            int32_t* nblobs) {
  extern __shared__ int sm[];    // s_rl [K], then the totals [11][K]
  __shared__ int s_pre[kMaxChunks], s_cnt[kMaxChunks];
  // whether the block's strip of row y0 - 1 + t may hold foreground: one
  // of the two 128-pixel segments it falls in does (pass 1's flags)
  __shared__ bool s_rowfg[kSumWarps * kStripRows + 2];
  __shared__ int s_n;
  const int K = g.K, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nthr = kSumWarps * 32;
  int* s_rl = sm;
  int* s_tot = sm + K;
  const int32_t* S = scratch + b * g.frame_ints();
  if (warp == 0) {               // exclusive prefix of the chunk counts
    int run = 0;
    for (int c0 = 0; c0 < g.chunks; c0 += 32) {
      int c = c0 + lane;
      int n = c < g.chunks ? S[c] : 0, incl = n;
      for (int o = 1; o < 32; o <<= 1) {
        int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      if (c < g.chunks) {
        s_pre[c] = run + incl - n;
        s_cnt[c] = n;
      }
      run += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) s_n = run;
  }
  const int xb = blockIdx.x * kStripW;
  const int y0 = blockIdx.y * kSumWarps * kStripRows - 1;
  const uint8_t* seg = reinterpret_cast<const uint8_t*>(S + g.segs());
  for (int t = threadIdx.x; t < kSumWarps * kStripRows + 2; t += nthr) {
    int y = y0 + t;
    bool f = false;
    if (y >= 0 && y < g.H) {
      long long p = (long long)y * g.W + xb;
      f = seg[p >> 7] | seg[(p + min(kStripW, g.W - xb) - 1) >> 7];
    }
    s_rowfg[t] = f;
  }
  __syncthreads();
  const int n = s_n, used = min(n, K);
  for (int c = 0; c < g.chunks && s_pre[c] < used; ++c) {
    int pre = s_pre[c], take = min(s_cnt[c], used - pre);
    for (int j = threadIdx.x; j < take; j += nthr)
      s_rl[pre + j] = S[g.lists() + (long long)c * K + j];
  }
  for (int k = threadIdx.x; k < used; k += nthr) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s_tot[i * K + k] = 0;
    s_tot[8 * K + k] = 0x7fffffff;
    s_tot[9 * K + k] = -1;
    s_tot[10 * K + k] = -1;
  }
  __syncthreads();
  int32_t* gb = bbox + (long long)b * 4 * K;
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    if (threadIdx.x == 0) nblobs[b] = n;
    for (int k = threadIdx.x; k < K; k += nthr) {
      if (k < used) {
        gb[K + k] = s_rl[k] / g.W;     // y0: the root's row
      } else {
        gb[k] = gb[K + k] = gb[2 * K + k] = gb[3 * K + k] = 0;
      }
    }
  }
  if (used == 0) return;           // every thread: no slot in this frame

  const int bg = (int)g.HW;
  const int32_t* L = labels + b * g.HW;
  const uint8_t* F = frames + b * 3 * g.HW;
  const int x = xb + 4 * lane;
  // rows outside the frame are flagged false
  auto rowfg = [&](int y) { return s_rowfg[y - y0]; };
  const int ya = (blockIdx.y * kSumWarps + warp) * kStripRows;
  const int yb = min(ya + kStripRows, g.H);
  // the strip's edge columns: lane 0 the one left of it, lane 31 right
  const int ex = lane == 0 ? xb - 1 : xb + kStripW;
  const bool edge_lane = (lane == 0 || lane == 31) && ex >= 0 && ex < g.W;
  Acc a;
  acc_reset(a, -1);
  int last_lab = -1, last_slot = -1;
  if (ya < yb) {
    int cur[4], nxt[4], tmp[4];
    row_labels<kVec>(g, L, ya - 1, x, rowfg(ya - 1), tmp);
    unsigned up = fg_bits(tmp, bg);
    bool rc = rowfg(ya), rn = rowfg(ya + 1);
    row_labels<kVec>(g, L, ya, x, rc, cur);
    row_labels<kVec>(g, L, ya + 1, x, rn, nxt);
    int ecur = rc && edge_lane ? L[(long long)ya * g.W + ex] : bg;
    unsigned f[3];
    row_bytes<kVec>(g, F, ya, x, fg_bits(cur, bg) != 0, f);
    for (int y = ya; y < yb; ++y) {
      // the next rows in flight: labels of y + 2, bytes and edges of y + 1
      int nn[4], enext = bg;
      bool rnn = y + 2 <= yb && rowfg(y + 2);
      row_labels<kVec>(g, L, y + 2, x, rnn, nn);
      bool more = y + 1 < yb;
      if (more && rn && edge_lane) enext = L[(long long)(y + 1) * g.W + ex];
      unsigned fnext[3];
      row_bytes<kVec>(g, F, y + 1, x, more && fg_bits(nxt, bg) != 0, fnext);

      unsigned fc = fg_bits(cur, bg), fd = fg_bits(nxt, bg);
      if (__any_sync(kFull, fc != 0)) {
        unsigned left = __shfl_up_sync(kFull, fc, 1) >> 3 & 1u;
        unsigned right = __shfl_down_sync(kFull, fc, 1) & 1u;
        if (lane == 0) left = ecur != bg;
        if (lane == 31) right = ecur != bg;
        // neighbours of each of the 4 pixels, as bits: left, right
        unsigned nl = (fc << 1 | left) & 15u, nr = (fc >> 1 | right << 3);
        unsigned inner = nl & nr & up & fd;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!(fc >> j & 1u)) continue;
          int lab = cur[j];
          if (lab != last_lab) {
            last_lab = lab;
            last_slot = find_slot(s_rl, used, lab);
          }
          if (last_slot < 0) continue;
          if (last_slot != a.slot) {
            if (a.slot >= 0) acc_flush(a, K, s_tot);
            acc_reset(a, last_slot);
          }
          int px = x + j;
          bool bnd = !(inner >> j & 1u) || px == 0 || y == 0 ||
                     px == g.W - 1 || y == g.H - 1;
          int cb = f[0] >> (8 * j) & 255, cg = f[1] >> (8 * j) & 255;
          int cr = f[2] >> (8 * j) & 255;
          a.v[0] += 1;
          a.v[1] += bnd;
          a.v[2] += px;
          a.v[3] += y;
          a.v[4] += gray_of(cb, cg, cr);
          a.v[5] += cb;
          a.v[6] += cg;
          a.v[7] += cr;
          a.x0 = min(a.x0, px);
          a.x1 = max(a.x1, px);
          a.y1 = y;
        }
      }
      up = fc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cur[j] = nxt[j];
        nxt[j] = nn[j];
      }
      rn = rnn;
      ecur = enext;
      f[0] = fnext[0];
      f[1] = fnext[1];
      f[2] = fnext[2];
    }
  }
  // the warp's lanes flush by slot: one reduction a distinct slot
  for (unsigned todo = __ballot_sync(kFull, a.slot >= 0); todo;) {
    int s = __shfl_sync(kFull, a.slot, __ffs(todo) - 1);
    bool me = a.slot == s;
    int red[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      red[i] = __reduce_add_sync(kFull, me ? a.v[i] : 0);
    int x0 = __reduce_min_sync(kFull, me ? a.x0 : 0x7fffffff);
    int x1 = __reduce_max_sync(kFull, me ? a.x1 : -1);
    int y1 = __reduce_max_sync(kFull, me ? a.y1 : -1);
    if (me && lane == __ffs(todo) - 1) {
      Acc t = a;
#pragma unroll
      for (int i = 0; i < 8; ++i) t.v[i] = red[i];
      t.x0 = x0;
      t.x1 = x1;
      t.y1 = y1;
      acc_flush(t, K, s_tot);
    }
    todo &= ~__ballot_sync(kFull, me);
  }
  __syncthreads();
  int32_t* gs = sums + (long long)b * 8 * K;
  for (int k = threadIdx.x; k < used; k += nthr) {
    if (s_tot[k] == 0) continue;            // no pixel of slot k here
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (s_tot[i * K + k]) atomicAdd(&gs[i * K + k], s_tot[i * K + k]);
    atomicMin(&gb[k], s_tot[8 * K + k]);
    atomicMax(&gb[2 * K + k], s_tot[9 * K + k]);
    atomicMax(&gb[3 * K + k], s_tot[10 * K + k]);
  }
}

// ---------------------------------------------------------------- pass 3

__device__ __forceinline__ void add_px(unsigned cb, unsigned cg, unsigned cr,
                                       unsigned acc[4]) {
  acc[0] += gray_of(cb, cg, cr);
  acc[1] += cb;
  acc[2] += cg;
  acc[3] += cr;
}

// This lane's shares of the sums of gray, b, g, r over the n pixels of a
// row starting at plane pointer p (b at p, g at p + HW, r at p + 2 HW).
// kVec (HW % 16 == 0 and aligned planes, so the three planes share the
// alignment of p): a byte head up to the first 16-byte boundary (lanes
// 0-15), 16 bytes a lane of each plane as one uint4, a byte tail (lanes
// 16-31); else a byte a lane.  Head and tail loads read clamped in-row
// addresses, selected after.
template <bool kVec>
__device__ __forceinline__ void row_window(const uint8_t* p, long long HW,
                                           int n, int lane, unsigned acc[4]) {
  if (!kVec) {
    for (int i = lane; i < n; i += 32) add_px(p[i], p[i + HW], p[i + 2 * HW],
                                              acc);
    return;
  }
  int head = min((int)((16 - ((uintptr_t)p & 15)) & 15), n);
  int body = (n - head) >> 4;
  int tail = n - head - (body << 4);
  bool in_head = lane < head;
  bool in_tail = lane >= 16 && lane - 16 < tail;
  int i = in_head ? lane : in_tail ? n - tail + lane - 16 : 0;
  unsigned cb = p[i], cg = p[i + HW], cr = p[i + 2 * HW];
  if (in_head || in_tail) add_px(cb, cg, cr, acc);
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (int k = lane; k < body; k += 32) {
    uint4 qb = __ldg(v + k), qg = __ldg(v + (HW >> 4) + k),
          qr = __ldg(v + 2 * (HW >> 4) + k);
    unsigned b4[4] = {qb.x, qb.y, qb.z, qb.w};
    unsigned g4[4] = {qg.x, qg.y, qg.z, qg.w};
    unsigned r4[4] = {qr.x, qr.y, qr.z, qr.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      unsigned wb = b4[e], wg = g4[e], wr = r4[e];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[0] += gray_of(wb >> (8 * j) & 255, wg >> (8 * j) & 255,
                          wr >> (8 * j) & 255);
      acc[1] = __dp4a(wb, 0x01010101u, acc[1]);
      acc[2] = __dp4a(wg, 0x01010101u, acc[2]);
      acc[3] = __dp4a(wr, 0x01010101u, acc[3]);
    }
  }
}

// A block per frame: bgsum[b, c, k] over slot k's bbox window for k < min(n,
// K), 0 past it.  The windows' rows are numbered in slot order (32 slots at
// a time, a lane a slot) and row i goes to warp i mod kWinWarps; a warp
// adds its rows of a window in registers and reduces them once.
template <bool kVec>
__global__ void __launch_bounds__(kWinThreads)
k_window_sums(StatsGeom g, const uint8_t* frames, const int32_t* bbox,
              const int32_t* nblobs, int32_t* bgsum) {
  extern __shared__ int s_bg[];    // [4][K]
  const int K = g.K, b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned gw = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 4 * K; i += kWinThreads) s_bg[i] = 0;
  __syncthreads();
  const int used = min(nblobs[b], K);
  const int32_t* bb = bbox + (long long)b * 4 * K;
  const uint8_t* F = frames + b * 3 * g.HW;
  unsigned next = 0;                 // window rows numbered so far
  for (int k0 = 0; k0 < used; k0 += 32) {
    int k = k0 + lane, x0 = 0, y0 = 0, bw = 0;
    unsigned rows = 0;
    if (k < used) {
      x0 = bb[k];
      y0 = bb[K + k];
      bw = bb[2 * K + k] - x0 + 1;
      rows = bb[3 * K + k] - y0 + 1;
    }
    unsigned incl = rows;
    for (int d = 1; d < 32; d <<= 1) {
      unsigned t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    unsigned first = next + incl - rows;
    next += __shfl_sync(kFull, incl, 31);
    for (unsigned todo = __ballot_sync(kFull, rows > 0); todo;
         todo &= todo - 1) {
      int s = __ffs(todo) - 1;
      int ks = __shfl_sync(kFull, k, s), xs = __shfl_sync(kFull, x0, s);
      int ys = __shfl_sync(kFull, y0, s), ws = __shfl_sync(kFull, bw, s);
      unsigned nrows = __shfl_sync(kFull, rows, s);
      unsigned i0 = (gw - __shfl_sync(kFull, first, s)) % kWinWarps;
      if (i0 >= nrows) continue;       // none of this window's rows
      unsigned acc[4] = {0, 0, 0, 0};
      for (unsigned i = i0; i < nrows; i += kWinWarps)
        row_window<kVec>(F + (long long)(ys + (int)i) * g.W + xs, g.HW, ws,
                         lane, acc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        unsigned t = __reduce_add_sync(kFull, acc[c]);
        if (lane == 0) atomicAdd(&s_bg[c * K + ks], (int)t);
      }
    }
  }
  __syncthreads();
  int32_t* out = bgsum + (long long)b * 4 * K;
  for (int i = threadIdx.x; i < 4 * K; i += kWinThreads) out[i] = s_bg[i];
}

inline StatsGeom stats_geom(int H, int W, int K) {
  long long HW = (long long)H * W;
  return StatsGeom{H, W, K, (int)((HW + kChunkPx - 1) / kChunkPx), HW};
}

// Raises a kernel's dynamic shared memory limit where its static and
// dynamic shared memory may pass the default 48 KB.
template <typename Kernel>
int smem_limit(Kernel kernel, size_t bytes) {
  if (bytes <= 40 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Scratch int32 a frame of H x W at K slots needs in hd_stats_from_labels.
extern "C" int hd_stats_scratch(int H, int W, int K) {
  return (int)stats_geom(H, W, K).frame_ints();
}

// frames u8 [B, 3, H, W] (BGR planes) and labels int32 [B, H, W] (values in
// [0, H*W]) -> sums [B,8,K], bbox [B,4,K], bgsum [B,4,K], nblobs [B], every
// element written (see the top of this file).  scratch: int32 [B,
// hd_stats_scratch(H, W, K)].  H, W >= 3, H * W <= 64 * 8192, 1 <= K <=
// 1024.  Three launches; returns the first CUDA error.
extern "C" int hd_stats_from_labels(const uint8_t* frames, int B, int H,
                                    int W, int K, const int32_t* labels,
                                    int32_t* scratch, int32_t* sums,
                                    int32_t* bbox, int32_t* bgsum,
                                    int32_t* nblobs, void* stream) {
  StatsGeom g = stats_geom(H, W, K);
  if (H < 3 || W < 3 || K < 1 || K > kMaxSlots || g.chunks > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  bool lab16 = (uintptr_t)labels % 16 == 0;
  if (g.HW % 4 == 0 && lab16)
    k_chunk_roots<true><<<dim3(g.chunks, B), kChunkThreads, 0, st>>>(
        g, labels, scratch, sums, bbox);
  else
    k_chunk_roots<false><<<dim3(g.chunks, B), kChunkThreads, 0, st>>>(
        g, labels, scratch, sums, bbox);
  HD_CHECK();

  size_t smem = (size_t)12 * K * sizeof(int);
  dim3 grid((W + kStripW - 1) / kStripW,
            (H + kSumWarps * kStripRows - 1) / (kSumWarps * kStripRows), B);
  bool vec = W % 4 == 0 && lab16 && (uintptr_t)frames % 4 == 0;
  int err = smem_limit(vec ? k_slot_sums<true> : k_slot_sums<false>, smem);
  if (err) return err;
  if (vec)
    k_slot_sums<true><<<grid, kSumWarps * 32, smem, st>>>(
        g, frames, labels, scratch, sums, bbox, nblobs);
  else
    k_slot_sums<false><<<grid, kSumWarps * 32, smem, st>>>(
        g, frames, labels, scratch, sums, bbox, nblobs);
  HD_CHECK();

  size_t wsmem = (size_t)4 * K * sizeof(int);
  if (g.HW % 16 == 0 && (uintptr_t)frames % 16 == 0)
    k_window_sums<true><<<B, kWinThreads, wsmem, st>>>(g, frames, bbox,
                                                       nblobs, bgsum);
  else
    k_window_sums<false><<<B, kWinThreads, wsmem, st>>>(g, frames, bbox,
                                                        nblobs, bgsum);
  HD_CHECK();
  return 0;
}

// Number of kernel launches one hd_stats_from_labels call makes.
extern "C" int hd_stats_from_labels_launches() { return 3; }
