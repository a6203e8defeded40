// Band-tiled hole fill and labeling for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (heimdall_tpu_torch/ops/_cuda.py).
//
// Replaces, in heimdall_tpu/ops/ccl_tiled.py:
//   B5b  _make_flood_kernel (launched by fill_holes_tiled) and the XLA round
//        loop around it: hd_flood_fill;
//   B5a  _make_band_ccl_kernel (launched by _band_ccl_call): hd_band_ccl;
//   the interface merge (_merge_with_roots, _compact_incidence; XLA work
//        between the band kernels): hd_merge_bands.
// and, in heimdall_tpu/parallel/tiled_sp.py, the same builders launched on a
// shard of a frame's rows (one rank's rows on a multi-device mesh):
//   B5b-sp  the flood of fill_holes_tiled_sp (:127): hd_flood_fill_sp;
//   B5a-sp  _band_ccl_call(emit_edges=True, to_fixpoint=True) of
//           connected_components_tiled_sp (:214): hd_band_ccl_sp.
//
// hd_flood_fill: filled = mask | (background not 4-connected to the frame
// border).  The JAX package floods bands to local fixpoints and repeats whole
// rounds until one changes nothing, which needs a host-visible flag per
// round.  Here a block union-find answers it in 3 launches with no rounds
// and no host sync, whatever the depth of a maze in the mask: tiles labelled
// in shared memory, then only their perimeter components merged through a
// small per-frame table (tile_uf.cuh, "hole fill").
//
// hd_band_ccl: 8- (or 4-) connected labels within each band of `band` rows
// (links never cross a band's first row), as global linear indices whose
// value is the band-local component's minimum; background H*W.  Also the
// band root tables [B, R, cap]: the band's first `cap` roots in raster order,
// padded with H*W, and the exact root count [B, R].  The TPU kernel's edge
// rows are not produced: the merge reads the rows beside each band boundary
// from the label plane itself.  The same block union-find as the fill's,
// on the foreground (tile_uf.cuh, "foreground labels"): each label written
// once by its tile, components joined across tile edges in the label plane
// and only theirs rewritten; the root tables then read each band only from
// its first root to its cap-th (k_band_roots).  4 launches.
//
// hd_flood_fill_sp: hd_flood_fill on a shard of H of a frame's Hg rows from
// row row_off.  The border is the frame's: its first and last rows only
// where the shard holds them, and a background pixel of a cut row joins it
// when the halo pixel across the cut is reached.  One launch on a
// thread-block cluster a frame-shard, the shard held as bits in the
// blocks' shared memory and flooded by bit-parallel row and column passes
// ("shard fill" below); shards too large for a cluster take the tile
// union-find of hd_flood_fill (tile_uf.cuh, "hole fill").  The halos are
// the neighbouring shards' edge rows of ~filled from the previous round;
// the caller repeats rounds until no shard's edge rows change (one word
// all-reduced on the host a round), as the JAX package repeats its banded
// rounds.  Within a round the shard is solved
// whole, so the rounds count only the corridors' crossings of cut rows.
//
// hd_band_ccl_sp: hd_band_ccl with the frame's indices on a shard: every
// label and root is the shard-local index plus `base` (the shard's first
// pixel in the frame), and the background is `bg` (the frame's Hg*W), so
// the labels need no pass to be made global.  The edge rows of the TPU
// kernel are rows of the label plane (the caller slices them).
//
// hd_merge_bands: unites band-local components across band boundaries with
// the same union-find on the label plane (a label is a parent pointer whose
// root is itself), flattens every label to its root (the whole-frame
// minimum linear index, as ops/ccl.py gives), then builds the root table
// [B, K] (first K roots in raster order, padded with H*W) and n_blobs from
// the band tables minus the roots the merge hooked away, and the exact
// per-band slot incidence (slot_list [B, R, K]: present slot ids ascending,
// then the absent ones ascending; slot_count [B, R]).  A band with more
// roots than its table holds is scanned pixel by pixel instead.
//
// Each entry point takes an optional `active` (int32 [B]): frames whose flag
// is 0 are skipped and their outputs left unwritten, so that the run-table
// route (runtable_tiled.cu) falls back to these kernels per frame with no
// host sync.
//
// What bounds them on an H100 SXM: bytes.  The fill reads the mask and
// writes the filled plane (2 B/px), the labeling reads the mask and writes
// int32 labels (5 B/px), the merge reads and writes labels (8 B/px): about
// 0.6, 3.1 and 5.0 us per 1920x1080 frame at 3.35 TB/s.  The fill reads
// the mask twice (tile pass and write pass), so its design floor is 3
// B/px; the labeling meets its bound's bytes in its tile pass and adds
// the labels of the tiles that hold foreground read back, the rewrites of
// components that cross tile edges, and its root scans.  The fill's table
// and the labels' root pointers stay in the 50 MB L2.  The merge passes
// through label planes in device memory and does not approach its bound.

#include <cooperative_groups.h>

#include "tile_uf.cuh"

namespace {

// ------------------------------------------------------ band-local labels
// (the tile labeling itself, launch_tile_labels, is in tile_uf.cuh)

// Writes, in raster order, the roots among pixels [lo, hi) of L to
// out[rank] where rank < limit, until it has found `stop` of them: a warp
// takes 1024 pixels a step (32 coalesced loads a lane, then a ballot of
// roots for each 32 of them), the block 8192, with one block scan a step.
// Returns the count found (in every thread).
__device__ int scan_roots(const int32_t* L, long long lo, long long hi,
                          int32_t* out, int limit, int stop) {
  __shared__ int warp_n[kScanThreads / 32];
  constexpr int kSeg = 1024, kStep = kSeg * (kScanThreads / 32);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n = 0;
  for (long long c0 = lo; c0 < hi && n < stop; c0 += kStep) {
    long long seg = c0 + (long long)warp * kSeg;
    int v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      long long p = seg + i * 32 + lane;
      v[i] = p < hi ? L[p] : -1;
    }
    uint32_t word = 0;                     // lane j: the roots of row j
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      uint32_t w = __ballot_sync(kFull, v[i] == seg + i * 32 + lane);
      if (lane == i) word = w;
    }
    int cnt = __popc(word), incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_n[warp] = incl;
    __syncthreads();
    int before = n, total = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) {
      int t = warp_n[w];
      if (w < warp) before += t;
      total += t;
    }
    __syncthreads();                       // warp_n is reused next step
    int rank = before + incl - cnt;
    for (; word; word &= word - 1) {
      if (rank < limit) out[rank] = (int32_t)(seg + lane * 32 + __ffs(word) - 1);
      ++rank;
    }
    n += total;
  }
  return n;
}

// One block per (band, frame): the band's root table, from its exact root
// count and first root (k_label_write; the first root in slot 0 of the
// table): the band is scanned from its first root only until the table's
// roots are found, so a band with no root reads nothing.
// Labels and roots are the plane's indices plus base (the plane is indexed
// by label through a pointer moved back by base), the background bg.
__global__ void k_band_roots(Geom g, int cap, int base, int bg,
                             const int32_t* labels, int32_t* roots,
                             const int32_t* counts) {
  int r = blockIdx.x, b = blockIdx.y;
  if (frame_skipped(g, b)) return;
  int32_t* tab = roots + ((long long)b * g.R + r) * cap;
  int first = tab[0], need = min(counts[b * g.R + r], cap);
  __syncthreads();                         // every thread has read slot 0
  int n = need > 0 ? scan_roots(labels + b * g.HW - base, first,
                                base + band_hi(g, r), tab, cap, need)
                   : 0;
  for (int j = n + threadIdx.x; j < cap; j += blockDim.x) tab[j] = bg;
}

// ------------------------------------------------------------------ merge

// One thread per (column, band boundary, frame): unite the first row of
// band r + 1 with its neighbours in the last row of band r.
__global__ void k_merge_link(Geom g, int conn, int32_t* labels) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = (blockIdx.y + 1) * g.band;
  if (x >= g.W || frame_skipped(g, blockIdx.z)) return;
  int32_t* P = labels + blockIdx.z * g.HW;
  int p = y * g.W + x, u = p - g.W;
  if (P[p] == g.HW) return;
  bool up = P[u] != g.HW;
  if (up) {
    unite(P, p, u);
    return;
  }
  if (conn == 4) return;
  if (x > 0 && P[u - 1] != g.HW) unite(P, p, u - 1);
  if (x < g.W - 1 && P[u + 1] != g.HW) unite(P, p, u + 1);
}

__global__ void k_merge_flatten(Geom g, int32_t* labels) {
  for_each_tile(g, [&](Pix q) {
    if (!q.in) return;
    int32_t* P = labels + q.b * g.HW;
    if (P[q.p] != g.HW) P[q.p] = find_root(P, (int)q.p);
  });
}

// One block per frame: the first K merged roots in raster order, and the
// root count.  A band root survives the merge iff it is still its own
// label; bands whose table overflowed are scanned instead.
__global__ void k_root_table(Geom g, int K, int cap, const int32_t* labels,
                             const int32_t* roots, const int32_t* counts,
                             int32_t* rl, int32_t* nblobs) {
  int b = blockIdx.x;
  if (frame_skipped(g, b)) return;
  const int32_t* L = labels + b * g.HW;
  int32_t* out = rl + (long long)b * K;
  int n = 0;
  for (int r = 0; r < g.R; ++r) {
    int cnt = counts[b * g.R + r];
    if (cnt > cap) {
      n += scan_roots(L, band_lo(g, r), band_hi(g, r), out + n, K - n, cnt);
      continue;
    }
    const int32_t* tab = roots + ((long long)b * g.R + r) * cap;
    for (int j0 = 0; j0 < cnt; j0 += blockDim.x) {
      int j = j0 + threadIdx.x;
      int root = j < cnt ? tab[j] : 0;
      bool keep = j < cnt && L[root] == root;
      int total;
      int rank = n + block_exclusive_scan(keep ? 1 : 0, &total);
      if (keep && rank < K) out[rank] = root;
      n += total;
    }
  }
  for (int k = n + threadIdx.x; k < K; k += blockDim.x) out[k] = (int)g.HW;
  if (threadIdx.x == 0) nblobs[b] = n;
}

// One block per (band, frame): which slots of the root table have a pixel
// in the band.  Every pixel's band-local label is a root of its band's
// table, so the table's merged labels are the band's labels.
__global__ void k_incidence(Geom g, int K, int cap, const int32_t* labels,
                            const int32_t* roots, const int32_t* counts,
                            const int32_t* rl, const int32_t* nblobs,
                            int32_t* slot_list, int32_t* slot_count) {
  __shared__ int s_rl[kMaxSlots];
  __shared__ int s_pres[kMaxSlots];
  int r = blockIdx.x, b = blockIdx.y;
  if (frame_skipped(g, b)) return;
  const int32_t* L = labels + b * g.HW;
  int n = min(nblobs[b], K);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_rl[k] = rl[(long long)b * K + k];
    s_pres[k] = 0;
  }
  __syncthreads();
  int cnt = counts[b * g.R + r];
  if (cnt <= cap) {
    const int32_t* tab = roots + ((long long)b * g.R + r) * cap;
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      int k = find_slot(s_rl, n, L[tab[j]]);
      if (k >= 0) s_pres[k] = 1;
    }
  } else {
    for (long long p = band_lo(g, r) + threadIdx.x; p < band_hi(g, r);
         p += blockDim.x) {
      int v = L[p];
      if (v == g.HW) continue;
      int k = find_slot(s_rl, n, v);
      if (k >= 0) s_pres[k] = 1;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    write_slot_list(s_pres, K, slot_list + ((long long)b * g.R + r) * K,
                    slot_count + b * g.R + r);
}

// ------------------------------------------------------------ shard fill
//
// hd_flood_fill_sp's design: one launch, a thread-block cluster of C <= 16
// blocks a frame-shard.  A shard call holds about one frame's pixels ([4,
// 270, 1920] on the multi-device path), so the union-find's three
// dependent launches of 32 x 128 tiles take a tile's latency each, not
// their pixels' time (its bound: the mask read and the filled plane
// written, 2 B/px).  Here block c holds rows [c H / C, (c + 1) H / C) of
// the shard as bits in shared memory (background and reached, a 32-bit
// word per 32 columns) and floods the background from the border to its
// fixpoint with bit-parallel passes:
//   row pass     a warp a row: each background run that holds a reached
//                bit becomes reached, by carries: ((bg + s) ^ bg) & bg | s
//                fills from each seed toward higher columns, the same on
//                the bit-reversed row toward lower ones; the carries
//                between the lanes' words come from two ballots (a
//                carry-lookahead add of generate and propagate bits);
//   column pass  a thread a word column: reached bits move down, then up,
//                through background bits, 32 columns at a time.
// The passes alternate until a column pass changes no word (every row is
// closed after a row pass).  Then each block stores its edge rows into its
// neighbours' shared memory (remote stores, a word a thread; a load
// through the cluster's window costs far more) and meets them at a cluster
// barrier: a background bit of a block's first or last row under a reached
// bit of its neighbour's becomes reached.  Each block stores its gain into
// every block's shared memory the same way, behind a second barrier; the
// rounds end when no block gains a bit.  The seeds are the frame's border
// (columns 0 and W - 1, and the frame's first and last rows where the
// shard holds them) and, on a cut row, the background under a reached halo
// pixel.  The mask is read and the filled plane written once, 16 bytes a
// load or store.  Shards wider than 4096 columns, or too tall for the
// cluster's shared memory, take the tile union-find (launch_fill<true>).

namespace cg = cooperative_groups;

constexpr int kShardThreads = 1024;     // a warp a row of up to 32 rows
constexpr int kShardWarps = kShardThreads / 32;
constexpr int kShardBlocks = 16;        // a cluster, at most
constexpr int kShardMaxWords = 128;     // words a row: W <= 4096

struct ShardGeom {
  int H, W, nw;         // the shard's rows and columns, words a row
  int C, rows;          // blocks a shard, rows a block at most
  int row_off, Hg;      // the shard's first row in the frame, frame rows
  const uint8_t* halo_top;
  const uint8_t* halo_bot;
  const int* active;
};

inline ShardGeom shard_geom(int H, int W, int row_off, int Hg,
                            const uint8_t* halo_top, const uint8_t* halo_bot,
                            const int* active) {
  int C = min(kShardBlocks, H);
  return ShardGeom{H, W, (W + 31) / 32, C, (H + C - 1) / C, row_off, Hg,
                   halo_top, halo_bot, active};
}

inline size_t shard_smem(const ShardGeom& g) {
  return ((size_t)2 * g.rows * g.nw + 2 * g.nw + 1) * sizeof(unsigned);
}

__device__ __forceinline__ int shard_row0(const ShardGeom& g, int c) {
  return (int)((long long)c * g.H / g.C);
}

// Bits of the 32 bytes of a row at columns x .. x + 31 (bit k: byte x + k
// nonzero); columns past W read 0.  kVec (W % 32 == 0, 16-byte aligned
// rows): two uint4 loads.
template <bool kVec>
__device__ __forceinline__ unsigned byte_bits(const uint8_t* row, int x,
                                              int W) {
  unsigned bits = 0;
  if (kVec) {
    const uint4* p = reinterpret_cast<const uint4*>(row + x);
    uint4 lo = p[0], hi = p[1];
    unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      unsigned m = __vcmpne4(w[k], 0u) & 0x01010101u;
      bits |= (m * 0x10204080u) >> 28 << (4 * k);   // 4 bytes -> 4 bits
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      uint8_t v = row[min(x + k, W - 1)];
      bits |= (unsigned)(x + k < W && v != 0) << k;
    }
  }
  return bits;
}

// The bits of f as 32 bytes 0/1 at columns x .. x + 31 of a row (columns
// past W not written).
template <bool kVec>
__device__ __forceinline__ void bits_bytes(unsigned f, uint8_t* row, int x,
                                           int W) {
  if (kVec) {
    unsigned w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)      // 4 bits -> 4 bytes
      w[k] = (f >> (4 * k) & 15u) * 0x00204081u & 0x01010101u;
    uint4* p = reinterpret_cast<uint4*>(row + x);
    p[0] = make_uint4(w[0], w[1], w[2], w[3]);
    p[1] = make_uint4(w[4], w[5], w[6], w[7]);
  } else {
    for (int k = 0; k < 32 && x + k < W; ++k) row[x + k] = f >> k & 1u;
  }
}

// t = bg + s + cin over a lane's N words (word 0 lowest); returns the
// carry out.
template <int N>
__device__ __forceinline__ unsigned add_words(const unsigned* bg,
                                              const unsigned* s,
                                              unsigned cin, unsigned* t) {
  unsigned c = cin;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    unsigned long long v = (unsigned long long)bg[i] + s[i] + c;
    t[i] = (unsigned)v;
    c = (unsigned)(v >> 32);
  }
  return c;
}

// The run fill toward higher columns over the warp's row: lane l holds
// words l N .. l N + N - 1.  The carry into each lane: G (a lane's add
// carries out by itself) and P (it passes a carry on: all background, no
// seed) as ballots, in the lanes' order of `rev` (false: lane l at bit l;
// true: at bit 31 - l), then the carries of (G | P) + G.
template <int N>
__device__ __forceinline__ void fill_up(const unsigned* bg, unsigned* s,
                                        bool pass, bool rev) {
  int lane = threadIdx.x & 31;
  unsigned t[N];
  unsigned g = __ballot_sync(kFull, add_words<N>(bg, s, 0u, t));
  unsigned p = __ballot_sync(kFull, pass);
  if (rev) {
    g = __brev(g);
    p = __brev(p);
  }
  unsigned x = g | p, carry = (x + g) ^ x ^ g;
  add_words<N>(bg, s, carry >> (rev ? 31 - lane : lane) & 1u, t);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] |= (t[i] ^ bg[i]) & bg[i];
}

// s := the background runs of the row that hold a bit of s (s within bg).
template <int N>
__device__ __forceinline__ void run_fill(const unsigned* bg, unsigned* s) {
  bool pass = true;
#pragma unroll
  for (int i = 0; i < N; ++i) pass &= bg[i] == ~0u && s[i] == 0u;
  unsigned up[N], rb[N], rs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    up[i] = s[i];
    rb[i] = __brev(bg[N - 1 - i]);     // the row reversed: lanes, words, bits
    rs[i] = __brev(s[N - 1 - i]);
  }
  fill_up<N>(bg, up, pass, false);
  fill_up<N>(rb, rs, pass, true);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = up[i] | __brev(rs[N - 1 - i]);
}

// The row pass over the block's rows, a warp a row.
template <int N>
__device__ void row_pass(const ShardGeom& g, const unsigned* BG, unsigned* R,
                         int rows) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int y = warp; y < rows; y += kShardWarps) {
    unsigned bg[N], s[N], was[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int j = lane * N + i;
      bool in = j < g.nw;
      bg[i] = in ? BG[y * g.nw + j] : 0u;
      s[i] = was[i] = in ? R[y * g.nw + j] : 0u;
    }
    run_fill<N>(bg, s);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int j = lane * N + i;
      if (j < g.nw && s[i] != was[i]) R[y * g.nw + j] = s[i];
    }
  }
}

// The column pass, a thread a word column: down the block's rows, then up,
// kColChunk rows at a time (their words loaded together, then the chain
// through them in registers); whether a word changed.
constexpr int kColChunk = 8;

__device__ bool column_pass(const ShardGeom& g, const unsigned* BG,
                            unsigned* R, int rows) {
  bool ch = false;
  for (int j = threadIdx.x; j < g.nw; j += kShardThreads) {
    unsigned prev = 0u;
    for (int y0 = 0; y0 < rows; y0 += kColChunk) {
      unsigned r[kColChunk], bg[kColChunk];
#pragma unroll
      for (int k = 0; k < kColChunk; ++k) {
        int i = min(y0 + k, rows - 1) * g.nw + j;
        r[k] = R[i];
        bg[k] = BG[i];
      }
#pragma unroll
      for (int k = 0; k < kColChunk; ++k) {
        unsigned v = r[k] | (prev & bg[k]);
        if (y0 + k < rows && v != r[k]) {
          R[(y0 + k) * g.nw + j] = v;
          ch = true;
        }
        prev = v;
      }
    }
    prev = 0u;
    for (int y0 = rows - 1; y0 >= 0; y0 -= kColChunk) {
      unsigned r[kColChunk], bg[kColChunk];
#pragma unroll
      for (int k = 0; k < kColChunk; ++k) {
        int i = max(y0 - k, 0) * g.nw + j;
        r[k] = R[i];
        bg[k] = BG[i];
      }
#pragma unroll
      for (int k = 0; k < kColChunk; ++k) {
        unsigned v = r[k] | (prev & bg[k]);
        if (y0 - k >= 0 && v != r[k]) {
          R[(y0 - k) * g.nw + j] = v;
          ch = true;
        }
        prev = v;
      }
    }
  }
  return ch;
}

template <int N, bool kVec>
__global__ void __launch_bounds__(kShardThreads, 1)
k_fill_shard(ShardGeom g, const uint8_t* mask, uint8_t* filled) {
  extern __shared__ __align__(16) unsigned s_bits[];
  __shared__ int s_gain[kShardBlocks];     // each block's gain of a round
  cg::cluster_group cl = cg::this_cluster();
  const int c = blockIdx.x, b = blockIdx.y;
  if (g.active != nullptr && g.active[b] == 0) return;   // the whole cluster
  const int r0 = shard_row0(g, c), rows = shard_row0(g, c + 1) - r0;
  const int cells = rows * g.nw;
  unsigned* BG = s_bits;                     // [rows][nw]: background
  unsigned* R = BG + g.rows * g.nw;          // [rows][nw]: reached
  unsigned* top = R + g.rows * g.nw;         // the last row of block c - 1
  unsigned* bot = top + g.nw;                // the first row of block c + 1
  const long long plane = (long long)b * g.H * g.W;
  // every block of the cluster runs before one stores into another's
  // shared memory: arrive now, wait before the first store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  bool started = false;

  for (int i = threadIdx.x; i < cells; i += kShardThreads) {
    int y = i / g.nw, j = i - y * g.nw, x = 32 * j;
    unsigned valid = g.W - x >= 32 ? ~0u : (1u << (g.W - x)) - 1u;
    unsigned bg = ~byte_bits<kVec>(mask + plane + (long long)(r0 + y) * g.W,
                                   x, g.W) & valid;
    int gy = g.row_off + r0 + y;
    unsigned s = gy == 0 || gy == g.Hg - 1 ? bg : 0u;   // the frame's edges
    if (j == 0) s |= bg & 1u;
    if (j == g.nw - 1) s |= bg & (1u << ((g.W - 1) & 31));
    if (r0 + y == 0 && g.halo_top != nullptr)           // across the cuts
      s |= bg & byte_bits<kVec>(g.halo_top + (long long)b * g.W, x, g.W);
    if (r0 + y == g.H - 1 && g.halo_bot != nullptr)
      s |= bg & byte_bits<kVec>(g.halo_bot + (long long)b * g.W, x, g.W);
    BG[i] = bg;
    R[i] = s;
  }
  __syncthreads();

  // The filled plane of the block's rows, from BG and R.
  auto store = [&]() {
    for (int i = threadIdx.x; i < cells; i += kShardThreads) {
      int y = i / g.nw, j = i - y * g.nw;
      bits_bytes<kVec>(~(BG[i] & R[i]),
                       filled + plane + (long long)(r0 + y) * g.W, 32 * j,
                       g.W);
    }
  };
  bool gain = true, stored = false;
  while (true) {
    // The block's fixpoint: after a row pass every row is closed, so a
    // column pass that changes nothing ends it.  A block that gained no
    // bit from its neighbours is at its fixpoint already.
    for (bool ch = gain; ch;) {
      row_pass<N>(g, BG, R, rows);
      __syncthreads();
      ch = __syncthreads_or(column_pass(g, BG, R, rows));
    }
    // Each block stores its edge rows into its neighbours' shared memory
    // (remote stores, no remote load), then its gain into every block's.
    if (!started) {
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
      started = true;
    }
    for (int j = threadIdx.x; j < g.nw; j += kShardThreads) {
      if (c < g.C - 1)
        cl.map_shared_rank(top, c + 1)[j] = R[(rows - 1) * g.nw + j];
      if (c > 0) cl.map_shared_rank(bot, c - 1)[j] = R[j];
    }
    cl.sync();
    gain = false;
    for (int j = threadIdx.x; j < g.nw; j += kShardThreads) {
      int last = (rows - 1) * g.nw + j;
      unsigned v = c > 0 ? BG[j] & top[j] & ~R[j] : 0u;
      R[j] |= v;
      unsigned w = c < g.C - 1 ? BG[last] & bot[j] & ~R[last] : 0u;
      R[last] |= w;
      gain |= (v | w) != 0u;
    }
    gain = __syncthreads_or(gain);
    if (threadIdx.x < g.C)
      *cl.map_shared_rank(&s_gain[c], threadIdx.x) = gain;
    // A block that gained nothing stores its rows between its arrival at
    // the cluster barrier and its wait (after the arrival, so that the
    // barrier's release does not wait for them); it stores them again
    // only if a later round changes them.
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    if (!gain && !stored) store();
    stored = !gain;
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if (!__syncthreads_or(threadIdx.x < g.C && s_gain[threadIdx.x])) break;
  }
  if (!stored) store();
}

// Whether the shard fill of H x W shards runs on a cluster (k_fill_shard):
// W <= 4096 and a block's rows fit its shared memory.
inline int shard_cluster_fits(const ShardGeom& g, bool* fits) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  *fits = g.nw <= kShardMaxWords && shard_smem(g) <= (size_t)optin;
  return 0;
}

template <int N, bool kVec>
int launch_fill_shard(const ShardGeom& g, int B, const uint8_t* mask,
                      uint8_t* filled, cudaStream_t st) {
  auto kernel = k_fill_shard<N, kVec>;
  size_t smem = shard_smem(g);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && g.C > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.C, B);
  cfg.blockDim = dim3(kShardThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, g, mask, filled);
  if (e != cudaSuccess) return (int)e;
  HD_CHECK();
  return 0;
}

template <bool kVec>
int launch_fill_shard(const ShardGeom& g, int B, const uint8_t* mask,
                      uint8_t* filled, cudaStream_t st) {
  if (g.nw <= 32) return launch_fill_shard<1, kVec>(g, B, mask, filled, st);
  if (g.nw <= 64) return launch_fill_shard<2, kVec>(g, B, mask, filled, st);
  return launch_fill_shard<4, kVec>(g, B, mask, filled, st);
}

}  // namespace

// Entries of hd_flood_fill's table per frame.
extern "C" int hd_flood_entries(int H, int W) {
  return (int)fill_geom(H, W, nullptr).E;
}

// mask u8 [B, H, W] (nonzero = foreground) -> filled u8 [B, H, W] (0/1).
// Scratch: table int32 [B, hd_flood_entries(H, W)].  active: null, or
// int32 [B] (frames with 0 are skipped).  Returns the first CUDA error.
extern "C" int hd_flood_fill(const uint8_t* mask, int B, int H, int W,
                             const int* active, int32_t* table,
                             uint8_t* filled, void* stream) {
  return launch_flood_fill(mask, B, H, W, active, table, filled,
                           (cudaStream_t)stream);
}

// hd_flood_fill on a shard: mask u8 [B, H, W] holds rows row_off .. row_off
// + H - 1 of frames of Hg rows; halo_top / halo_bot u8 [B, W] (nonzero =
// reached) the rows across the shard's first / last row, null where that
// row is the frame's.  One launch of k_fill_shard where
// hd_flood_fill_sp_cluster(H, W) is 1 (table may then be null), else the
// tile union-find with table int32 [B, hd_flood_entries(H, W)] as
// hd_flood_fill's.  active as in hd_flood_fill.  Returns the first CUDA
// error.
extern "C" int hd_flood_fill_sp(const uint8_t* mask, int B, int H, int W,
                                int row_off, int Hg, const uint8_t* halo_top,
                                const uint8_t* halo_bot, const int* active,
                                int32_t* table, uint8_t* filled,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ShardGeom g = shard_geom(H, W, row_off, Hg, halo_top, halo_bot, active);
  bool fits = false;
  int err = shard_cluster_fits(g, &fits);
  if (err) return err;
  if (!fits)
    return launch_flood_fill(mask, B, H, W, active, table, filled, st,
                             row_off, Hg, halo_top, halo_bot);
  if (B == 0) return 0;
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  bool vec = W % 32 == 0 && aligned(mask) && aligned(filled) &&
             (halo_top == nullptr || aligned(halo_top)) &&
             (halo_bot == nullptr || aligned(halo_bot));
  return vec ? launch_fill_shard<true>(g, B, mask, filled, st)
             : launch_fill_shard<false>(g, B, mask, filled, st);
}

// 1 where hd_flood_fill_sp runs H x W shards on a cluster (one launch), 0
// where it takes the tile union-find (3 launches, 2 at one tile), minus a
// CUDA error.
extern "C" int hd_flood_fill_sp_cluster(int H, int W) {
  bool fits = false;
  int err = shard_cluster_fits(
      shard_geom(H, W, 0, H, nullptr, nullptr, nullptr), &fits);
  return err ? -err : (int)fits;
}

static int band_ccl(const uint8_t* mask, int B, int H, int W, int band,
                    int conn, int cap, int base, int bg, const int* active,
                    int32_t* labels, int32_t* roots, int32_t* counts,
                    cudaStream_t st) {
  LabelGeom lg = label_geom(H, W, band, conn, cap, active);
  lg.base = base;
  lg.bg = bg;
  // the tile flags in the root tables' slots 1 .. cap - 1, which
  // k_band_roots overwrites after the write pass, when they fit
  int chunk = (cap - 1) * 4;
  if (chunk > 0 && (lg.tx * lg.ty + chunk - 1) / chunk <= lg.R)
    lg = with_flags(lg, reinterpret_cast<uint8_t*>(roots + 1),
                    (long long)lg.R * cap * 4, chunk, cap * 4);
  int err = launch_tile_labels<true>(mask, B, lg, labels, roots, counts, st);
  if (err) return err;
  Geom g{H, W, (long long)H * W, band, lg.R, active};
  k_band_roots<<<dim3(lg.R, B), kScanThreads, 0, st>>>(g, cap, base, bg,
                                                       labels, roots, counts);
  HD_CHECK();
  return 0;
}

// mask u8 [B, H, W] -> band-local labels int32 [B, H, W], band roots int32
// [B, R, cap], counts int32 [B, R], with R = ceil(H / band); active as in
// hd_flood_fill.  Four launches: the tile labeling (3), then the root
// tables.
extern "C" int hd_band_ccl(const uint8_t* mask, int B, int H, int W,
                           int band, int conn, int cap, const int* active,
                           int32_t* labels, int32_t* roots, int32_t* counts,
                           void* stream) {
  return band_ccl(mask, B, H, W, band, conn, cap, 0, H * W, active, labels,
                  roots, counts, (cudaStream_t)stream);
}

// hd_band_ccl on a shard: labels and roots are the shard's indices plus
// base, the background and the roots' padding bg.
extern "C" int hd_band_ccl_sp(const uint8_t* mask, int B, int H, int W,
                              int band, int conn, int cap, int base, int bg,
                              const int* active, int32_t* labels,
                              int32_t* roots, int32_t* counts, void* stream) {
  return band_ccl(mask, B, H, W, band, conn, cap, base, bg, active, labels,
                  roots, counts, (cudaStream_t)stream);
}

// Merges hd_band_ccl's outputs in place (labels) and writes rl int32
// [B, K], nblobs int32 [B], slot_list int32 [B, R, K], slot_count int32
// [B, R].  K <= kMaxSlots; active as in hd_flood_fill.
extern "C" int hd_merge_bands(int B, int H, int W, int band, int conn,
                              int cap, int K, const int* active,
                              int32_t* labels, const int32_t* roots,
                              const int32_t* counts, int32_t* rl,
                              int32_t* nblobs, int32_t* slot_list,
                              int32_t* slot_count, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int R = (H + band - 1) / band;
  Geom g{H, W, (long long)H * W, band, R, active};
  if (R > 1) {
    k_merge_link<<<dim3((W + 255) / 256, R - 1, B), 256, 0, st>>>(g, conn,
                                                                  labels);
    HD_CHECK();
    dim3 blk(kTileW, kTileH);
    k_merge_flatten<<<tile_grid(g, B), blk, 0, st>>>(g, labels);
    HD_CHECK();
  }
  k_root_table<<<B, kScanThreads, 0, st>>>(g, K, cap, labels, roots, counts,
                                           rl, nblobs);
  HD_CHECK();
  k_incidence<<<dim3(R, B), kScanThreads, 0, st>>>(
      g, K, cap, labels, roots, counts, rl, nblobs, slot_list, slot_count);
  HD_CHECK();
  return 0;
}
