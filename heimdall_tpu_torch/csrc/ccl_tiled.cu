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
// row row_off.  The border is the frame's (tile_uf.cuh, "hole fill"): its
// first and last rows only where the shard holds them, and a background
// pixel of a cut row joins it when the halo pixel across the cut is
// reached.  The halos are the neighbouring shards' edge rows of ~filled
// from the previous round; the caller repeats rounds until no shard's edge
// rows change (one word all-reduced on the host a round), as the JAX
// package repeats its banded rounds.  Within a round the shard is solved
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
// row is the frame's.  Scratch and outputs as in hd_flood_fill.
extern "C" int hd_flood_fill_sp(const uint8_t* mask, int B, int H, int W,
                                int row_off, int Hg, const uint8_t* halo_top,
                                const uint8_t* halo_bot, const int* active,
                                int32_t* table, uint8_t* filled,
                                void* stream) {
  return launch_flood_fill(mask, B, H, W, active, table, filled,
                           (cudaStream_t)stream, row_off, Hg, halo_top,
                           halo_bot);
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
