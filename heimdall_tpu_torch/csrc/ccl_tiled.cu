// Band-tiled hole fill and labeling for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (heimdall_tpu_torch/ops/_cuda.py).
//
// Replaces, in heimdall_tpu/ops/ccl_tiled.py:
//   B5b  _make_flood_kernel (launched by fill_holes_tiled) and the XLA round
//        loop around it: hd_flood_fill;
//   B5a  _make_band_ccl_kernel (launched by _band_ccl_call): hd_band_ccl;
//   the interface merge (_merge_with_roots, _compact_incidence; XLA work
//        between the band kernels): hd_merge_bands.
//
// hd_flood_fill: filled = mask | (background not 4-connected to the frame
// border).  The JAX package floods bands to local fixpoints and repeats whole
// rounds until one changes nothing, which needs a host-visible flag per
// round.  Here the exterior comes from one background union-find over the
// whole frame (parents start at the pixel's same-class run start within its
// warp, one ballot; atomicMin hooking), then each root that touches the
// border marks its tree: 4 launches, no rounds, no host sync.
//
// hd_band_ccl: 8- (or 4-) connected labels within each band of `band` rows
// (links never cross a band's first row), as global linear indices whose
// value is the band-local component's minimum; background H*W.  Also the
// band root tables [B, R, cap]: the band's first `cap` roots in raster order,
// padded with H*W, and the exact root count [B, R].  The TPU kernel's edge
// rows are not produced: the merge reads the rows beside each band boundary
// from the label plane itself.
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
// 0.6, 3.1 and 5.0 us per 1920x1080 frame at 3.35 TB/s.  This first design
// passes through global scratch (parents, reach flags) that stays partly in
// the 50 MB L2, and does not approach those bounds.

#include "common.cuh"

namespace {

constexpr int kItems = 8;   // consecutive pixels per thread in root scans

// ------------------------------------------------------------- hole fill

__global__ void k_flood_init(Geom g, const uint8_t* mask, int32_t* parent,
                             uint8_t* reach) {
  for_each_tile(g, [&](Pix q) {
    bool bg = q.in && !mask[q.b * g.HW + q.p];
    int start = run_start(bg, q);
    if (!q.in) return;
    parent[q.b * g.HW + q.p] = start;
    reach[q.b * g.HW + q.p] = 0;
  });
}

// (k_link_bg and k_compress_mark of common.cuh run between these two.)
__global__ void k_flood_fill(Geom g, const uint8_t* mask,
                             const int32_t* parent, const uint8_t* reach,
                             uint8_t* filled) {
  for_each_tile(g, [&](Pix q) {
    if (!q.in) return;
    long long o = q.b * g.HW + q.p;
    filled[o] = mask[o] || !reach[q.b * g.HW + parent[o]];
  });
}

// ------------------------------------------------------ band-local labels

__global__ void k_band_init(Geom g, const uint8_t* mask, int32_t* labels) {
  for_each_tile(g, [&](Pix q) {
    bool v = q.in && mask[q.b * g.HW + q.p];
    int start = run_start(v, q);
    if (q.in) labels[q.b * g.HW + q.p] = start;
  });
}

// Foreground links: left, and up-left, up, up-right unless this row is the
// first of its band, with the links that the left pixel (or the up pixel's
// row) already implies skipped.
__global__ void k_band_link(Geom g, int conn, const uint8_t* mask,
                            int32_t* labels) {
  for_each_tile(g, [&](Pix q) {
    if (!q.in) return;
    const uint8_t* m = mask + q.b * g.HW;
    int32_t* P = labels + q.b * g.HW;
    int p = (int)q.p;
    if (!m[p]) return;
    bool left = q.x > 0 && m[p - 1];
    if (left && q.lane == 0) unite(P, p, p - 1);
    if (q.y % g.band == 0) return;
    int u = p - g.W;
    bool up = m[u];
    if (conn == 4) {
      if (up) unite(P, p, u);
      return;
    }
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
  });
}

// Foreground pixels take their root, background H*W.
__global__ void k_band_label(Geom g, const uint8_t* mask, int32_t* labels) {
  for_each_tile(g, [&](Pix q) {
    if (!q.in) return;
    long long base = q.b * g.HW;
    labels[base + q.p] =
        mask[base + q.p] ? find_root(labels + base, (int)q.p) : (int)g.HW;
  });
}

// Writes, in raster order, the roots (L[p] == p) among pixels [lo, hi) to
// out[start + rank] where start + rank < limit; returns their count (in
// every thread).  Background holds H*W > p, so it is never a root.
__device__ int append_roots(const int32_t* L, long long lo, long long hi,
                           int32_t* out, int start, int limit) {
  int n = 0;
  for (long long c0 = lo; c0 < hi; c0 += (long long)kScanThreads * kItems) {
    long long p0 = c0 + (long long)threadIdx.x * kItems;
    unsigned bits = 0;
    for (int i = 0; i < kItems; ++i) {
      long long p = p0 + i;
      if (p < hi && L[p] == p) bits |= 1u << i;
    }
    int total;
    int rank = start + n + block_exclusive_scan(__popc(bits), &total);
    for (int i = 0; i < kItems; ++i) {
      if (!(bits >> i & 1u)) continue;
      if (rank < limit) out[rank] = (int32_t)(p0 + i);
      ++rank;
    }
    n += total;
  }
  return n;
}

// One block per (band, frame): the band's root table and root count.
__global__ void k_band_roots(Geom g, int cap, const int32_t* labels,
                             int32_t* roots, int32_t* counts) {
  int r = blockIdx.x, b = blockIdx.y;
  if (frame_skipped(g, b)) return;
  const int32_t* L = labels + b * g.HW;
  int32_t* tab = roots + ((long long)b * g.R + r) * cap;
  int n = append_roots(L, band_lo(g, r), band_hi(g, r), tab, 0, cap);
  for (int j = n + threadIdx.x; j < cap; j += blockDim.x) tab[j] = (int)g.HW;
  if (threadIdx.x == 0) counts[b * g.R + r] = n;
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
      n += append_roots(L, band_lo(g, r), band_hi(g, r), out, n, K);
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

// mask u8 [B, H, W] (0/1) -> filled u8 [B, H, W] (0/1).  Scratch: parent
// int32 [B, H, W], reach u8 [B, H, W].  active: null, or int32 [B] (frames
// with 0 are skipped).  Returns the first CUDA error.
extern "C" int hd_flood_fill(const uint8_t* mask, int B, int H, int W,
                             const int* active, int32_t* parent,
                             uint8_t* reach, uint8_t* filled, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Geom g{H, W, (long long)H * W, H, 1, active};
  dim3 blk(kTileW, kTileH);
  dim3 grid = tile_grid(g, B);
  k_flood_init<<<grid, blk, 0, st>>>(g, mask, parent, reach);
  HD_CHECK();
  k_link_bg<<<grid, blk, 0, st>>>(g, mask, parent);
  HD_CHECK();
  k_compress_mark<<<grid, blk, 0, st>>>(g, mask, parent, reach);
  HD_CHECK();
  k_flood_fill<<<grid, blk, 0, st>>>(g, mask, parent, reach, filled);
  HD_CHECK();
  return 0;
}

// mask u8 [B, H, W] -> band-local labels int32 [B, H, W], band roots int32
// [B, R, cap], counts int32 [B, R], with R = ceil(H / band); active as in
// hd_flood_fill.
extern "C" int hd_band_ccl(const uint8_t* mask, int B, int H, int W,
                           int band, int conn, int cap, const int* active,
                           int32_t* labels, int32_t* roots, int32_t* counts,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int R = (H + band - 1) / band;
  Geom g{H, W, (long long)H * W, band, R, active};
  dim3 blk(kTileW, kTileH);
  dim3 grid = tile_grid(g, B);
  k_band_init<<<grid, blk, 0, st>>>(g, mask, labels);
  HD_CHECK();
  k_band_link<<<grid, blk, 0, st>>>(g, conn, mask, labels);
  HD_CHECK();
  k_band_label<<<grid, blk, 0, st>>>(g, mask, labels);
  HD_CHECK();
  k_band_roots<<<dim3(R, B), kScanThreads, 0, st>>>(g, cap, labels, roots,
                                                    counts);
  HD_CHECK();
  return 0;
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
