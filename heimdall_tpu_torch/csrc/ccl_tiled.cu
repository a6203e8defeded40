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
// round.  Here a block union-find answers it in 3 launches with no rounds
// and no host sync, whatever the depth of a maze in the mask: tiles labelled
// in shared memory, then only their perimeter components merged through a
// small per-frame table (see "hole fill" below).
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
// 0.6, 3.1 and 5.0 us per 1920x1080 frame at 3.35 TB/s.  The fill reads the
// mask twice (tile pass and write pass), so its design floor is 3 B/px; its
// table stays in the 50 MB L2.  The labeling and the merge pass through
// label planes in device memory and do not approach their bounds.

#include "common.cuh"

namespace {

constexpr int kItems = 8;   // consecutive pixels per thread in root scans

// ------------------------------------------------------------- hole fill
//
// A block union-find cut down to the fill's one question (Allegretti,
// Bolelli and Grana, IEEE TPDS 2020; Playne and Hawick, IEEE TPDS 2018):
// does a background component touch the frame border?  One block takes a
// tile of kFillTH x kFillTW pixels.  It labels the tile's background,
// 4-connected, with a union-find in shared memory (parents seeded with the
// starts of the rows' runs, one link up per run overlap, atomicMin hooking
// with path halving).  A component that does not touch the tile's
// perimeter is a hole.  Each component that does gets one entry in a
// per-frame table in device memory, indexed by tile and perimeter
// position (kFillP slots a tile, then its has-a-hole flag; slots of no
// background pixel hold kNoEntry): its representative is the
// component's least perimeter position, the other perimeter pixels point at
// it, and a component with a pixel on the frame border hooks its
// representative under entry 0, the frame border itself.  The merge kernel
// unites the entries of background pixels 4-adjacent across tile edges
// with the same atomicMin union-find on the table; a component reaches the
// border iff its root is entry 0, so no flag needs carrying.  The write
// kernel labels its tile again (cheaper than a label plane in device
// memory) and writes filled = mask | !(root == 0).  Three launches; the
// table is about 0.65 MB a 1920x1080 frame and stays in L2.  Most tiles of
// a real frame skip the labeling: a tile all background or all foreground
// writes its entries directly, and the tile kernel records whether a tile
// has a hole, so that the write kernel copies the mask of a tile with none
// whose perimeter components all reach the border.

constexpr int kFillTH = 32, kFillTW = 128;
constexpr int kFillPx = kFillTH * kFillTW;
constexpr int kFillP = 2 * kFillTW + 2 * kFillTH;   // perimeter slots
constexpr int kFillThreads = 256;
constexpr int kNoRep = 0x7fffffff;
constexpr int kFillSlots = kFillP + 1;   // the perimeter, then "has a hole"
constexpr int kNoEntry = -1;             // a slot of no background pixel

struct FillGeom {
  int H, W, tx, ty;      // tiles across and down
  long long E;           // table entries a frame: 1 + tx * ty * kFillSlots
  const int* active;
};

inline FillGeom fill_geom(int H, int W, const int* active) {
  FillGeom g{H, W, (W + kFillTW - 1) / kFillTW, (H + kFillTH - 1) / kFillTH,
             0, active};
  g.E = 1 + (long long)g.tx * g.ty * kFillSlots;
  return g;
}

// Perimeter slot of tile pixel (ly, lx) in a tile of th x tw, or -1 inside.
__device__ __forceinline__ int perim_pos(int ly, int lx, int th, int tw) {
  if (ly == 0) return lx;
  if (ly == th - 1) return kFillTW + lx;
  if (lx == 0) return 2 * kFillTW + ly;
  if (lx == tw - 1) return 2 * kFillTW + kFillTH + ly;
  return -1;
}

// Whether perimeter slot pos names a pixel of a tile of th x tw.
__device__ __forceinline__ bool perim_valid(int pos, int th, int tw) {
  if (pos < kFillTW) return pos < tw;
  if (pos < 2 * kFillTW) return th > 1 && pos - kFillTW < tw;
  int ly = (pos - 2 * kFillTW) % kFillTH;
  bool right = pos >= 2 * kFillTW + kFillTH;
  return ly > 0 && ly < th - 1 && (!right || tw > 1);
}

// Root of x with path halving: each step re-parents x to its grandparent,
// an ancestor, so finds running at once stay correct and shorten each
// other's paths.
__device__ __forceinline__ int find_halving(volatile int32_t* P, int x) {
  while (true) {
    int p = P[x];
    if (p == x) return x;
    int gp = P[p];
    if (gp == p) return p;
    P[x] = gp;
    x = gp;
  }
}

// unite (common.cuh) with path halving in its finds: a halving store
// re-parents a non-root to an ancestor, and a hook meanwhile carries on
// from the parent it replaced, so no link is lost.
__device__ void unite_halving(int32_t* P, int a, int b) {
  while (true) {
    a = find_halving(P, a);
    b = find_halving(P, b);
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

constexpr int kFillRows = kFillTH / (kFillThreads / 32);  // rows a warp
constexpr int kFillCols = kFillTW / 32;                    // words a row

struct FillSmem {
  int parent[kFillPx];   // tile-local union-find over tile indices
  int rep[kFillPx];      // at a root: least perimeter slot of its component
  uint8_t flag[kFillPx]; // at a root: touches the frame border / reaches it
  uint32_t bgw[kFillTH][kFillCols];   // background bits of each row
};

// What a thread keeps of its kFillRows x kFillCols pixels (row warp + 8k,
// column 32c + lane): background bits (bit k * kFillCols + c) and the
// column where each pixel's run starts (byte c of start[k]).
struct FillPixels {
  int uniform;           // 1: every pixel of the tile is background, 2: none
  uint32_t bg;
  uint32_t start[kFillRows];
  __device__ bool is_bg(int k, int c) const {
    return bg >> (k * kFillCols + c) & 1u;
  }
  __device__ int run_start(int k, int c) const {
    return start[k] >> (8 * c) & 255u;
  }
};

// The background labeling of a tile whose mask bytes (fill_load) are v.
// After it, for a background pixel (ly,
// lx) of this thread, s.parent[ly * kFillTW + run start] is its root,
// s.rep[root] the component's least perimeter slot (kNoRep: a hole) and
// s.flag[root] whether it has a pixel on the frame border.  Pixels outside
// the frame count as foreground.  A tile all background or all foreground
// returns with px.uniform set, unlabelled.  Every thread of the block calls
// it.
// The mask bytes of this thread's pixels (row warp + 8k, column 32c +
// lane), every load in flight at once; outside the tile 1 (foreground).
using FillBytes = uint8_t[kFillRows][kFillCols];
__device__ __forceinline__ void fill_load(const FillGeom& g, const uint8_t* m,
                                          int y0, int x0, int th, int tw,
                                          FillBytes& v) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kFillRows; ++k) {
    int ly = warp + k * (kFillThreads / 32);
    const uint8_t* row = m + (long long)(y0 + ly) * g.W + x0;
#pragma unroll
    for (int c = 0; c < kFillCols; ++c) {
      int lx = c * 32 + lane;
      v[k][c] = ly < th && lx < tw ? row[lx] : 1;
    }
  }
}

__device__ FillPixels fill_label_tile(const FillGeom& g, const FillBytes& v,
                                      int y0, int x0, int th, int tw,
                                      FillSmem& s) {
  constexpr int kWarps = kFillThreads / 32;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  FillPixels px{0, 0u, {}};
  bool any_bg = false, any_fg = false;
#pragma unroll
  for (int k = 0; k < kFillRows; ++k)
#pragma unroll
    for (int c = 0; c < kFillCols; ++c)
      if (warp + k * kWarps < th && c * 32 + lane < tw) {
        any_bg |= !v[k][c];
        any_fg |= v[k][c] != 0;
      }
  any_bg = __syncthreads_or(any_bg);
  any_fg = __syncthreads_or(any_fg);
  if (!any_fg || !any_bg) {              // a uniform tile needs no labeling
    px.uniform = any_bg ? 1 : 2;
    return px;
  }
  // A warp holds whole rows: parents start at the start of the pixel's
  // background run across the row, so no link is needed along a row.
#pragma unroll
  for (int k = 0; k < kFillRows; ++k) {
    int ly = warp + k * kWarps;
    uint32_t w[kFillCols], change[kFillCols];
#pragma unroll
    for (int c = 0; c < kFillCols; ++c) {
      w[c] = __ballot_sync(kFull, !v[k][c]);
      if (lane == c) s.bgw[ly][c] = w[c];
    }
#pragma unroll
    for (int c = 0; c < kFillCols; ++c)   // bits where the class changes
      change[c] = w[c] ^ ((w[c] << 1) | (c > 0 ? w[c - 1] >> 31 : ~w[0] & 1u));
#pragma unroll
    for (int c = 0; c < kFillCols; ++c) {
      int lx = c * 32 + lane, i = ly * kFillTW + lx;
      uint32_t upto = change[c] & ((2u << lane) - 1u);
      int start = c * 32 + 31 - __clz(upto);
      if (upto == 0) {                       // the run began in a word before
#pragma unroll
        for (int cc = c - 1; cc >= 0; --cc)
          if (change[cc]) {
            start = cc * 32 + 31 - __clz(change[cc]);
            break;
          }
      }
      px.bg |= (uint32_t)(!v[k][c]) << (k * kFillCols + c);
      px.start[k] |= (uint32_t)start << (8 * c);
      s.parent[i] = ly * kFillTW + start;
      s.rep[i] = kNoRep;
      s.flag[i] = 0;
    }
  }
  __syncthreads();
  // One link up per run overlap: from its first pixel, unless the pixels
  // to the left and up-left are background (the left pixel shares the run
  // and up-left links up-row through the run above).
#pragma unroll
  for (int k = 0; k < kFillRows; ++k) {
    int ly = warp + k * kWarps;
    if (ly == 0) continue;
#pragma unroll
    for (int c = 0; c < kFillCols; ++c) {
      uint32_t w = s.bgw[ly][c], u = s.bgw[ly - 1][c];
      uint32_t wl = (w << 1) | (c > 0 ? s.bgw[ly][c - 1] >> 31 : 0u);
      uint32_t ul = (u << 1) | (c > 0 ? s.bgw[ly - 1][c - 1] >> 31 : 0u);
      if ((w & u & ~(wl & ul)) >> lane & 1u) {
        int i = ly * kFillTW + c * 32 + lane;
        unite_halving(s.parent, i, i - kFillTW);
      }
    }
  }
  __syncthreads();
  // The run starts take their roots (the unions halved the paths).
#pragma unroll
  for (int k = 0; k < kFillRows; ++k)
#pragma unroll
    for (int c = 0; c < kFillCols; ++c) {
      int ly = warp + k * kWarps, lx = c * 32 + lane;
      if (px.is_bg(k, c) && px.run_start(k, c) == lx) {
        int i = ly * kFillTW + lx;
        s.parent[i] = find_root(s.parent, i);
      }
    }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kFillRows; ++k)
#pragma unroll
    for (int c = 0; c < kFillCols; ++c) {
      int ly = warp + k * kWarps, lx = c * 32 + lane;
      int pos = perim_pos(ly, lx, th, tw);
      if (!px.is_bg(k, c) || pos < 0) continue;
      int r = s.parent[ly * kFillTW + px.run_start(k, c)];
      atomicMin(&s.rep[r], pos);
      int y = y0 + ly, x = x0 + lx;
      if (y == 0 || x == 0 || y == g.H - 1 || x == g.W - 1) s.flag[r] = 1;
    }
  __syncthreads();
  return px;
}

// Calls body(frame, tile row, tile column, frame's mask, table) for every
// tile this block covers: its own tile, or with `active` tile rows
// blockIdx.y, then steps of gridDim.y, of frames not skipped.
template <typename Body>
__device__ __forceinline__ void for_each_fill_tile(const FillGeom& g,
                                                   Body body) {
  int b = blockIdx.z;
  if (g.active != nullptr && g.active[b] == 0) return;
  for (int t = blockIdx.y; t < g.ty; t += gridDim.y) body(b, t, blockIdx.x);
}

inline dim3 fill_grid(const FillGeom& g, int B) {
  int rows = g.ty;
  if (g.active != nullptr && rows > kSkipTileRows) rows = kSkipTileRows;
  return dim3(g.tx, rows, B);
}

// Launch 1: each tile's perimeter entries of the frame's table.
__global__ void __launch_bounds__(kFillThreads, 5)
k_fill_tiles(FillGeom g, const uint8_t* mask, int32_t* table) {
  __shared__ FillSmem s;
  for_each_fill_tile(g, [&](int b, int ty, int tx) {
    int y0 = ty * kFillTH, x0 = tx * kFillTW;
    int th = min(kFillTH, g.H - y0), tw = min(kFillTW, g.W - x0);
    int32_t* T = table + b * g.E;
    FillBytes v;
    fill_load(g, mask + b * (long long)g.H * g.W, y0, x0, th, tw, v);
    FillPixels px = fill_label_tile(g, v, y0, x0, th, tw, s);
    int base = 1 + (ty * g.tx + tx) * kFillSlots;
    if (ty == 0 && tx == 0 && threadIdx.x == 0) T[0] = 0;
    if (px.uniform) {
      // all background: one component, its representative slot 0, which
      // hooks under the border if the tile touches it; all foreground: no
      // entry
      bool border = y0 == 0 || x0 == 0 || y0 + th == g.H || x0 + tw == g.W;
      for (int pos = threadIdx.x; pos < kFillSlots; pos += kFillThreads) {
        int e = kNoEntry;
        if (pos == kFillP)
          e = 0;                             // no hole
        else if (px.uniform == 1 && perim_valid(pos, th, tw))
          e = pos > 0 ? base : (border ? 0 : base);
        T[base + pos] = e;
      }
      __syncthreads();
      return;
    }
    for (int pos = threadIdx.x; pos < kFillP; pos += kFillThreads)
      T[base + pos] = kNoEntry;
    __syncthreads();
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    bool hole = false;
#pragma unroll
    for (int k = 0; k < kFillRows; ++k)
#pragma unroll
      for (int c = 0; c < kFillCols; ++c) {
        int ly = warp + k * (kFillThreads / 32), lx = c * 32 + lane;
        if (!px.is_bg(k, c)) continue;
        int r = s.parent[ly * kFillTW + px.run_start(k, c)], rep = s.rep[r];
        hole |= rep == kNoRep;
        int pos = perim_pos(ly, lx, th, tw);
        if (pos < 0) continue;
        T[base + pos] =
            pos != rep ? base + rep : (s.flag[r] ? 0 : base + pos);
      }
    hole = __syncthreads_or(hole);
    if (threadIdx.x == 0) T[base + kFillP] = hole;
  });
}

// Table entry of background pixel (y, x) on its tile's perimeter.
__device__ __forceinline__ int fill_entry(const FillGeom& g, int y, int x) {
  int ty = y / kFillTH, tx = x / kFillTW;
  int th = min(kFillTH, g.H - ty * kFillTH);
  int tw = min(kFillTW, g.W - tx * kFillTW);
  return 1 + (ty * g.tx + tx) * kFillSlots +
         perim_pos(y - ty * kFillTH, x - tx * kFillTW, th, tw);
}

// Launch 2: one thread per pair of pixels 4-adjacent across a tile edge
// (first the horizontal edges, column by column, then the vertical ones,
// row by row); a pair whose predecessor along the edge is also a background
// pair is already joined through it.
__global__ void k_fill_merge(FillGeom g, long long pairs, const uint8_t* mask,
                             int32_t* table) {
  int b = blockIdx.y;
  if (g.active != nullptr && g.active[b] == 0) return;
  const uint8_t* m = mask + b * (long long)g.H * g.W;
  int32_t* T = table + b * g.E;
  long long nh = (long long)(g.ty - 1) * g.W;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < pairs; k += (long long)gridDim.x * blockDim.x) {
    int ya, xa, yb, xb;
    bool along;          // the predecessor pair lies in the same two tiles
    if (k < nh) {
      yb = (int)(k / g.W + 1) * kFillTH, xb = (int)(k % g.W);
      ya = yb - 1, xa = xb;
      along = xb % kFillTW != 0;
    } else {
      long long j = k - nh;
      yb = (int)(j % g.H), xb = (int)(j / g.H + 1) * kFillTW;
      ya = yb, xa = xb - 1;
      along = yb % kFillTH != 0;
    }
    long long pa = (long long)ya * g.W + xa, pb = (long long)yb * g.W + xb;
    if (m[pa] || m[pb]) continue;
    if (along) {
      long long step = k < nh ? 1 : g.W;
      if (!m[pa - step] && !m[pb - step]) continue;
    }
    unite_halving(T, fill_entry(g, ya, xa), fill_entry(g, yb, xb));
  }
}

// Launch 3: per tile, the labeling again, each perimeter component's root
// in the merged table, then filled = mask | !(reaches the border).
__global__ void __launch_bounds__(kFillThreads, 5)
k_fill_write(FillGeom g, const uint8_t* mask, int32_t* table,
             uint8_t* filled) {
  __shared__ FillSmem s;
  for_each_fill_tile(g, [&](int b, int ty, int tx) {
    int y0 = ty * kFillTH, x0 = tx * kFillTW;
    int th = min(kFillTH, g.H - y0), tw = min(kFillTW, g.W - x0);
    long long off = b * (long long)g.H * g.W;
    int32_t* T = table + b * g.E;
    int base = 1 + (ty * g.tx + tx) * kFillSlots;
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    FillBytes v;                             // in flight during the finds
    fill_load(g, mask + off, y0, x0, th, tw, v);
    // A tile with no hole whose perimeter components all reach the border
    // is its mask: no labeling.
    bool label = threadIdx.x == 0 && T[base + kFillP] != 0;
    for (int pos = threadIdx.x; pos < kFillP; pos += kFillThreads)
      if (T[base + pos] != kNoEntry && find_halving(T, base + pos) != 0)
        label = true;
    if (!__syncthreads_or(label)) {
#pragma unroll
      for (int k = 0; k < kFillRows; ++k)
#pragma unroll
        for (int c = 0; c < kFillCols; ++c) {
          int ly = warp + k * (kFillThreads / 32), lx = c * 32 + lane;
          if (ly < th && lx < tw)
            filled[off + (long long)(y0 + ly) * g.W + x0 + lx] = v[k][c] != 0;
        }
      return;
    }
    FillPixels px = fill_label_tile(g, v, y0, x0, th, tw, s);
    if (px.uniform == 0) {
#pragma unroll
      for (int k = 0; k < kFillRows; ++k)
#pragma unroll
        for (int c = 0; c < kFillCols; ++c) {
          int ly = warp + k * (kFillThreads / 32), lx = c * 32 + lane;
          int i = ly * kFillTW + lx;
          if (!px.is_bg(k, c) || px.run_start(k, c) != lx || s.parent[i] != i)
            continue;                        // not a root
          int rep = s.rep[i];
          s.flag[i] = rep != kNoRep && find_halving(T, base + rep) == 0;
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFillRows; ++k) {
      int ly = warp + k * (kFillThreads / 32);
      if (ly >= th) continue;
      uint8_t* out = filled + off + (long long)(y0 + ly) * g.W + x0;
#pragma unroll
      for (int c = 0; c < kFillCols; ++c) {
        int lx = c * 32 + lane;
        if (lx >= tw) continue;
        // a uniform tile here is background that does not reach the border
        out[lx] = px.uniform != 0 || !px.is_bg(k, c) ||
                  !s.flag[s.parent[ly * kFillTW + px.run_start(k, c)]];
      }
    }
    __syncthreads();
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
  cudaStream_t st = (cudaStream_t)stream;
  FillGeom g = fill_geom(H, W, active);
  dim3 grid = fill_grid(g, B);
  for (const void* k : {(const void*)k_fill_tiles, (const void*)k_fill_write}) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  k_fill_tiles<<<grid, kFillThreads, 0, st>>>(g, mask, table);
  HD_CHECK();
  long long pairs = (long long)(g.ty - 1) * W + (long long)(g.tx - 1) * H;
  if (pairs > 0) {
    long long blocks = (pairs + 255) / 256;
    if (active != nullptr && blocks > 16) blocks = 16;
    k_fill_merge<<<dim3((unsigned)blocks, B), 256, 0, st>>>(g, pairs, mask,
                                                            table);
    HD_CHECK();
  }
  k_fill_write<<<grid, kFillThreads, 0, st>>>(g, mask, table, filled);
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
