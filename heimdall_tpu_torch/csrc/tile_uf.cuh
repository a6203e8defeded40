// Block union-find over tiles in shared memory, shared by ccl_tiled.cu and
// fused_detect.cu: the hole fill (hd_flood_fill, B5b) and the foreground
// labeling (hd_band_ccl, B5a, and the labels of hd_fused_detect, B1); the
// label kernel's fill and ccl stages (hd_label, B6b) run both.
//
// One block takes a tile of kUfTH x kUfTW pixels of a frame and labels one
// class of its pixels (background, 4-connected, for the fill; foreground, 8-
// or 4-connected, for the labels) in shared memory (Allegretti, Bolelli and
// Grana, IEEE TPDS 2020; Playne and Hawick, IEEE TPDS 2018): a warp holds
// whole rows, so parents start at the start of each pixel's run along the
// row (the warp's ballots; no link is needed along a row); then one link up
// per run overlap, united by atomicMin hooking with path halving on tile
// indices.  Tile indices are raster order within the tile, so a tile-local
// root is its component's least pixel.  Tiles all of one class skip the
// labeling.  Only what crosses a tile edge goes through device memory: the
// fill's perimeter table, the labels' root pointers in the label plane.

#pragma once

#include "common.cuh"

namespace {

constexpr int kUfTH = 32, kUfTW = 128;
constexpr int kUfPx = kUfTH * kUfTW;
constexpr int kUfThreads = 256;
constexpr int kUfWarps = kUfThreads / 32;
constexpr int kUfRows = kUfTH / kUfWarps;   // rows a warp
constexpr int kUfCols = kUfTW / 32;         // words a row

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

struct NoHook {
  __device__ void operator()(int) const {}
};

// unite (common.cuh) with path halving in its finds: a halving store
// re-parents a non-root to an ancestor, and a hook meanwhile carries on
// from the parent it replaced, so no link is lost.  A halving store can
// also overwrite a root just stored by a compression with an ancestor, so
// compressions (find_root stores) run only after the unions, past a
// barrier or in a later launch.  hook(b) is called for the root b that
// the union hooks under another.
template <typename Hook = NoHook>
__device__ void unite_halving(int32_t* P, int a, int b, Hook hook = Hook()) {
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
    if (old == b) {
      hook(b);
      return;
    }
    b = old;
  }
}

// The mask bytes of this thread's pixels (row warp + 8k, column 32c +
// lane); outside the tile `outside`.  Each load reads an in-frame byte (row
// and column clamped to the tile) under no predicate, so all sixteen are in
// flight at once.  Loads guarded by the tile's bounds took a predicate
// register each, and the compiler issued most of them one at a time, each
// waiting for its use (the SASS of k_fill_tiles and k_label_tiles);
// clamped, the fill ran 17% and the band labels 11% faster on an H100
// (2 MP bench masks).
using TileBytes = uint8_t[kUfRows][kUfCols];

__device__ __forceinline__ void tile_load(const uint8_t* m, int W, int y0,
                                          int x0, int th, int tw,
                                          uint8_t outside, TileBytes& v) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t raw[kUfRows][kUfCols];
#pragma unroll
  for (int k = 0; k < kUfRows; ++k) {
    int ly = min(warp + k * kUfWarps, th - 1);
    const uint8_t* row = m + (long long)(y0 + ly) * W + x0;
#pragma unroll
    for (int c = 0; c < kUfCols; ++c)
      raw[k][c] = row[min(c * 32 + lane, tw - 1)];
  }
#pragma unroll
  for (int k = 0; k < kUfRows; ++k)
#pragma unroll
    for (int c = 0; c < kUfCols; ++c)
      v[k][c] = warp + k * kUfWarps < th && c * 32 + lane < tw ? raw[k][c]
                                                               : outside;
}

// What a thread keeps of its pixels after the labeling: which are of the
// labelled class (bit k * kUfCols + c) and the column where each pixel's
// run starts (byte c of start[k]).
struct TilePx {
  int uniform;           // 1: no pixel of the tile is of the class, 2: all
  uint32_t bits;
  uint32_t start[kUfRows];
  __device__ bool has(int k, int c) const {
    return bits >> (k * kUfCols + c) & 1u;
  }
  __device__ int run_start(int k, int c) const {
    return start[k] >> (8 * c) & 255u;
  }
};

// Whether the tile's in-frame pixels are all of the class (2), none (1) or
// mixed (0), with the class the foreground (fg) or the background.  Every
// thread of the block calls it.
__device__ __forceinline__ int tile_uniform(const TileBytes& v, bool fg,
                                            int th, int tw) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool any_in = false, any_out = false;
#pragma unroll
  for (int k = 0; k < kUfRows; ++k)
#pragma unroll
    for (int c = 0; c < kUfCols; ++c)
      if (warp + k * kUfWarps < th && c * 32 + lane < tw) {
        bool in = (v[k][c] != 0) == fg;
        any_in |= in;
        any_out |= !in;
      }
  any_in = __syncthreads_or(any_in);
  any_out = __syncthreads_or(any_out);
  return !any_in ? 1 : (!any_out ? 2 : 0);
}

// Parents of the class's pixels = the start of their run along the row
// (parent[ly * kUfTW + lx] = ly * kUfTW + start), the class's bits of each
// row in words[ly][c], and px's bits and run starts.  Pixels outside the
// tile must hold the other class.
__device__ __forceinline__ void seed_runs(const TileBytes& v, bool fg,
                                          int32_t* parent,
                                          uint32_t (*words)[kUfCols],
                                          TilePx& px) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kUfRows; ++k) {
    int ly = warp + k * kUfWarps;
    uint32_t w[kUfCols], change[kUfCols];
#pragma unroll
    for (int c = 0; c < kUfCols; ++c) {
      w[c] = __ballot_sync(kFull, (v[k][c] != 0) == fg);
      if (lane == c) words[ly][c] = w[c];
    }
#pragma unroll
    for (int c = 0; c < kUfCols; ++c)   // bits where the class changes
      change[c] = w[c] ^ ((w[c] << 1) | (c > 0 ? w[c - 1] >> 31 : ~w[0] & 1u));
#pragma unroll
    for (int c = 0; c < kUfCols; ++c) {
      int lx = c * 32 + lane;
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
      px.bits |= (uint32_t)(w[c] >> lane & 1u) << (k * kUfCols + c);
      px.start[k] |= (uint32_t)start << (8 * c);
      parent[ly * kUfTW + lx] = ly * kUfTW + start;
    }
  }
}

// After the unions: the run starts of the class take their roots, so that
// parent[ly * kUfTW + px.run_start(k, c)] is the root of pixel (k, c).
// Ends with the block synchronised.
__device__ __forceinline__ void compress_runs(const TilePx& px,
                                              int32_t* parent) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kUfRows; ++k)
#pragma unroll
    for (int c = 0; c < kUfCols; ++c) {
      int ly = warp + k * kUfWarps, lx = c * 32 + lane;
      if (px.has(k, c) && px.run_start(k, c) == lx) {
        int i = ly * kUfTW + lx;
        parent[i] = find_root(parent, i);
      }
    }
  __syncthreads();
}

// Calls body(frame, tile row, tile column) for every tile this block
// covers: its own tile, or with `active` tile rows blockIdx.y, then steps
// of gridDim.y, of frames not skipped.
template <typename Body>
__device__ __forceinline__ void for_each_uf_tile(int ty, const int* active,
                                                 Body body) {
  int b = blockIdx.z;
  if (active != nullptr && active[b] == 0) return;
  for (int t = blockIdx.y; t < ty; t += gridDim.y) body(b, t, blockIdx.x);
}

inline dim3 uf_grid(int tx, int ty, const int* active, int B) {
  int rows = ty;
  if (active != nullptr && rows > kSkipTileRows) rows = kSkipTileRows;
  return dim3(tx, rows, B);
}

// Launch of an edge kernel over `pairs` pairs of pixels across tile edges
// of B frames: one thread a pair, at most 16 blocks a frame when frames may
// be skipped.
inline dim3 edge_grid(long long pairs, const int* active, int B) {
  long long blocks = (pairs + 255) / 256;
  if (active != nullptr && blocks > 16) blocks = 16;
  return dim3((unsigned)blocks, B);
}

// ------------------------------------------------------------- hole fill
//
// filled = mask | (background not 4-connected to the frame border).  The
// tile labels its background, 4-connected; a component that does not touch
// the tile's perimeter is a hole.  Each component that does gets one entry
// in a per-frame table in device memory, indexed by tile and perimeter
// position (kFillP slots a tile, then its has-a-hole flag; slots of no
// background pixel hold kNoEntry): its representative is the component's
// least perimeter position, the other perimeter pixels point at it, and a
// component with a pixel on the frame border hooks its representative under
// entry 0, the frame border itself.  On a shard of a frame's rows (a plane
// of H of the frame's Hg rows from row row_off, B5b on a shard,
// hd_flood_fill_sp) the border is the whole frame's: its first and last
// rows only where the shard holds them, and on a cut row the background
// pixels beside a reached pixel of the neighbouring shard (its edge row,
// given as a halo row: nonzero = reached).  The merge kernel unites the
// entries of background pixels 4-adjacent across tile edges with the same
// atomicMin union-find on the table; a component reaches the border iff its
// root is
// entry 0, so no flag needs carrying.  The write kernel labels its tile
// again (cheaper than a label plane in device memory) and writes filled =
// mask | !(root == 0).  Three launches; the table is about 0.65 MB a
// 1920x1080 frame and stays in L2.  Most tiles of a real frame skip the
// labeling: a tile all background or all foreground writes its entries
// directly, and the tile kernel records whether a tile has a hole, so that
// the write kernel copies the mask of a tile with none whose perimeter
// components all reach the border.

constexpr int kFillP = 2 * kUfTW + 2 * kUfTH;   // perimeter slots
constexpr int kNoRep = 0x7fffffff;
constexpr int kFillSlots = kFillP + 1;   // the perimeter, then "has a hole"
constexpr int kNoEntry = -1;             // a slot of no background pixel

struct FillGeom {
  int H, W, tx, ty;      // tiles across and down
  long long E;           // table entries a frame: 1 + tx * ty * kFillSlots
  const int* active;
  int Hg, row_off;       // the frame's rows, and the plane's first among them
  // reached pixels across the plane's first and last rows (u8 [B, W]), or
  // null where that row is not a cut
  const uint8_t* halo_top;
  const uint8_t* halo_bot;
};

inline FillGeom fill_geom(int H, int W, const int* active) {
  FillGeom g{H, W, (W + kUfTW - 1) / kUfTW, (H + kUfTH - 1) / kUfTH, 0,
             active, H, 0, nullptr, nullptr};
  g.E = 1 + (long long)g.tx * g.ty * kFillSlots;
  return g;
}

// Whether background pixel (y, x) of frame b's plane is joined to the
// frame border by itself: on the whole frame's edge, or on a shard
// (kShard) on a cut row beside a reached pixel of the neighbouring shard.
// The kernels take kShard as a template parameter, so that the
// whole-frame fill runs the plain test.
template <bool kShard>
__device__ __forceinline__ bool fill_border(const FillGeom& g, int b, int y,
                                            int x) {
  if (!kShard) return y == 0 || x == 0 || y == g.H - 1 || x == g.W - 1;
  int gy = y + g.row_off;
  if (gy == 0 || x == 0 || gy == g.Hg - 1 || x == g.W - 1) return true;
  bool hit = false;
  if (y == 0 && g.halo_top != nullptr)
    hit = g.halo_top[(long long)b * g.W + x] != 0;
  if (y == g.H - 1 && g.halo_bot != nullptr)
    hit = hit || g.halo_bot[(long long)b * g.W + x] != 0;
  return hit;
}

// Perimeter slot of tile pixel (ly, lx) in a tile of th x tw, or -1 inside.
__device__ __forceinline__ int perim_pos(int ly, int lx, int th, int tw) {
  if (ly == 0) return lx;
  if (ly == th - 1) return kUfTW + lx;
  if (lx == 0) return 2 * kUfTW + ly;
  if (lx == tw - 1) return 2 * kUfTW + kUfTH + ly;
  return -1;
}

// Whether perimeter slot pos names a pixel of a tile of th x tw.
__device__ __forceinline__ bool perim_valid(int pos, int th, int tw) {
  if (pos < kUfTW) return pos < tw;
  if (pos < 2 * kUfTW) return th > 1 && pos - kUfTW < tw;
  int ly = (pos - 2 * kUfTW) % kUfTH;
  bool right = pos >= 2 * kUfTW + kUfTH;
  return ly > 0 && ly < th - 1 && (!right || tw > 1);
}

struct FillSmem {
  int parent[kUfPx];     // tile-local union-find over tile indices
  int rep[kUfPx];        // at a root: least perimeter slot of its component
  uint8_t flag[kUfPx];   // at a root: touches the frame border / reaches it
  uint32_t bgw[kUfTH][kUfCols];   // background bits of each row
};

// The background labeling of a tile whose mask bytes (tile_load, outside
// 1) are v.  After it, for a background pixel (ly, lx) of this thread,
// s.parent[ly * kUfTW + run start] is its root, s.rep[root] the
// component's least perimeter slot (kNoRep: a hole) and s.flag[root]
// whether it has a pixel on the frame border.  A tile all background or
// all foreground returns with px.uniform set, unlabelled.  Every thread of
// the block calls it.
template <bool kShard>
__device__ TilePx fill_label_tile(const FillGeom& g, const TileBytes& v,
                                  int b, int y0, int x0, int th, int tw,
                                  FillSmem& s) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  TilePx px{tile_uniform(v, false, th, tw), 0u, {}};
  if (px.uniform) return px;             // a uniform tile needs no labeling
  seed_runs(v, false, s.parent, s.bgw, px);
#pragma unroll
  for (int k = 0; k < kUfRows; ++k)
#pragma unroll
    for (int c = 0; c < kUfCols; ++c) {
      int i = (warp + k * kUfWarps) * kUfTW + c * 32 + lane;
      s.rep[i] = kNoRep;
      s.flag[i] = 0;
    }
  __syncthreads();
  // One link up per run overlap: from its first pixel, unless the pixels
  // to the left and up-left are background (the left pixel shares the run
  // and up-left links up-row through the run above).
#pragma unroll
  for (int k = 0; k < kUfRows; ++k) {
    int ly = warp + k * kUfWarps;
    if (ly == 0) continue;
#pragma unroll
    for (int c = 0; c < kUfCols; ++c) {
      uint32_t w = s.bgw[ly][c], u = s.bgw[ly - 1][c];
      uint32_t wl = (w << 1) | (c > 0 ? s.bgw[ly][c - 1] >> 31 : 0u);
      uint32_t ul = (u << 1) | (c > 0 ? s.bgw[ly - 1][c - 1] >> 31 : 0u);
      if ((w & u & ~(wl & ul)) >> lane & 1u) {
        int i = ly * kUfTW + c * 32 + lane;
        unite_halving(s.parent, i, i - kUfTW);
      }
    }
  }
  __syncthreads();
  compress_runs(px, s.parent);
#pragma unroll
  for (int k = 0; k < kUfRows; ++k)
#pragma unroll
    for (int c = 0; c < kUfCols; ++c) {
      int ly = warp + k * kUfWarps, lx = c * 32 + lane;
      int pos = perim_pos(ly, lx, th, tw);
      if (!px.has(k, c) || pos < 0) continue;
      int r = s.parent[ly * kUfTW + px.run_start(k, c)];
      atomicMin(&s.rep[r], pos);
      if (fill_border<kShard>(g, b, y0 + ly, x0 + lx)) s.flag[r] = 1;
    }
  __syncthreads();
  return px;
}

// Launch 1: each tile's perimeter entries of the frame's table.
template <bool kShard>
__global__ void __launch_bounds__(kUfThreads, 5)
k_fill_tiles(FillGeom g, const uint8_t* mask, int32_t* table) {
  __shared__ FillSmem s;
  for_each_uf_tile(g.ty, g.active, [&](int b, int ty, int tx) {
    int y0 = ty * kUfTH, x0 = tx * kUfTW;
    int th = min(kUfTH, g.H - y0), tw = min(kUfTW, g.W - x0);
    int32_t* T = table + b * g.E;
    TileBytes v;
    tile_load(mask + b * (long long)g.H * g.W, g.W, y0, x0, th, tw, 1, v);
    TilePx px = fill_label_tile<kShard>(g, v, b, y0, x0, th, tw, s);
    int base = 1 + (ty * g.tx + tx) * kFillSlots;
    if (ty == 0 && tx == 0 && threadIdx.x == 0) T[0] = 0;
    if (px.uniform) {
      // all background: one component, its representative slot 0, which
      // hooks under the border if the tile touches it (or lies on a cut
      // row beside a reached halo pixel); all foreground: no entry
      bool border = y0 + g.row_off == 0 || x0 == 0 ||
                    y0 + th + g.row_off == g.Hg || x0 + tw == g.W;
      if (kShard) {
        bool halo = false;
        if (px.uniform == 2)
          for (int x = x0 + threadIdx.x; x < x0 + tw; x += kUfThreads) {
            long long h = (long long)b * g.W + x;
            halo = halo ||
                   (y0 == 0 && g.halo_top != nullptr && g.halo_top[h]) ||
                   (y0 + th == g.H && g.halo_bot != nullptr &&
                    g.halo_bot[h]);
          }
        border = __syncthreads_or(halo) || border;
      }
      for (int pos = threadIdx.x; pos < kFillSlots; pos += kUfThreads) {
        int e = kNoEntry;
        if (pos == kFillP)
          e = 0;                             // no hole
        else if (px.uniform == 2 && perim_valid(pos, th, tw))
          e = pos > 0 ? base : (border ? 0 : base);
        T[base + pos] = e;
      }
      __syncthreads();
      return;
    }
    for (int pos = threadIdx.x; pos < kFillP; pos += kUfThreads)
      T[base + pos] = kNoEntry;
    __syncthreads();
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    bool hole = false;
#pragma unroll
    for (int k = 0; k < kUfRows; ++k)
#pragma unroll
      for (int c = 0; c < kUfCols; ++c) {
        int ly = warp + k * kUfWarps, lx = c * 32 + lane;
        if (!px.has(k, c)) continue;
        int r = s.parent[ly * kUfTW + px.run_start(k, c)], rep = s.rep[r];
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
  int ty = y / kUfTH, tx = x / kUfTW;
  int th = min(kUfTH, g.H - ty * kUfTH);
  int tw = min(kUfTW, g.W - tx * kUfTW);
  return 1 + (ty * g.tx + tx) * kFillSlots +
         perim_pos(y - ty * kUfTH, x - tx * kUfTW, th, tw);
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
      yb = (int)(k / g.W + 1) * kUfTH, xb = (int)(k % g.W);
      ya = yb - 1, xa = xb;
      along = xb % kUfTW != 0;
    } else {
      long long j = k - nh;
      yb = (int)(j % g.H), xb = (int)(j / g.H + 1) * kUfTW;
      ya = yb, xa = xb - 1;
      along = yb % kUfTH != 0;
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
// in the merged table, then filled = mask | !(reaches the border).  Each
// block reads and writes its own tile only, so filled may be the mask.
template <bool kShard>
__global__ void __launch_bounds__(kUfThreads, 5)
k_fill_write(FillGeom g, const uint8_t* mask, int32_t* table,
             uint8_t* filled) {
  __shared__ FillSmem s;
  for_each_uf_tile(g.ty, g.active, [&](int b, int ty, int tx) {
    int y0 = ty * kUfTH, x0 = tx * kUfTW;
    int th = min(kUfTH, g.H - y0), tw = min(kUfTW, g.W - x0);
    long long off = b * (long long)g.H * g.W;
    int32_t* T = table + b * g.E;
    int base = 1 + (ty * g.tx + tx) * kFillSlots;
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    TileBytes v;                             // in flight during the finds
    tile_load(mask + off, g.W, y0, x0, th, tw, 1, v);
    // A tile with no hole whose perimeter components all reach the border
    // is its mask: no labeling.
    bool label = threadIdx.x == 0 && T[base + kFillP] != 0;
    for (int pos = threadIdx.x; pos < kFillP; pos += kUfThreads)
      if (T[base + pos] != kNoEntry && find_halving(T, base + pos) != 0)
        label = true;
    if (!__syncthreads_or(label)) {
#pragma unroll
      for (int k = 0; k < kUfRows; ++k)
#pragma unroll
        for (int c = 0; c < kUfCols; ++c) {
          int ly = warp + k * kUfWarps, lx = c * 32 + lane;
          if (ly < th && lx < tw)
            filled[off + (long long)(y0 + ly) * g.W + x0 + lx] = v[k][c] != 0;
        }
      return;
    }
    TilePx px = fill_label_tile<kShard>(g, v, b, y0, x0, th, tw, s);
    if (px.uniform == 0) {
#pragma unroll
      for (int k = 0; k < kUfRows; ++k)
#pragma unroll
        for (int c = 0; c < kUfCols; ++c) {
          int ly = warp + k * kUfWarps, lx = c * 32 + lane;
          int i = ly * kUfTW + lx;
          if (!px.has(k, c) || px.run_start(k, c) != lx || s.parent[i] != i)
            continue;                        // not a root
          int rep = s.rep[i];
          s.flag[i] = rep != kNoRep && find_halving(T, base + rep) == 0;
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kUfRows; ++k) {
      int ly = warp + k * kUfWarps;
      if (ly >= th) continue;
      uint8_t* out = filled + off + (long long)(y0 + ly) * g.W + x0;
#pragma unroll
      for (int c = 0; c < kUfCols; ++c) {
        int lx = c * 32 + lane;
        if (lx >= tw) continue;
        // a uniform tile here is background that does not reach the border
        out[lx] = px.uniform != 0 || !px.has(k, c) ||
                  !s.flag[s.parent[ly * kUfTW + px.run_start(k, c)]];
      }
    }
    __syncthreads();
  });
}

// The hole fill of B frames (mask -> filled; filled may be mask) with its
// table (int32 [B, fill_geom(H, W).E]), on stream st: 2 or 3 launches (no
// merge when the frame is one tile).  On a shard of rows: Hg >= 0, with
// row_off and the halo rows as in FillGeom.  Returns the first CUDA error.
template <bool kShard>
int launch_fill(const FillGeom& g, int B, const uint8_t* mask,
                int32_t* table, uint8_t* filled, cudaStream_t st) {
  dim3 grid = uf_grid(g.tx, g.ty, g.active, B);
  for (const void* k : {(const void*)k_fill_tiles<kShard>,
                        (const void*)k_fill_write<kShard>}) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  k_fill_tiles<kShard><<<grid, kUfThreads, 0, st>>>(g, mask, table);
  HD_CHECK();
  long long pairs =
      (long long)(g.ty - 1) * g.W + (long long)(g.tx - 1) * g.H;
  if (pairs > 0) {
    k_fill_merge<<<edge_grid(pairs, g.active, B), 256, 0, st>>>(
        g, pairs, mask, table);
    HD_CHECK();
  }
  k_fill_write<kShard><<<grid, kUfThreads, 0, st>>>(g, mask, table, filled);
  HD_CHECK();
  return 0;
}

inline int launch_flood_fill(const uint8_t* mask, int B, int H, int W,
                             const int* active, int32_t* table,
                             uint8_t* filled, cudaStream_t st,
                             int row_off = 0, int Hg = -1,
                             const uint8_t* halo_top = nullptr,
                             const uint8_t* halo_bot = nullptr) {
  FillGeom g = fill_geom(H, W, active);
  if (Hg < 0) return launch_fill<false>(g, B, mask, table, filled, st);
  g.Hg = Hg;
  g.row_off = row_off;
  g.halo_top = halo_top;
  g.halo_bot = halo_bot;
  return launch_fill<true>(g, B, mask, table, filled, st);
}

// ------------------------------------------------------ foreground labels
//
// Labels of the foreground, 8- or 4-connected, within bands of `band` rows
// (a row y with y % band == 0 never links upward; band = H gives whole
// frames): every foreground pixel's label is the global linear index of its
// band-local component's least pixel, background H*W.  On a shard of a
// frame's rows (B5a on a shard, hd_band_ccl_sp) the indices are the whole
// frame's: LabelGeom's base (the shard's first pixel in the frame) is added
// to every label and root, and the background is its bg (the frame's
// Hg*W); the plane is indexed by label through a pointer moved back by
// base.  Three launches:
//   1. tiles: each tile labelled in shared memory, every pixel's label
//      written once, as the global index of its tile-local root;
//   2. merge: one thread per pair of foreground pixels adjacent across a
//      tile edge (inside a band) unites the pair's roots in the label plane
//      itself, with atomicMin hooking and path halving on linear indices,
//      so the surviving root is the component's least pixel.  The label
//      plane is a forest over the tile roots: a pixel's label names its tile
//      root, a tile root's label its parent, and the finds start from the
//      pixels' labels, so only tile roots' labels change;
//   3. write: each tile's labels read back, the roots of its components
//      hooked away found in the plane once a component, and only their
//      pixels rewritten; with kCount also each band's exact root count
//      and first root (for the band root tables).  Tile flags from
//      launches 1 and 2 let it skip the tiles with no foreground, and
//      without kCount those with no root hooked away.
// The pairs: across a horizontal tile edge at row Y, the up links of row Y
// with the rule that the in-row links make the rest redundant (8: up unless
// the left pixel is foreground, up-right where up is background, up-left
// where left and up are background; 4: up unless left and up-left are both
// foreground); across a vertical edge, per row, the pixels side by side
// (redundant when the row above has both and lies in the same tile row and
// band) and, under 8-connectivity, the two diagonals where no side pixel
// joins them already.  Tile corners are covered: the diagonal pairs
// (Y - 1, X - 1)-(Y, X) and (Y - 1, X)-(Y, X - 1) cross the horizontal edge.

// Tile flags (one byte a tile, in scratch the caller lends): 0 no
// foreground, 1 foreground, 2 a root of the tile hooked away by the merge.
// They let the write pass skip every tile that has nothing to count or
// rewrite.  A frame's flags lie in chunks of flag_chunk bytes, flag_pitch
// bytes apart (so they can live in the unused slots of the band root
// tables), frames flag_frame bytes apart.  Without flags the write pass
// visits every tile.
enum TileFlag { kNoFg = 0, kFg = 1, kHooked = 2 };

struct LabelGeom {
  int H, W, tx, ty, band, conn;
  int R, cap;            // bands, and the root table's slots a band
  const int* active;
  uint8_t* flags;
  long long flag_frame;
  int flag_chunk, flag_pitch;
  int base, bg;          // label of pixel 0, and the background's
};

inline LabelGeom label_geom(int H, int W, int band, int conn, int cap,
                            const int* active) {
  return LabelGeom{H, W, (W + kUfTW - 1) / kUfTW, (H + kUfTH - 1) / kUfTH,
                   band, conn, (H + band - 1) / band, cap, active,
                   nullptr, 0, 1, 0, 0, H * W};
}

// g with the tile flags at `flags` (see LabelGeom).
inline LabelGeom with_flags(LabelGeom g, uint8_t* flags, long long frame,
                            int chunk, int pitch) {
  g.flags = flags;
  g.flag_frame = frame;
  g.flag_chunk = chunk;
  g.flag_pitch = pitch;
  return g;
}

__device__ __forceinline__ uint8_t* tile_flag(const LabelGeom& g, int b,
                                              int t) {
  return g.flags + b * g.flag_frame +
         (long long)(t / g.flag_chunk) * g.flag_pitch + t % g.flag_chunk;
}

struct LabelSmem {
  int parent[kUfPx];     // tile-local union-find over tile indices
  uint32_t fgw[kUfTH][kUfCols];   // foreground bits of each row
};

// Global linear index (the label) of tile index i of the tile at (y0, x0).
__device__ __forceinline__ int tile_global(const LabelGeom& g, int y0,
                                           int x0, int i) {
  return g.base + (y0 + i / kUfTW) * g.W + x0 + i % kUfTW;
}

// Tile row of the root of an all-foreground tile's pixels in tile row ly:
// the first row of its band within the tile.
__device__ __forceinline__ int band_top(const LabelGeom& g, int y0, int ly) {
  int y = y0 + ly;
  return max(y0, y - y % g.band) - y0;
}

// The foreground labeling of a tile whose mask bytes (tile_load, outside
// 0) are v.  After it, for a foreground pixel (k, c) of this thread,
// s.parent[ly * kUfTW + px.run_start(k, c)] is its tile-local root.  A
// tile all foreground or all background returns with px.uniform set,
// unlabelled.  Every thread of the block calls it; ends synchronised.
__device__ TilePx fg_label_tile(const LabelGeom& g, const TileBytes& v,
                                int y0, int th, int tw, LabelSmem& s) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  TilePx px{tile_uniform(v, true, th, tw), 0u, {}};
  if (px.uniform) return px;
  seed_runs(v, true, s.parent, s.fgw, px);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kUfRows; ++k) {
    int ly = warp + k * kUfWarps;
    if (ly == 0 || (y0 + ly) % g.band == 0) continue;
#pragma unroll
    for (int c = 0; c < kUfCols; ++c) {
      uint32_t w = s.fgw[ly][c], u = s.fgw[ly - 1][c];
      uint32_t wl = (w << 1) | (c > 0 ? s.fgw[ly][c - 1] >> 31 : 0u);
      uint32_t ul = (u << 1) | (c > 0 ? s.fgw[ly - 1][c - 1] >> 31 : 0u);
      uint32_t ur = (u >> 1) |
                    (c < kUfCols - 1 ? s.fgw[ly - 1][c + 1] << 31 : 0u);
      uint32_t up, upr = 0u, upl = 0u;
      if (g.conn == 4) {
        up = w & u & ~(wl & ul);
      } else {
        up = w & u & ~wl;
        upr = w & ~u & ur;
        upl = w & ~wl & ~u & ul;
      }
      int i = ly * kUfTW + c * 32 + lane;
      if (up >> lane & 1u) unite_halving(s.parent, i, i - kUfTW);
      if (upr >> lane & 1u) unite_halving(s.parent, i, i - kUfTW + 1);
      if (upl >> lane & 1u) unite_halving(s.parent, i, i - kUfTW - 1);
    }
  }
  __syncthreads();
  compress_runs(px, s.parent);
  return px;
}

// Launch 1: every pixel's label, the global index of its tile-local root,
// and the tile's flag (kNoFg or kFg).  With kCount, the first tile of each
// frame also clears the frame's band root counts and sets each band's
// first root (slot 0 of its root table) to H*W, for launch 3's atomics.
// Most tiles of a real frame are all background, so the pass is a stream
// of label stores behind one mask load a tile: six blocks an SM (40
// registers, a few bytes of spill) ran faster on the card than five or
// eight (eight: 32 registers, and the tile's sixteen mask bytes spill).
template <bool kCount>
__global__ void __launch_bounds__(kUfThreads, 6)
k_label_tiles(LabelGeom g, const uint8_t* mask, int32_t* labels,
              int32_t* roots, int32_t* counts) {
  __shared__ LabelSmem s;
  const int HW = g.H * g.W;
  for_each_uf_tile(g.ty, g.active, [&](int b, int ty, int tx) {
    int y0 = ty * kUfTH, x0 = tx * kUfTW;
    int th = min(kUfTH, g.H - y0), tw = min(kUfTW, g.W - x0);
    long long off = b * (long long)HW;
    if (kCount && ty == 0 && tx == 0)
      for (int r = threadIdx.x; r < g.R; r += kUfThreads) {
        counts[b * g.R + r] = 0;
        roots[((long long)b * g.R + r) * g.cap] = g.bg;
      }
    TileBytes v;
    tile_load(mask + off, g.W, y0, x0, th, tw, 0, v);
    TilePx px = fg_label_tile(g, v, y0, th, tw, s);
    if (g.flags != nullptr && threadIdx.x == 0)
      *tile_flag(g, b, ty * g.tx + tx) = px.uniform == 1 ? kNoFg : kFg;
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < kUfRows; ++k) {
      int ly = warp + k * kUfWarps;
      if (ly >= th) continue;
      int32_t* out = labels + off + (long long)(y0 + ly) * g.W + x0;
      int top = (y0 + band_top(g, y0, ly)) * g.W + x0;
#pragma unroll
      for (int c = 0; c < kUfCols; ++c) {
        int lx = c * 32 + lane;
        if (lx >= tw) continue;
        int lab = g.bg;
        if (px.uniform == 2)
          lab = g.base + top;
        else if (px.uniform == 0 && px.has(k, c))
          lab = tile_global(g, y0, x0,
                            s.parent[ly * kUfTW + px.run_start(k, c)]);
        out[lx] = lab;
      }
    }
    __syncthreads();
  });
}

// Launch 2: the pairs across tile edges (first the horizontal edges,
// column by column, then the vertical ones, row by row).
__global__ void k_label_merge(LabelGeom g, long long pairs,
                              const uint8_t* mask, int32_t* labels) {
  int b = blockIdx.y;
  if (g.active != nullptr && g.active[b] == 0) return;
  const int W = g.W;
  const long long HW = (long long)g.H * W;
  const uint8_t* m = mask + b * HW;
  int32_t* L = labels + b * HW;
  const volatile int32_t* VL = L;
  int32_t* P = L - g.base;     // the plane indexed by label
  // a root hooked away marks its tile for the write pass
  auto mark = [&](int r) {
    r -= g.base;
    if (g.flags != nullptr)
      *tile_flag(g, b, r / W / kUfTH * g.tx + r % W / kUfTW) = kHooked;
  };
  auto join = [&](long long p, long long q) {
    unite_halving(P, VL[p], VL[q], mark);
  };
  long long nh = (long long)(g.ty - 1) * W;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < pairs; k += (long long)gridDim.x * blockDim.x) {
    if (k < nh) {
      int Y = (int)(k / W + 1) * kUfTH, x = (int)(k % W);
      long long p = (long long)Y * W + x, u = p - W;
      if (Y % g.band == 0 || !m[p]) continue;
      bool up = m[u] != 0, wl = x > 0 && m[p - 1], ul = x > 0 && m[u - 1];
      if (g.conn == 4) {
        if (up && !(wl && ul)) join(p, u);
        continue;
      }
      bool ur = x < W - 1 && m[u + 1];
      if (up && !wl) join(p, u);
      if (!up && ur) join(p, u + 1);
      if (!up && !wl && ul) join(p, u - 1);
    } else {
      long long j = k - nh;
      int y = (int)(j % g.H), X = (int)(j / g.H + 1) * kUfTW;
      long long pb = (long long)y * W + X, pa = pb - 1;
      bool a = m[pa] != 0, c = m[pb] != 0;
      if (!a && !c) continue;
      // the row above lies in the same tile row and band: in-tile links
      // join each side to it
      bool inner = y % kUfTH != 0 && y % g.band != 0;
      bool ua = inner && m[pa - W], uc = inner && m[pb - W];
      if (a && c && !(ua && uc)) join(pa, pb);
      if (g.conn == 8 && inner) {
        if (c && ua && !a && !uc) join(pb, pa - W);
        if (a && uc && !c && !ua) join(pa, pb - W);
      }
    }
  }
}

struct LabelWriteSmem {
  int lab[kUfPx];        // the tile's labels after the merge
  int fin[kUfPx];        // at a pixel that ends an in-tile chain: its root
  int rows[kUfTH];       // roots surviving the merge, per row
  int first[kUfTH];      // the least of them, per row
};

// Launch 3: the labels of components hooked away, and with kCount each
// band's root count and first root; with flags, only over the tiles that
// need it.  The tile's labels are read back rather than the tile labelled
// again: only tile roots' labels changed in the merge, and every label in
// the tile names a smaller index, so following labels that stay in the
// tile ends at a pixel whose label is itself (a root) or leaves the tile
// (a root hooked into another tile); each such pixel finds its root once,
// in the plane, and the others take it from shared memory.
template <bool kCount>
__global__ void __launch_bounds__(kUfThreads, 5)
k_label_write(LabelGeom g, int32_t* labels, int32_t* roots,
              int32_t* counts) {
  __shared__ LabelWriteSmem s;
  const int HW = g.H * g.W;
  for_each_uf_tile(g.ty, g.active, [&](int b, int ty, int tx) {
    int y0 = ty * kUfTH, x0 = tx * kUfTW;
    int th = min(kUfTH, g.H - y0), tw = min(kUfTW, g.W - x0);
    long long off = b * (long long)HW;
    const volatile int32_t* L = labels + off - g.base;   // indexed by label
    // a tile with no foreground has nothing to do, one with no root
    // hooked away nothing to rewrite (only roots to count)
    int flag = g.flags != nullptr ? *tile_flag(g, b, ty * g.tx + tx)
                                  : kHooked;
    if (flag == kNoFg || (!kCount && flag == kFg)) return;
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the tile index of global index l, or -1 outside the tile
    auto local = [&](int l) {
      int y = (l - g.base) / g.W - y0, x = (l - g.base) % g.W - x0;
      return y >= 0 && y < th && x >= 0 && x < tw ? y * kUfTW + x : -1;
    };
#pragma unroll
    for (int k = 0; k < kUfRows; ++k)
#pragma unroll
      for (int c = 0; c < kUfCols; ++c) {
        int ly = warp + k * kUfWarps, lx = c * 32 + lane;
        s.lab[ly * kUfTW + lx] =
            ly < th && lx < tw ? labels[off + (long long)(y0 + ly) * g.W +
                                        x0 + lx]
                               : g.bg;
      }
    if (kCount && threadIdx.x < kUfTH) {
      s.rows[threadIdx.x] = 0;
      s.first[threadIdx.x] = g.bg;
    }
    __syncthreads();
    // the chains' ends: roots (counted), and roots hooked into another tile
#pragma unroll
    for (int k = 0; k < kUfRows; ++k)
#pragma unroll
      for (int c = 0; c < kUfCols; ++c) {
        int i = (warp + k * kUfWarps) * kUfTW + c * 32 + lane;
        int l = s.lab[i];
        if (l == g.bg) continue;   // background, or outside the frame
        int r = tile_global(g, y0, x0, i);
        if (l == r) {
          s.fin[i] = r;
          if (kCount) {
            atomicAdd(&s.rows[i / kUfTW], 1);
            atomicMin(&s.first[i / kUfTW], r);
          }
        } else if (local(l) < 0) {
          s.fin[i] = find_root(L, l);
        }
      }
    __syncthreads();
    if (kCount && threadIdx.x < th && s.rows[threadIdx.x]) {
      int r = b * g.R + (y0 + threadIdx.x) / g.band;
      atomicAdd(&counts[r], s.rows[threadIdx.x]);
      atomicMin(&roots[(long long)r * g.cap], s.first[threadIdx.x]);
    }
    if (flag == kHooked) {
#pragma unroll
      for (int k = 0; k < kUfRows; ++k)
#pragma unroll
        for (int c = 0; c < kUfCols; ++c) {
          int ly = warp + k * kUfWarps, i = ly * kUfTW + c * 32 + lane;
          int l = s.lab[i];
          if (l == g.bg) continue;
          int x = i;
          for (int j = local(s.lab[x]);
               j >= 0 && s.lab[x] != tile_global(g, y0, x0, x);
               j = local(s.lab[x]))
            x = j;
          if (s.fin[x] != l)
            labels[off + (long long)(y0 + ly) * g.W + x0 + c * 32 + lane] =
                s.fin[x];
        }
    }
    __syncthreads();
  });
}

// The foreground labels of B frames (mask u8 [B, H, W], nonzero =
// foreground -> labels int32 [B, H, W]) on stream st: 2 or 3 launches (no
// merge when the frame is one tile).  With kCount also counts int32 [B, R]
// (exact) and each band's first root in roots[b, r, 0] (of roots int32
// [B, R, cap]; H*W for none).  Returns the first CUDA error.
template <bool kCount>
int launch_tile_labels(const uint8_t* mask, int B, const LabelGeom& g,
                       int32_t* labels, int32_t* roots, int32_t* counts,
                       cudaStream_t st) {
  dim3 grid = uf_grid(g.tx, g.ty, g.active, B);
  for (const void* k : {(const void*)k_label_tiles<kCount>,
                        (const void*)k_label_write<kCount>}) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  k_label_tiles<kCount><<<grid, kUfThreads, 0, st>>>(g, mask, labels, roots,
                                                     counts);
  HD_CHECK();
  long long pairs =
      (long long)(g.ty - 1) * g.W + (long long)(g.tx - 1) * g.H;
  if (pairs > 0) {
    k_label_merge<<<edge_grid(pairs, g.active, B), 256, 0, st>>>(
        g, pairs, mask, labels);
    HD_CHECK();
  }
  k_label_write<kCount><<<grid, kUfThreads, 0, st>>>(g, labels, roots,
                                                     counts);
  HD_CHECK();
  return 0;
}

}  // namespace
