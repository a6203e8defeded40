// Device helpers shared by the port's kernels (fused_detect.cu,
// ccl_tiled.cu, stats_tiled.cu, runtable_tiled.cu): the 32 x 8 pixel
// mapping and its per-frame skip, warp run starts, union-find with atomicMin
// hooking and the background union-find of the hole fill, block scans and
// sums for 256-thread blocks, a search in a sorted root table, the slot-list
// writer, and the launch check of the entry points.  Each .cu that includes
// this file is its own library, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// In an entry point: return the error of the launch just queued, if any.
#define HD_CHECK()                                 \
  do {                                             \
    cudaError_t hd_err = cudaGetLastError();       \
    if (hd_err != cudaSuccess) return (int)hd_err; \
  } while (0)

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileW = 32;        // one warp = 32 consecutive pixels of a row
constexpr int kTileH = 8;         // 8 warps per block
constexpr int kScanThreads = 256; // block size of every scan/sum kernel
constexpr int kMaxSlots = 1024;   // largest K of the slot-incidence kernels
// Rows of tiles a block column covers at most when frames may be skipped
// (tile_grid): a skipped frame then costs few blocks, not one per tile.
constexpr int kSkipTileRows = 4;

// A frame batch as the entry points receive it: C = 1 (gray only) or 3
// (b, g, r at data + b*fstride + p*pstride + c*cstride).
struct Frames {
  const uint8_t* data;
  int C;
  long long fstride, cstride, pstride;
};

// Frame geometry; the band-tiled kernels also set the band layout: R =
// ceil(H / band) bands of `band` rows, the last one maybe shorter.  Planes
// are [B, H, W], unpadded.  With `active` (int32 [B] on the device) the
// kernels skip every frame b whose active[b] is 0 and leave its outputs
// unwritten: two routes share one set of outputs, each writing its frames,
// with no host sync to choose.
struct Geom {
  int H, W;
  long long HW;
  int band, R;
  const int* active = nullptr;
};

__device__ __forceinline__ bool frame_skipped(const Geom& g, int b) {
  return g.active != nullptr && g.active[b] == 0;
}

__device__ __forceinline__ long long band_lo(const Geom& g, int r) {
  return (long long)r * g.band * g.W;
}

__device__ __forceinline__ long long band_hi(const Geom& g, int r) {
  return (long long)min((r + 1) * g.band, g.H) * g.W;
}

struct Pix {
  int x, y, b, lane;
  bool in;
  long long p;   // linear index within the frame
};

// This thread's pixel in the tile of column blockIdx.x, tile row ty and
// frame blockIdx.z.
__device__ __forceinline__ Pix pix_at(const Geom& g, int ty) {
  Pix q;
  q.lane = threadIdx.x;
  q.x = blockIdx.x * kTileW + threadIdx.x;
  q.y = ty * kTileH + threadIdx.y;
  q.b = blockIdx.z;
  q.in = q.x < g.W && q.y < g.H;
  q.p = (long long)q.y * g.W + q.x;
  return q;
}

__device__ __forceinline__ Pix pix(const Geom& g) {
  return pix_at(g, blockIdx.y);
}

// Calls body(q) for every tile row this block covers: its own tile when no
// frame is skipped (the grid has one block per tile), else tile rows
// blockIdx.y, then steps of gridDim.y, unless the frame is skipped.  The
// first case keeps its own straight-line copy of body, which the band
// route's kernels run when called directly.  Every thread of the block
// runs the same rows, so body may use warp votes; a `return` in body ends
// that tile only.
template <typename Body>
__device__ __forceinline__ void for_each_tile(const Geom& g, Body body) {
  if (g.active == nullptr) {
    body(pix(g));
    return;
  }
  if (g.active[blockIdx.z] == 0) return;
  int rows = (g.H + kTileH - 1) / kTileH;
  for (int ty = blockIdx.y; ty < rows; ty += gridDim.y) body(pix_at(g, ty));
}

// Launch grid of the for_each_tile kernels: one block per tile, or, when
// frames may be skipped, at most kSkipTileRows tile rows per frame.
inline dim3 tile_grid(const Geom& g, int B) {
  int rows = (g.H + kTileH - 1) / kTileH;
  if (g.active != nullptr && rows > kSkipTileRows) rows = kSkipTileRows;
  return dim3((g.W + kTileW - 1) / kTileW, rows, B);
}

// Linear index of the first pixel of this lane's run of equal `v` within the
// warp's 32-pixel row segment.  Every lane of the warp must call it.
__device__ __forceinline__ int run_start(bool v, const Pix& q) {
  unsigned bits = __ballot_sync(kFull, v);
  unsigned starts = (bits ^ (bits << 1)) | 1u;
  unsigned upto = starts & ((2u << q.lane) - 1u);
  int start_lane = 31 - __clz(upto);
  return (int)(q.p - (q.lane - start_lane));
}

__device__ __forceinline__ int find_root(const volatile int32_t* P, int x) {
  int p = P[x];
  while (p != x) {
    x = p;
    p = P[x];
  }
  return x;
}

// Hook the larger root under the smaller one, so that every root is the
// minimum linear index of its tree.  A failed atomicMin means another thread
// re-parented b first: carry on with b's new parent.
__device__ void unite(int32_t* P, int a, int b) {
  while (true) {
    a = find_root(P, a);
    b = find_root(P, b);
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

// Hole fill, background 4-connected, over parents seeded with run starts
// (run_start).  Links inside a warp's row segment are already made by the
// run-start parents; an up link is skipped when the left and up-left pixels
// are background (their own links imply it).
__global__ void k_link_bg(Geom g, const uint8_t* fg, int32_t* parent) {
  for_each_tile(g, [&](Pix q) {
    if (!q.in) return;
    const uint8_t* m = fg + q.b * g.HW;
    int32_t* P = parent + q.b * g.HW;
    int p = (int)q.p;
    if (m[p]) return;
    bool left = q.x > 0 && !m[p - 1];
    if (left && q.lane == 0) unite(P, p, p - 1);
    if (q.y > 0 && !m[p - g.W] && !(left && !m[p - g.W - 1]))
      unite(P, p, p - g.W);
  });
}

// Compress background paths and flag the roots that touch the frame border
// (reach is zeroed beforehand); a background pixel is filled iff its root's
// flag stays 0.
template <typename Reach>
__global__ void k_compress_mark(Geom g, const uint8_t* fg, int32_t* parent,
                                Reach* reach) {
  for_each_tile(g, [&](Pix q) {
    if (!q.in) return;
    long long base = q.b * g.HW;
    if (fg[base + q.p]) return;
    int r = find_root(parent + base, (int)q.p);
    parent[base + q.p] = r;
    if (q.x == 0 || q.y == 0 || q.x == g.W - 1 || q.y == g.H - 1)
      reach[base + r] = 1;
  });
}

// Exclusive scan over a 256-thread block; *total gets the block's sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int all;
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sum[wid] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) {
      int s = warp_sum[w];
      warp_sum[w] = run;
      run += s;
    }
    all = run;
  }
  __syncthreads();
  int excl = incl - v + warp_sum[wid];
  *total = all;
  __syncthreads();
  return excl;
}

// Sum over a 256-thread block; the result is valid in thread 0.
__device__ int block_sum(int v) {
  __shared__ int part[kScanThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) part[wid] = v;
  __syncthreads();
  int t = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kScanThreads / 32; ++w) t += part[w];
  __syncthreads();
  return t;
}

// Position of `v` in the ascending table t[0..n), or -1.
__device__ __forceinline__ int find_slot(const int* t, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (t[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo < n && t[lo] == v ? lo : -1;
}

// One band's slot list from its presence flags pres[0..K): the present
// slots ascending, then the absent ones ascending; *count gets the number
// present.  Run by one thread.
__device__ void write_slot_list(const int* pres, int K, int32_t* list,
                                int32_t* count) {
  int c = 0;
  for (int k = 0; k < K; ++k)
    if (pres[k]) list[c++] = k;
  *count = c;
  for (int k = 0; k < K; ++k)
    if (!pres[k]) list[c++] = k;
}

}  // namespace
