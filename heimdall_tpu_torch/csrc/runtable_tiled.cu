// Run-table hole fill and labeling for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (heimdall_tpu_torch/ops/_cuda.py).
//
// Replaces the table-global route of heimdall_tpu for BGR frames over
// 400,000 px:
//   B2   preprocess_tiled.py::_make_preprocess_kernel with bg_tables (its
//        table emission; the preprocess itself is hd_preprocess of
//        fused_detect.cu) and
//   B3a  runtable_tiled.py::_make_extract_kernel: hd_run_extract;
//   B3b  _make_flood_fix_kernel: hd_flood_fix;
//   B3c  _make_fill_extract_kernel: hd_fill_extract;
//   B3d  _make_label_fix_kernel: hd_label_fix;
//   B3e  _make_writeback_kernel: hd_writeback.
//
// The tables are the JAX package's, kept so that each kernel can be held
// against it on its own.  Per row of a plane: runid u8 [B, H, W], the
// 1-based count of run starts at or before the column (it wraps at 256, so
// it is read only where the row fits its table); S / E int32 [B, H, R], the
// first and last column of the row's first R runs, with +2^20 / -2^20 in
// the slots past the row's run count; nrun int32 [B, H, 1], the exact count.
// As in the JAX kernel, the last slot of a row with more than R runs ends at
// S + (the row's run pixels from its R-th run on) - 1; such a row is never
// read, since its frame takes the band route.
//
// Design.  Extraction (hd_run_extract, and hd_fill_extract) runs a warp
// per row, 8 rows a 256-thread block, with no block barrier and no shared
// memory.  Each step of the row takes 512 columns: every lane loads its 16
// as one uint4 (rows whose width is not a multiple of 16 take 16 clamped
// byte loads), builds a 16-bit run mask, and gets its neighbours' edge bits
// by shuffles; run starts are own & ~(own << 1 | left) and ends the mirror
// image.  runid is a warp scan of the lanes' start counts plus the count
// carried from earlier steps, formed 16 bytes in registers and stored as
// one uint4.  The lanes holding the start or end of one of the first R
// runs write its slot; a warp reduction gives the tail of a row with more
// than R runs.  hd_fill_extract forms filled in the same registers: each
// lane holds the row's background flags as a 32-bit ballot (or reads F
// past 32 slots), looks a pixel's flag up by its background runid, stores
// filled once and extracts its runs without reading it back.  The
// TPU kernels find the fill and the labels as min-propagation fixpoints over
// the whole-frame tables; here each is one union-find over the frame's runs
// (node row * R + slot; runs of adjacent rows are joined where they overlap,
// 4-connected for the background, 8-connected for the foreground), spread
// over a cluster of 8 blocks per frame, each holding its rows' tables and
// parents in shared memory (135 x 8 nodes at 1080 rows: about 23 KB with
// the rest of the layout); the blocks meet through their first and last
// rows, which each copies from the others in one round, and the label fix
// also ranks the roots and writes the per-band slot incidence in the same
// launch.  A root is the smallest node of its tree, which is also the run
// with the smallest row * W + S, so the label of a run is read off its
// root.  Frames whose blocks' tables exceed shared memory take one block
// per frame over global scratch.
//
// Every kernel takes an optional `active` (int32 [B]): frames whose flag is
// 0 are skipped and their outputs left unwritten, so the density guards of
// JAX's fill_label_runtable_tiled (a row with more than R runs) send a frame
// to the band route of ccl_tiled.cu, into the same outputs, without a host
// sync.
//
// What bounds them on an H100 SXM: bytes, per 1920x1080 frame at 3.35
// TB/s.  Extraction reads the plane and writes runid and the tables
// (~4.2 MB, 1.3 us); the fill reads binary, runid and the flags and writes
// filled, runid and the tables (~8.4 MB, 2.5 us); the writeback reads
// filled and runid and writes int32 labels (~12.5 MB, 3.7 us); the two
// union-finds read and write tables of 1080 x 8 slots (~0.1 MB, 0.03 us),
// where chains of dependent shared-memory accesses and the cluster's two
// barriers, not bytes, bound them: the cluster spreads a frame over 8
// blocks so that a batch fills the card.

#include <cooperative_groups.h>

#include <initializer_list>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBig = 1 << 20;     // S / E of a slot past the row's runs
constexpr int kLaneCols = 16;    // columns a lane takes per step: one uint4
constexpr int kStepCols = 32 * kLaneCols;   // columns a warp takes per step
constexpr int kRowWarps = kScanThreads / 32;  // rows a block takes

// Word k of a uint4, k a compile-time constant once unrolled.
__device__ __forceinline__ unsigned word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Bit i: byte i of the 16 is nonzero.
__device__ __forceinline__ unsigned nonzero_bits(const uint4& v) {
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned m = __vcmpne4(word(v, k), 0u) & 0x01010101u;
    bits |= ((m * 0x01020408u) >> 24) << (4 * k);  // bytes 0..3 -> bits 0..3
  }
  return bits;
}

// Bits 4k .. 4k + 3 of `bits` as the bytes (0 or 1) of one word.
__device__ __forceinline__ unsigned nibble_bytes(unsigned bits, int k) {
  return ((bits >> (4 * k) & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Byte i = bit i of `bits` (0 or 1).
__device__ __forceinline__ uint4 bit_bytes(unsigned bits) {
  return make_uint4(nibble_bytes(bits, 0), nibble_bytes(bits, 1),
                    nibble_bytes(bits, 2), nibble_bytes(bits, 3));
}

// Byte i = (base + the set bits of `starts` at or below bit i) mod 256.
__device__ __forceinline__ uint4 runid_bytes(unsigned starts, int base) {
  unsigned acc = (unsigned)(base & 0xFF) * 0x01010101u, w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {   // byte j of s * 0x01010101: bytes 0..j of s
    w[k] = __vadd4(acc, nibble_bytes(starts, k) * 0x01010101u);
    acc = __byte_perm(w[k], 0, 0x3333);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bit i: column c + i lies in the row of W columns.
__device__ __forceinline__ unsigned col_mask(int c, int W) {
  int n = W - c;
  return n >= kLaneCols ? 0xFFFFu : n <= 0 ? 0u : (1u << n) - 1u;
}

// Columns c .. c + 15 of a row of W bytes.  kVec (W % 16 == 0, the row
// 16-byte aligned, c % 16 == 0): one 16-byte load, its address clamped into
// the row; else 16 byte loads, each clamped.  No load is predicated, so all
// of them issue together; columns past W are masked by the caller.
template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* row, int c, int W) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(row + min(c, W - kLaneCols)));
  } else {
    unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i)
      w[i / 4] |= (unsigned)__ldg(row + min(c + i, W - 1)) << (8 * (i % 4));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Stores the bytes of v at columns c .. c + 15 that lie in the row.
template <bool kVec>
__device__ __forceinline__ void store16(uint8_t* row, int c, int W,
                                        const uint4& v) {
  if constexpr (kVec) {
    if (c < W) *reinterpret_cast<uint4*>(row + c) = v;
  } else {
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i)
      if (c + i < W) row[c + i] = (uint8_t)(word(v, i / 4) >> (8 * (i % 4)));
  }
}

// k_run_extract's row: the runs are the columns whose byte is nonzero, or
// with invert zero.
struct PlaneRow {
  using Raw = uint4;
  const uint8_t* row;
  int W;
  unsigned flip;    // 0xFFFF with invert
  template <bool kVec>
  __device__ Raw load(int c) const { return load16<kVec>(row, c, W); }
  template <bool kVec>
  __device__ unsigned bits(const Raw& v, int c) const {
    return (nonzero_bits(v) ^ flip) & col_mask(c, W);
  }
};

// k_fill_extract's row: filled = binary, or the background run's flag F
// (1: not reached from the border), stored as it is formed; the runs are
// its foreground.  With Rbg <= 32 every lane holds the row's flags as the
// bits of `fmask` (bit j: F[j] != 0); past that they are read from F.
struct FillRow {
  struct Raw {
    uint4 bin, rid;
  };
  const uint8_t* bin;
  const uint8_t* rid;
  const int32_t* F;
  uint8_t* out;
  int W, Rbg;
  unsigned fmask;
  template <bool kVec>
  __device__ Raw load(int c) const {
    return {load16<kVec>(bin, c, W), load16<kVec>(rid, c, W)};
  }
  // The flag slot of column c + i's background run: runid - 1, clamped.
  __device__ __forceinline__ int slot(const uint4& ids, int i) const {
    return min(max((int)(word(ids, i / 4) >> (8 * (i % 4)) & 0xFFu) - 1, 0),
               Rbg - 1);
  }
  template <bool kVec>
  __device__ unsigned bits(const Raw& v, int c) const {
    unsigned hole = 0;
    if (Rbg <= 32) {
#pragma unroll
      for (int i = 0; i < kLaneCols; ++i)
        hole |= (fmask >> slot(v.rid, i) & 1u) << i;
    } else {
#pragma unroll
      for (int i = 0; i < kLaneCols; ++i)
        hole |= (unsigned)(F[slot(v.rid, i)] != 0) << i;
    }
    unsigned filled = (nonzero_bits(v.bin) | hole) & col_mask(c, W);
    store16<kVec>(out, c, W, bit_bytes(filled));
    return filled;
  }
};

// One lane's columns c .. c + 15 of a step: writes the slots of the first R
// runs that start or end there, and adds its run pixels from the R-th run on
// to `tail`.  base: the runs started before column c.  Slot R - 1 is kept
// in sR / eR, for the row's last write.
__device__ __forceinline__ void lane_slots(unsigned own, unsigned starts,
                                           unsigned ends, int base, int c,
                                           int R, int32_t* S, int32_t* E,
                                           int& tail, int& sR, int& eR) {
  if (base >= R) tail += __popc(own);
  if (base > R) return;
  int id = base;
  for (unsigned m = starts | ends; m; m &= m - 1) {
    int i = __ffs(m) - 1;
    if (starts >> i & 1u) {
      if (++id > R) return;
      if (id < R) {
        S[id - 1] = c + i;
      } else {
        sR = c + i;
        tail += __popc(own >> i);
      }
    }
    if (ends >> i & 1u) {
      if (id < R) E[id - 1] = c + i;
      else eR = c + i;
    }
  }
}

// The run tables of one row, by one warp, with no block barrier.  Each step
// takes 512 columns, 16 a lane: the lane's run mask `own` comes from
// src.bits; the neighbours' edge bits come by shuffles (the last lane's right
// neighbour from the next step, loaded before this step's work, and the
// first lane's left one carried from the last step); runid is a warp scan of
// the run starts plus the carry, stored as 16 bytes.
template <bool kVec, typename Row>
__device__ void extract_row(const Row& src, int W, int R, uint8_t* runid,
                            int32_t* S, int32_t* E, int32_t* nrun) {
  const int lane = threadIdx.x & 31;
  int carry = 0;          // runs started in earlier steps
  unsigned left = 0;      // the last column of the previous step is in a run
  int tail = 0, sR = -1, eR = -1;
  int c = lane * kLaneCols;
  unsigned own = src.template bits<kVec>(src.template load<kVec>(c), c);
  for (int c0 = 0; c0 < W; c0 += kStepCols, c += kStepCols) {
    const bool more = c0 + kStepCols < W;
    typename Row::Raw next{};
    if (more) next = src.template load<kVec>(c + kStepCols);
    unsigned up = __shfl_up_sync(kFull, own >> 15, 1);
    if (lane == 0) up = left;
    unsigned starts = own & ~((own << 1) | up) & 0xFFFFu;
    int n = __popc(starts), incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    int base = carry + incl - n;
    store16<kVec>(runid, c, W, runid_bytes(starts, base));
    unsigned next_own = more ? src.template bits<kVec>(next, c + kStepCols)
                             : 0u;
    unsigned down = __shfl_down_sync(kFull, own & 1u, 1);
    unsigned first = __shfl_sync(kFull, next_own & 1u, 0);
    if (lane == 31) down = first;
    unsigned ends = own & ~((own >> 1) | (down << 15));
    lane_slots(own, starts, ends, base, c, R, S, E, tail, sR, eR);
    carry += __shfl_sync(kFull, incl, 31);
    left = __shfl_sync(kFull, own >> 15, 31);
    own = next_own;
  }
  tail = __reduce_add_sync(kFull, tail);
  sR = __reduce_max_sync(kFull, sR);
  eR = __reduce_max_sync(kFull, eR);
  for (int j = carry + lane; j < R; j += 32) {
    S[j] = kBig;
    E[j] = -kBig;
  }
  if (lane == 0) {
    *nrun = carry;
    if (carry >= R) {
      S[R - 1] = sR;
      E[R - 1] = carry > R ? sR + tail - 1 : eR;
    }
  }
}

// A warp per (row, frame), kRowWarps rows a block.
template <bool kVec>
__global__ void k_run_extract(const uint8_t* plane, int invert, int H, int W,
                              int R, const int* active, uint8_t* runid,
                              int32_t* S, int32_t* E, int32_t* nrun) {
  int y = blockIdx.x * kRowWarps + (threadIdx.x >> 5), b = blockIdx.y;
  if (y >= H || (active != nullptr && active[b] == 0)) return;
  long long row = (long long)b * H + y;
  PlaneRow src{plane + row * W, W, invert ? 0xFFFFu : 0u};
  extract_row<kVec>(src, W, R, runid + row * W, S + row * R, E + row * R,
                    nrun + row);
}

// A warp per (row, frame): filled = binary, or the background run's flag
// (1: not reached from the border), then the run tables of filled, from the
// same registers.
template <bool kVec>
__global__ void k_fill_extract(int H, int W, int Rbg, int Rfg,
                               const int* active, const uint8_t* binary,
                               const uint8_t* runid_bg, const int32_t* F,
                               uint8_t* filled, uint8_t* runid_fg,
                               int32_t* S, int32_t* E, int32_t* nrun) {
  int y = blockIdx.x * kRowWarps + (threadIdx.x >> 5), b = blockIdx.y;
  if (y >= H || (active != nullptr && active[b] == 0)) return;
  long long row = (long long)b * H + y;
  const int32_t* flag = F + row * Rbg;
  int lane = threadIdx.x & 31;
  unsigned fmask = __ballot_sync(kFull, lane < Rbg &&
                                            flag[min(lane, Rbg - 1)] != 0);
  FillRow src{binary + row * W, runid_bg + row * W, flag, filled + row * W,
              W, Rbg, fmask};
  extract_row<kVec>(src, W, Rfg, runid_fg + row * W, S + row * Rfg,
                    E + row * Rfg, nrun + row);
}

// ------------------------------------------------ the union-finds (B3b, B3d)
//
// Both fixes unite the valid runs of a frame's tables S / E [H, R]: node
// y * R + k is slot k of row y, and runs of adjacent rows are united where
// [S - dilate, E + dilate] meets the other's [S, E] (dilate 0: 4-connected,
// the background; 1: 8-connected, the foreground).  Every root is the
// smallest node of its tree, which is also its component's run with the
// smallest row * W + S (in a row the slots are sorted by S), so no result
// depends on the order of the unions.
//
// A frame is a cluster of kFixCluster blocks.  Block c owns rows
// [c * H / kFixCluster, (c + 1) * H / kFixCluster) (none when H is below the
// cluster) and stages them in its shared memory with the row above its
// first: S and E, 16 bytes a load.  On the card a dependent load through
// the cluster's window into another block takes ~700 cycles idle and
// several thousand under load, against 30-60 in a block's own shared
// memory, so a block reads other blocks' memory once, in one parallel
// round, and never walks a parent chain across blocks:
//   1. inside the block, a thread per row gives each run the first run of
//      the row above that it meets as its parent (two pointers over the
//      sorted runs; a forest whose roots are its trees' smallest nodes),
//      pointer jumping makes every parent a root, the rows' other meetings
//      unite roots (atomicMin, larger under smaller), and pointer jumping
//      runs again: every run then points at its local root;
//   2. the block publishes its first and last rows: each run's S, E, local
//      root and what the fix needs of it (the flood fix: whether the local
//      component reaches the border; the label fix: its root's row * W + S
//      and rank among the block's local roots), and its local root count;
//   3. after a cluster barrier every block copies all blocks' rows and
//      unites them in a small union-find of its own: a block's published
//      runs that share a local root, and the runs that meet across each
//      block edge.  Each
//      component's smallest local root, reach and row * W + S are then
//      known to every block, and so are the global root count and each
//      block's first rank.
// The flood fix writes F from its local roots' reach.  The label fix writes
// L and each run's slot, ranks its roots (local rank less the earlier
// local roots that another block's root absorbed), writes the root table
// and count, and sets each run's slot in its band's presence mask, held by
// the block that holds the band's first row; after a second cluster barrier
// a warp per band writes its slot list.  No block leaves while another may
// still read its shared memory.
//
// A frame whose blocks' tables exceed shared memory takes the global-scratch
// kernels further down: one block per frame, the parents in global memory.

constexpr int kFixCluster = 8;   // blocks a frame: the portable cluster size
// Ints a published run takes: S, E, local root, reach or row * W + S of the
// local root, the local root's rank among the block's local roots.
constexpr int kDescInts = 5;

// A fix block's shared memory in 32-bit words, the same in every block of a
// launch: the staged S and E (the row above, then the block's rows, moved
// by up to 3 words to share the tables' 16-byte alignment); per node the
// parent, the rank (first a list of the valid runs) and the label value;
// the published rows and count, and the copies of every block's (runs,
// then counts); the boundary union-find (parents, 64-bit minima, the
// component's value, the absorbed roots); the band presence masks; then a
// byte per node (the flood fix's reach, the label fix's final-root flag).
struct FixLayout {
  int rows, tab, nodes, ents, desc, copy, V, bands, words;
  __host__ __device__ FixLayout(int H, int R, int band, int K) {
    rows = (H + kFixCluster - 1) / kFixCluster;
    tab = ((rows + 1) * R + 6) & ~3;
    nodes = (rows * R + 3) & ~3;
    ents = 2 * R * kDescInts;
    desc = (ents + 1 + 3) & ~3;
    copy = (kFixCluster * (ents + 1) + 3) & ~3;
    V = kFixCluster * 2 * R;
    bands = band > 0 ? rows / band + 2 : 0;
    words = (K + 31) / 32;
  }
  __host__ __device__ int rank_at() const { return 2 * tab + nodes; }
  __host__ __device__ int val_at() const { return rank_at() + nodes; }
  __host__ __device__ int desc_at() const { return val_at() + nodes; }
  __host__ __device__ int copy_at() const { return desc_at() + desc; }
  __host__ __device__ int uf_at() const { return copy_at() + copy; }
  __host__ __device__ int min_at() const { return uf_at() + V; }  // 8-aligned
  __host__ __device__ int cval_at() const { return min_at() + 2 * V; }
  __host__ __device__ int nf_at() const { return cval_at() + V; }
  __host__ __device__ int pres_at() const { return nf_at() + V; }
  __host__ __device__ int byte_at() const {
    return pres_at() + bands * words;
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)byte_at() * 4 + nodes;
  }
};

__device__ __forceinline__ int32_t* fix_smem() {
  extern __shared__ __align__(16) int32_t fix_raw[];
  return fix_raw;
}

// Copies src[lo, hi) to dst[lo, hi) (int32; dst and src agree mod 16
// bytes), 16 bytes a load where both are aligned.
__device__ void stage_words(int32_t* dst, const int32_t* src, int lo,
                            int hi) {
  int t = threadIdx.x, nt = blockDim.x;
  int a = min(hi, lo + (int)((4 - ((uintptr_t)(src + lo) >> 2)) & 3));
  int z = a + (hi - a) / 4 * 4;
  for (int j = lo + t; j < a; j += nt) dst[j] = __ldg(src + j);
  for (int j = a + 4 * t; j < z; j += 4 * nt)
    *reinterpret_cast<int4*>(dst + j) =
        __ldg(reinterpret_cast<const int4*>(src + j));
  for (int j = z + t; j < hi; j += nt) dst[j] = __ldg(src + j);
}

// Calls meet(i, j, first) for each run i of row s1 / e1 that meets run j of
// row s0 / e0 (first: j is the first run of s0 that i meets), walking the
// two sorted rows with two pointers; run i's S is s1[i * step].
template <typename Meet>
__device__ __forceinline__ void meetings(const int32_t* s1, const int32_t* e1,
                                         const int32_t* s0, const int32_t* e0,
                                         int step, int R, int dilate,
                                         Meet meet) {
  int i = 0, j = 0, given = -1;
  while (i < R && j < R) {
    int s = s1[i * step], su = s0[j * step];
    if (s >= kBig || su >= kBig) return;
    int e = e1[i * step], eu = e0[j * step];
    if (su - dilate <= e && eu + dilate >= s) {
      meet(i, j, given != i);
      given = i;
    }
    if (e < eu) ++i;
    else ++j;
  }
}

// One block's part of its frame's cluster.  Parents hold the block's node
// indices (node g0 + i is index i).
struct FixBlock {
  cg::cluster_group cluster;
  FixLayout lay;
  int H, W, R;
  int c, y0, n, g0;       // rank, first row, rows, first node
  long long base;         // the frame's first table entry
  int32_t* raw;           // the layout's start
  int32_t *S, *E, *P;     // the block's rows (S[-R, 0): the row above)

  __device__ FixBlock(int H_, int W_, int R_, int band, int K,
                      const int32_t* Sg, const int32_t* Eg)
      : cluster(cg::this_cluster()), lay(H_, R_, band, K), H(H_), W(W_),
        R(R_) {
    c = (int)cluster.block_rank();
    y0 = first_row(c);
    n = first_row(c + 1) - y0;
    g0 = y0 * R;
    base = (long long)blockIdx.y * H * R;
    raw = fix_smem();
    S = raw + shift(Sg) + R;
    E = raw + lay.tab + shift(Eg) + R;
    P = raw + 2 * lay.tab;
  }
  __device__ int first_row(int o) const {
    return (int)((long long)o * H / kFixCluster);
  }
  __device__ int owner(int y) const {
    return (int)((((long long)y + 1) * kFixCluster - 1) / H);
  }
  // Words the staged rows are moved by, for the table at t.
  __device__ int shift(const int32_t* t) const {
    return (int)((((uintptr_t)t >> 2) + base + g0 - R) & 3);
  }
  __device__ bool valid(int i) const { return S[i] < kBig; }
  // Index of node i's local root (once step 1 is done).
  __device__ int root(int i) const { return P[i]; }
  __device__ int32_t* desc() const { return raw + lay.desc_at(); }

  // S and E of the row above and the block's rows.
  __device__ void stage(const int32_t* Sg, const int32_t* Eg) {
    int lo = y0 > 0 && n > 0 ? -R : 0, hi = n * R;
    stage_words(S, Sg + base + g0, lo, hi);
    stage_words(E, Eg + base + g0, lo, hi);
    if (y0 == 0)
      for (int k = threadIdx.x; k < R; k += blockDim.x) {
        S[k - R] = kBig;
        E[k - R] = -kBig;
      }
  }
  // The block's valid runs in raster order at list[0, m); returns m.
  __device__ int list_runs(int32_t* list) {
    int q = (n + blockDim.x - 1) / blockDim.x;
    int lo = min(n, (int)threadIdx.x * q), hi = min(n, lo + q), cnt = 0;
    for (int i = lo * R; i < hi * R; ++i) cnt += valid(i);
    int m;
    int pos = block_exclusive_scan(cnt, &m);
    for (int i = lo * R; i < hi * R; ++i)
      if (valid(i)) list[pos++] = i;
    __syncthreads();
    return m;
  }
  // Pointer jumping over the listed runs until every parent is a root.
  __device__ void jump(const int32_t* list, int m) {
    while (true) {
      int changed = 0;
      for (int t = threadIdx.x; t < m; t += blockDim.x) {
        int i = list[t], q = P[i];
        if (q == i) continue;
        int r = P[q];
        if (r != q) {
          P[i] = r;
          changed = 1;
        }
      }
      if (!__syncthreads_or(changed)) return;
    }
  }
  // Step 1 (see above): every node's parent becomes its local root.
  // list: scratch of the layout's nodes.
  __device__ void local_roots(int dilate, int32_t* list) {
    for (int y = threadIdx.x; y < n; y += blockDim.x) {
      int32_t* p = P + y * R;
      for (int k = 0; k < R; ++k) p[k] = y * R + k;
      if (y > 0)
        meetings(S + y * R, E + y * R, S + (y - 1) * R, E + (y - 1) * R, 1,
                 R, dilate, [&](int i, int j, bool first) {
                   if (first) p[i] = (y - 1) * R + j;
                 });
    }
    __syncthreads();
    int m = list_runs(list);
    jump(list, m);
    int united = 0;
    for (int y = threadIdx.x + 1; y < n; y += blockDim.x)
      meetings(S + y * R, E + y * R, S + (y - 1) * R, E + (y - 1) * R, 1, R,
               dilate, [&](int i, int j, bool first) {
                 if (first) return;
                 unite(P, y * R + i, (y - 1) * R + j);
                 united = 1;
               });
    if (__syncthreads_or(united)) jump(list, m);
  }
  // Step 2: the block's first and last rows, with each run's local root (a
  // frame node), value(its index) and rank[its index] (rank: optional),
  // and the local root count.
  template <typename Value>
  __device__ void publish(const int32_t* rank, int count, Value value) {
    int32_t* d = desc();
    for (int t = threadIdx.x; t < 2 * R; t += blockDim.x) {
      int32_t* e = d + t * kDescInts;
      int i = (t < R ? 0 : n - 1) * R + t % R;
      e[0] = n > 0 ? S[i] : kBig;
      if (n == 0 || !valid(i)) continue;
      e[1] = E[i];
      e[2] = g0 + root(i);
      e[3] = value(root(i));
      e[4] = rank != nullptr ? rank[root(i)] : 0;
    }
    if (threadIdx.x == 0) d[2 * R * kDescInts] = count;
  }
};

// Step 3: every block's published rows, copied from the cluster, and their
// union-find.  Run v is slot v % R of block v / (2R)'s first row (v % 2R <
// R) or last row.
struct Boundary {
  FixBlock& f;
  int32_t* copy;                 // [V][kDescInts], then [kFixCluster] counts
  int32_t* uf;                   // [V] parents
  unsigned long long* lo;        // [V] at a root: (smallest root << 32) | v
  int32_t* cval;                 // [V] at a root: the component's value
  int32_t* nf;                   // [V] 1: the first run of an absorbed root
  int V;

  __device__ explicit Boundary(FixBlock& f_)
      : f(f_), copy(f_.raw + f_.lay.copy_at()), uf(f_.raw + f_.lay.uf_at()),
        lo(reinterpret_cast<unsigned long long*>(f_.raw + f_.lay.min_at())),
        cval(f_.raw + f_.lay.cval_at()), nf(f_.raw + f_.lay.nf_at()),
        V(f_.lay.V) {}
  __device__ const int32_t* at(int v) const { return copy + v * kDescInts; }
  __device__ bool valid(int v) const { return at(v)[0] < kBig; }
  __device__ int local_root(int v) const { return at(v)[2]; }
  __device__ int count(int o) const { return copy[V * kDescInts + o]; }

  // Copies the published rows (one round of loads through the cluster's
  // window), unites them, and reduces each component's smallest root and
  // its value with `reduce` (atomicMin or atomicOr on cval, from `init`).
  template <typename Reduce>
  __device__ void solve(int dilate, int init, Reduce reduce) {
    int ents = f.lay.ents;
    for (int t = threadIdx.x; t < kFixCluster * (ents + 1); t += blockDim.x) {
      int o = t / (ents + 1), k = t - o * (ents + 1);
      int x = f.cluster.map_shared_rank(f.desc(), o)[k];
      if (k < ents) copy[o * ents + k] = x;
      else copy[V * kDescInts + o] = x;
    }
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      uf[v] = v;
      lo[v] = ~0ull;
      cval[v] = init;
      nf[v] = 0;
    }
    __syncthreads();
    int R = f.R;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      if (!valid(v)) continue;
      for (int u = v - v % (2 * R); u < v; ++u)   // the block's first run
        if (valid(u) && local_root(u) == local_root(v)) {   // of that root
          unite(uf, v, u);
          break;
        }
    }
    for (int o = threadIdx.x; o < kFixCluster; o += blockDim.x) {
      int y = f.first_row(o);
      if (y == 0 || f.first_row(o + 1) == y) continue;
      int p = f.owner(y - 1);     // the block of the row above
      const int32_t* top = at(o * 2 * R);
      const int32_t* above = at(p * 2 * R + R);
      meetings(top, top + 1, above, above + 1, kDescInts, R, dilate,
               [&](int i, int j, bool) {
                 unite(uf, o * 2 * R + i, p * 2 * R + R + j);
               });
    }
    __syncthreads();
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      if (!valid(v)) continue;
      int r = find_root(uf, v);
      uf[v] = r;
      atomicMin(lo + r, (unsigned long long)local_root(v) << 32 | v);
      reduce(cval + r, at(v)[3]);
    }
    __syncthreads();
  }
  // The component's smallest local root, and its run.
  __device__ int min_root(int v) const { return (int)(lo[uf[v]] >> 32); }
  __device__ int min_run(int v) const {
    return (int)(lo[uf[v]] & 0xFFFFFFFFu);
  }
};

// A cluster per frame: F = 0 for the background runs 4-connected to a run
// on the first or last row or touching the first or last column, else 1
// (invalid slots included).
__global__ void __launch_bounds__(kScanThreads)
    k_flood_fix(int H, int W, int R, const int* active, const int32_t* S,
                const int32_t* E, int32_t* F) {
  if (active != nullptr && active[blockIdx.y] == 0) return;
  FixBlock f(H, W, R, 0, 0, S, E);
  uint8_t* reach = reinterpret_cast<uint8_t*>(f.raw + f.lay.byte_at());
  int N = f.n * R;
  f.stage(S, E);
  for (int i = threadIdx.x; i < N; i += blockDim.x) reach[i] = 0;
  __syncthreads();
  f.local_roots(0, f.raw + f.lay.rank_at());
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    int y = f.y0 + i / R;
    if (f.valid(i) &&
        (y == 0 || y == H - 1 || f.S[i] == 0 || f.E[i] == W - 1))
      reach[f.root(i)] = 1;
  }
  __syncthreads();
  f.publish(nullptr, 0, [&](int r) { return (int)reach[r]; });
  f.cluster.sync();
  Boundary bd(f);
  bd.solve(0, 0, [](int32_t* a, int v) { atomicOr(a, v); });
  f.cluster.sync();      // every block has copied the published rows
  for (int v = f.c * 2 * R + threadIdx.x; v < (f.c + 1) * 2 * R;
       v += blockDim.x)
    if (bd.valid(v)) reach[bd.local_root(v) - f.g0] = bd.cval[bd.uf[v]];
  __syncthreads();
  int32_t* out = F + f.base + f.g0;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    out[i] = f.valid(i) && reach[f.root(i)] ? 0 : 1;
}

// One band's slot list from its presence mask (K bits), by one warp: the
// present slots ascending, then the absent ones; *count the present ones.
__device__ void warp_slot_list(const unsigned* pres, int K, int32_t* list,
                               int32_t* count) {
  int lane = threadIdx.x & 31, words = (K + 31) / 32;
  unsigned lt = (1u << lane) - 1u;
  int n = 0;
  for (int w = lane; w < words; w += 32) n += __popc(pres[w]);
  n = __reduce_add_sync(kFull, n);
  int present = 0, absent = 0;
  for (int w = 0; w < words; ++w) {
    unsigned bits = pres[w];
    int k = 32 * w + lane, np = __popc(bits);
    if (k < K)
      list[bits >> lane & 1u ? present + __popc(bits & lt)
                             : n + absent + __popc(~bits & lt)] = k;
    present += np;
    absent += min(32, K - 32 * w) - np;
  }
  if (lane == 0) *count = n;
}

// A cluster per frame: L = row * W + S of the run's component root (H*W in
// invalid slots), the first K roots in raster order (padded with H*W), the
// root count, and each band's slot list (present slots ascending, then the
// absent ones) and count.
__global__ void __launch_bounds__(kScanThreads)
    k_label_fix(int H, int W, int R, int band, int K, const int* active,
                const int32_t* S, const int32_t* E, int32_t* L, int32_t* rl,
                int32_t* nblobs, int32_t* slot_list, int32_t* slot_count) {
  __shared__ int s_first[kFixCluster + 1];   // each block's first rank
  int b = blockIdx.y;
  if (active != nullptr && active[b] == 0) return;
  FixBlock f(H, W, R, band, K, S, E);
  const FixLayout& lay = f.lay;
  int32_t* rank = f.raw + lay.rank_at();
  int32_t* val = f.raw + lay.val_at();
  unsigned* pres = reinterpret_cast<unsigned*>(f.raw + lay.pres_at());
  uint8_t* fin = reinterpret_cast<uint8_t*>(f.raw + lay.byte_at());
  int N = f.n * R, HW = H * W, Rb = (H + band - 1) / band, g0 = f.g0;
  int blo = f.y0 / band;
  int nb = f.n > 0 ? (f.y0 + f.n - 1) / band - blo + 1 : 0;
  f.stage(S, E);
  for (int i = threadIdx.x; i < nb * lay.words; i += blockDim.x) pres[i] = 0;
  __syncthreads();
  f.local_roots(1, rank);
  // local roots ranked in raster order over each thread's chunk of nodes
  int q = (N + blockDim.x - 1) / blockDim.x;
  int lo = min(N, (int)threadIdx.x * q), hi = min(N, lo + q), cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += f.valid(i) && f.root(i) == i;
  int count;
  int r = block_exclusive_scan(cnt, &count);
  for (int i = lo; i < hi; ++i)
    if (f.valid(i) && f.root(i) == i) {
      rank[i] = r++;
      val[i] = (f.y0 + i / R) * W + f.S[i];
      fin[i] = 1;
    }
  __syncthreads();
  f.publish(rank, count, [&](int x) { return val[x]; });
  f.cluster.sync();
  Boundary bd(f);
  bd.solve(1, 0x7FFFFFFF, [](int32_t* a, int v) { atomicMin(a, v); });
  // absorbed roots: the first run of each local root whose component's
  // smallest root is another block's or an earlier one
  int V2 = 2 * R;
  for (int v = threadIdx.x; v < lay.V; v += blockDim.x) {
    if (!bd.valid(v) || bd.min_root(v) == bd.local_root(v)) continue;
    bool first = true;
    for (int u = v - v % V2; u < v && first; ++u)
      first = !(bd.valid(u) && bd.local_root(u) == bd.local_root(v));
    bd.nf[v] = first;
  }
  __syncthreads();
  if (threadIdx.x < 32) {     // each block's first rank: earlier final roots
    int lane = threadIdx.x, kept = 0;
    if (lane < kFixCluster) {
      kept = bd.count(lane);
      for (int v = lane * V2; v < (lane + 1) * V2; ++v) kept -= bd.nf[v];
    }
    int incl = kept;
    for (int d = 1; d < 32; d <<= 1) {
      int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane <= kFixCluster) s_first[lane] = incl - kept;
  }
  __syncthreads();
  // The rank of root x of block o whose local rank is lr.
  auto final_rank = [&](int o, int x, int lr) {
    int k = s_first[o] + lr;
    for (int v = o * V2; v < (o + 1) * V2; ++v)
      k -= bd.nf[v] && bd.local_root(v) < x;
    return k;
  };
  for (int v = f.c * V2 + threadIdx.x; v < (f.c + 1) * V2; v += blockDim.x) {
    if (!bd.valid(v) || bd.min_root(v) == bd.local_root(v)) continue;
    int x = bd.min_root(v), u = bd.min_run(v), i = bd.local_root(v) - g0;
    fin[i] = 0;
    val[i] = bd.cval[bd.uf[v]];
    rank[i] = final_rank(u / V2, x, bd.at(u)[4]);
  }
  __syncthreads();
  int total = s_first[kFixCluster];
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    if (f.valid(i) && f.root(i) == i && fin[i]) {
      int k = final_rank(f.c, g0 + i, rank[i]);
      rank[i] = k;
      if (k < K) rl[(long long)b * K + k] = val[i];
    }
  if (f.c == 0) {
    for (int k = total + threadIdx.x; k < K; k += blockDim.x)
      rl[(long long)b * K + k] = HW;
    if (threadIdx.x == 0) nblobs[b] = total;
  }
  __syncthreads();
  int32_t* Lf = L + f.base + g0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (!f.valid(i)) {
      Lf[i] = HW;
      continue;
    }
    int root = f.root(i), k = rank[root];
    Lf[i] = val[root];
    if (k < K)
      atomicOr(pres + ((f.y0 + i / R) / band - blo) * lay.words + (k >> 5),
               1u << (k & 31));
  }
  __syncthreads();
  // the first band's bits go to the block holding its first row, when
  // that is an earlier block
  if (nb > 0 && blo * band < f.y0) {
    int o = f.owner(blo * band);
    unsigned* dst = f.cluster.map_shared_rank(pres, o) +
                    (blo - f.first_row(o) / band) * lay.words;
    for (int w = threadIdx.x; w < lay.words; w += blockDim.x)
      if (pres[w]) atomicOr(dst + w, pres[w]);
  }
  f.cluster.sync();
  // the slot lists of the bands whose first row is this block's
  int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int rb = (f.y0 + band - 1) / band + warp;
       f.n > 0 && rb * band < f.y0 + f.n; rb += warps)
    warp_slot_list(pres + (rb - blo) * lay.words, K,
                   slot_list + ((long long)b * Rb + rb) * K,
                   slot_count + (long long)b * Rb + rb);
}

// ---------------------------------------------- global-scratch union-finds

// Union-find over the valid runs of one frame's tables S / E [H, R] by one
// block, the parents P in global scratch (see above).  Ends synchronised.
__device__ void link_runs(const int32_t* S, const int32_t* E, int H, int R,
                          int dilate, int32_t* P) {
  int N = H * R;
  for (int n = threadIdx.x; n < N; n += blockDim.x) P[n] = n;
  __syncthreads();
  for (int n = R + threadIdx.x; n < N; n += blockDim.x) {
    int s = S[n], e = E[n];
    if (s >= kBig) continue;
    int up = n - n % R - R;
    for (int k = 0; k < R && S[up + k] < kBig; ++k)
      if (S[up + k] - dilate <= e && E[up + k] + dilate >= s)
        unite(P, n, up + k);
  }
  __syncthreads();
}

// k_flood_fix with one block per frame and the parents and marks in global
// scratch.
__global__ void k_flood_scratch(int H, int W, int R, const int* active,
                                const int32_t* S, const int32_t* E,
                                int32_t* scratch, uint8_t* mark_scratch,
                                int32_t* F) {
  int b = blockIdx.x;
  if (active != nullptr && active[b] == 0) return;
  int N = H * R;
  S += (long long)b * N;
  E += (long long)b * N;
  F += (long long)b * N;
  int32_t* P = scratch + (long long)b * N;
  uint8_t* mark = mark_scratch + (long long)b * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) mark[n] = 0;
  link_runs(S, E, H, R, 0, P);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    int y = n / R;
    if (S[n] < kBig && (y == 0 || y == H - 1 || S[n] == 0 || E[n] == W - 1))
      mark[find_root(P, n)] = 1;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    F[n] = S[n] < kBig && mark[find_root(P, n)] ? 0 : 1;
}

// k_label_fix's labels, roots and count with one block per frame and the
// parents in global scratch; k_run_incidence then gives the slot lists.
__global__ void k_label_scratch(int H, int W, int R, int K, const int* active,
                                const int32_t* S, const int32_t* E,
                                int32_t* scratch, int32_t* L, int32_t* rl,
                                int32_t* nblobs) {
  int b = blockIdx.x;
  if (active != nullptr && active[b] == 0) return;
  int N = H * R, HW = H * W;
  S += (long long)b * N;
  E += (long long)b * N;
  L += (long long)b * N;
  rl += (long long)b * K;
  int32_t* P = scratch + (long long)b * N;
  link_runs(S, E, H, R, 1, P);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    int r = find_root(P, n);
    L[n] = S[n] < kBig ? (r / R) * W + S[r] : HW;
  }
  int count = 0;
  for (int n0 = 0; n0 < N; n0 += blockDim.x) {
    int n = n0 + threadIdx.x;
    bool root = n < N && S[n] < kBig && P[n] == n;
    int total;
    int rank = count + block_exclusive_scan(root ? 1 : 0, &total);
    if (root && rank < K) rl[rank] = (n / R) * W + S[n];
    count += total;
  }
  for (int k = count + threadIdx.x; k < K; k += blockDim.x) rl[k] = HW;
  if (threadIdx.x == 0) nblobs[b] = count;
}

// One block per (band, frame): which slots of the root table have a run in
// the band's rows; the band's slot list (present slots ascending, then the
// absent ones) and count.
__global__ void k_run_incidence(int H, int R, int band, int K,
                                const int* active, const int32_t* S,
                                const int32_t* L, const int32_t* rl,
                                const int32_t* nblobs, int32_t* slot_list,
                                int32_t* slot_count) {
  __shared__ int s_rl[kMaxSlots];
  __shared__ int s_pres[kMaxSlots];
  int r = blockIdx.x, b = blockIdx.y, Rb = gridDim.x;
  if (active != nullptr && active[b] == 0) return;
  int n_use = min(nblobs[b], K);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_rl[k] = rl[(long long)b * K + k];
    s_pres[k] = 0;
  }
  __syncthreads();
  long long base = (long long)b * H * R;
  int hi = min((r + 1) * band, H) * R;
  for (int n = r * band * R + threadIdx.x; n < hi; n += blockDim.x) {
    if (S[base + n] >= kBig) continue;
    int k = find_slot(s_rl, n_use, L[base + n]);
    if (k >= 0) s_pres[k] = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    write_slot_list(s_pres, K, slot_list + ((long long)b * Rb + r) * K,
                    slot_count + (long long)b * Rb + r);
}

// Foreground pixels take their run's label, background H*W.
__global__ void k_writeback(Geom g, int R, const uint8_t* filled,
                            const uint8_t* runid, const int32_t* L,
                            int32_t* labels) {
  for_each_tile(g, [&](Pix q) {
    if (!q.in) return;
    long long o = q.b * g.HW + q.p;
    int j = min(max((int)runid[o] - 1, 0), R - 1);
    labels[o] = filled[o] ? L[((long long)q.b * g.H + q.y) * R + j]
                          : (int)g.HW;
  });
}

// A cluster launch of a fix kernel: kFixCluster blocks a frame, B frames.
// Used in place (cfg points at attr).
struct FixLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  FixLaunch(int B, size_t smem, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kFixCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(kFixCluster, B);
    cfg.blockDim = dim3(kScanThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Dynamic shared memory of a fix kernel's cluster launch with `bytes` a
// block on the current device: `bytes` (raising the kernel's limit past 48
// KB), or 0 when a block may not opt in to that much or no such cluster
// fits on the card, so that the frames take the global-scratch kernel.
// Returns the first CUDA error.
template <typename Kernel>
int cluster_bytes(Kernel* kernel, size_t bytes, size_t* out) {
  int dev = 0, optin = 0;
  *out = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)optin) return 0;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    FixLaunch l(1, bytes, nullptr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &l.cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters == 0) return 0;
  }
  *out = bytes;
  return 0;
}

// Whether every row of these [B, H, W] byte planes starts 16-byte aligned,
// so that the extraction kernels move 16 columns a lane as one uint4.
inline bool rows_vec16(int W, std::initializer_list<const void*> planes) {
  if (W % kLaneCols != 0) return false;
  for (const void* p : planes)
    if ((uintptr_t)p % 16 != 0) return false;
  return true;
}

}  // namespace

// plane u8 [B, H, W] -> runid u8 [B, H, W], S / E int32 [B, H, R], nrun
// int32 [B, H] of the runs of (plane != 0) != invert.  active: null, or
// int32 [B] (frames with 0 are skipped).  Returns the first CUDA error.
extern "C" int hd_run_extract(const uint8_t* plane, int invert, int B, int H,
                              int W, int R, const int* active,
                              uint8_t* runid, int32_t* S, int32_t* E,
                              int32_t* nrun, void* stream) {
  dim3 grid((H + kRowWarps - 1) / kRowWarps, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (rows_vec16(W, {plane, runid}))
    k_run_extract<true><<<grid, kScanThreads, 0, st>>>(
        plane, invert, H, W, R, active, runid, S, E, nrun);
  else
    k_run_extract<false><<<grid, kScanThreads, 0, st>>>(
        plane, invert, H, W, R, active, runid, S, E, nrun);
  HD_CHECK();
  return 0;
}

// Background tables S / E int32 [B, H, R] -> F int32 [B, H, R].  A cluster
// of blocks per frame, or, where its tables exceed shared memory, one block
// per frame over the scratch int32 [B, H, R] and u8 [B, H, R]; *in_cluster
// (host memory) says which.
extern "C" int hd_flood_fix(int B, int H, int W, int R, const int* active,
                            const int32_t* S, const int32_t* E,
                            int32_t* scratch, uint8_t* mark_scratch,
                            int32_t* F, int* in_cluster, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = 0;
  int err = cluster_bytes(k_flood_fix, FixLayout(H, R, 0, 0).bytes(), &smem);
  if (err) return err;
  *in_cluster = smem > 0;
  if (smem > 0) {
    FixLaunch l(B, smem, st);
    cudaError_t e = cudaLaunchKernelEx(&l.cfg, k_flood_fix, H, W, R, active,
                                       S, E, F);
    if (e != cudaSuccess) return (int)e;
  } else {
    k_flood_scratch<<<B, kScanThreads, 0, st>>>(H, W, R, active, S, E,
                                                scratch, mark_scratch, F);
  }
  HD_CHECK();
  return 0;
}

// (binary u8 [B, H, W], runid_bg u8 [B, H, W], F int32 [B, H, Rbg]) ->
// filled u8 [B, H, W] (0/1), runid_fg u8 [B, H, W], S / E int32
// [B, H, Rfg], nrun int32 [B, H].
extern "C" int hd_fill_extract(int B, int H, int W, int Rbg, int Rfg,
                               const int* active, const uint8_t* binary,
                               const uint8_t* runid_bg, const int32_t* F,
                               uint8_t* filled, uint8_t* runid_fg,
                               int32_t* S, int32_t* E, int32_t* nrun,
                               void* stream) {
  dim3 grid((H + kRowWarps - 1) / kRowWarps, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (rows_vec16(W, {binary, runid_bg, filled, runid_fg}))
    k_fill_extract<true><<<grid, kScanThreads, 0, st>>>(
        H, W, Rbg, Rfg, active, binary, runid_bg, F, filled, runid_fg, S, E,
        nrun);
  else
    k_fill_extract<false><<<grid, kScanThreads, 0, st>>>(
        H, W, Rbg, Rfg, active, binary, runid_bg, F, filled, runid_fg, S, E,
        nrun);
  HD_CHECK();
  return 0;
}

// Foreground tables S / E int32 [B, H, R] -> L int32 [B, H, R], rl int32
// [B, K], nblobs int32 [B], slot_list int32 [B, Rb, K], slot_count int32
// [B, Rb] with Rb = ceil(H / band).  K <= kMaxSlots.  A cluster of blocks
// per frame, or, where its tables exceed shared memory, one block per frame
// over the scratch int32 [B, H, R] and then a block per (band, frame) for
// the slot lists; *in_cluster (host memory) says which.
extern "C" int hd_label_fix(int B, int H, int W, int R, int band, int K,
                            const int* active, const int32_t* S,
                            const int32_t* E, int32_t* scratch, int32_t* L,
                            int32_t* rl, int32_t* nblobs,
                            int32_t* slot_list, int32_t* slot_count,
                            int* in_cluster, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = 0;
  int err = cluster_bytes(k_label_fix, FixLayout(H, R, band, K).bytes(),
                          &smem);
  if (err) return err;
  *in_cluster = smem > 0;
  if (smem > 0) {
    FixLaunch l(B, smem, st);
    cudaError_t e = cudaLaunchKernelEx(&l.cfg, k_label_fix, H, W, R, band, K,
                                       active, S, E, L, rl, nblobs,
                                       slot_list, slot_count);
    if (e != cudaSuccess) return (int)e;
    HD_CHECK();
    return 0;
  }
  k_label_scratch<<<B, kScanThreads, 0, st>>>(H, W, R, K, active, S, E,
                                              scratch, L, rl, nblobs);
  HD_CHECK();
  int Rb = (H + band - 1) / band;
  k_run_incidence<<<dim3(Rb, B), kScanThreads, 0, st>>>(
      H, R, band, K, active, S, L, rl, nblobs, slot_list, slot_count);
  HD_CHECK();
  return 0;
}

// (filled u8 [B, H, W], runid_fg u8 [B, H, W], L int32 [B, H, R]) -> labels
// int32 [B, H, W], background H*W.
extern "C" int hd_writeback(int B, int H, int W, int R, const int* active,
                            const uint8_t* filled, const uint8_t* runid,
                            const int32_t* L, int32_t* labels,
                            void* stream) {
  Geom g{H, W, (long long)H * W, H, 1, active};
  k_writeback<<<tile_grid(g, B), dim3(kTileW, kTileH), 0,
                (cudaStream_t)stream>>>(g, R, filled, runid, L, labels);
  HD_CHECK();
  return 0;
}
