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
// 4-connected for the background, 8-connected for the foreground), one
// block per frame, with the parents in shared memory when the frame's
// table fits (1080 x 8 nodes: 34.6 KB of parents, plus 8.6 KB of border
// marks in the fill) and in global scratch when it does not.  A root is the
// smallest node of its tree, which is also the run with the smallest
// row * W + S, so the label of a run is read off its root.  The per-band
// slot incidence is a second kernel, one block per (band, frame).
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
// where one block per frame runs under one wave on 132 SMs: latency, not
// bytes, bounds them.

#include <initializer_list>

#include "common.cuh"

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

// Union-find over the valid runs of one frame's tables S / E [H, R]: runs of
// adjacent rows are united where [S - dilate, E + dilate] meets the other's
// [S, E] (dilate 0: 4-connected, 1: 8-connected).  Ends synchronised.
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

// The frame's union-find parents: in the launch's dynamic shared memory, or
// in its slice of the global scratch.
__device__ __forceinline__ int32_t* parents(int in_smem, int32_t* scratch,
                                            int N) {
  extern __shared__ int32_t smem[];
  return in_smem ? smem : scratch + (long long)blockIdx.x * N;
}

// One block per frame: F = 0 for background runs 4-connected to a run on
// the first or last row or touching the first or last column, else 1
// (invalid slots included).
__global__ void k_flood_fix(int H, int W, int R, int in_smem,
                            const int* active, const int32_t* S,
                            const int32_t* E, int32_t* scratch,
                            uint8_t* mark_scratch, int32_t* F) {
  int b = blockIdx.x;
  if (active != nullptr && active[b] == 0) return;
  int N = H * R;
  S += (long long)b * N;
  E += (long long)b * N;
  F += (long long)b * N;
  int32_t* P = parents(in_smem, scratch, N);
  uint8_t* mark = in_smem ? (uint8_t*)(P + N)
                          : mark_scratch + (long long)b * N;
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

// One block per frame: L = row * W + S of the run's component root (H*W in
// invalid slots), the first K roots in raster order (padded with H*W) and
// the root count.
__global__ void k_label_fix(int H, int W, int R, int K, int in_smem,
                            const int* active, const int32_t* S,
                            const int32_t* E, int32_t* scratch, int32_t* L,
                            int32_t* rl, int32_t* nblobs) {
  int b = blockIdx.x;
  if (active != nullptr && active[b] == 0) return;
  int N = H * R, HW = H * W;
  S += (long long)b * N;
  E += (long long)b * N;
  L += (long long)b * N;
  rl += (long long)b * K;
  int32_t* P = parents(in_smem, scratch, N);
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

// Dynamic shared memory for a per-frame union-find of `bytes` on the
// current device: `bytes` (raising the kernel's limit past 48 KB), or 0 when
// it exceeds what a block may opt in to, so that the kernel uses its global
// scratch.  Returns the first CUDA error.
template <typename Kernel>
int shared_bytes(Kernel* kernel, size_t bytes, size_t* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  *out = bytes <= (size_t)optin ? bytes : 0;
  if (*out > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)*out);
    if (err != cudaSuccess) return (int)err;
  }
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

// Background tables S / E int32 [B, H, R] -> F int32 [B, H, R].  Scratch
// (used when the frame's table exceeds shared memory): int32 [B, H, R] and
// u8 [B, H, R].
extern "C" int hd_flood_fix(int B, int H, int W, int R, const int* active,
                            const int32_t* S, const int32_t* E,
                            int32_t* scratch, uint8_t* mark_scratch,
                            int32_t* F, void* stream) {
  size_t smem = 0;
  int err = shared_bytes(k_flood_fix, (size_t)H * R * 5, &smem);
  if (err) return err;
  k_flood_fix<<<B, kScanThreads, smem, (cudaStream_t)stream>>>(
      H, W, R, smem > 0, active, S, E, scratch, mark_scratch, F);
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
// [B, Rb] with Rb = ceil(H / band).  K <= kMaxSlots.  Scratch: int32
// [B, H, R].
extern "C" int hd_label_fix(int B, int H, int W, int R, int band, int K,
                            const int* active, const int32_t* S,
                            const int32_t* E, int32_t* scratch, int32_t* L,
                            int32_t* rl, int32_t* nblobs,
                            int32_t* slot_list, int32_t* slot_count,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = 0;
  int err = shared_bytes(k_label_fix, (size_t)H * R * 4, &smem);
  if (err) return err;
  k_label_fix<<<B, kScanThreads, smem, st>>>(H, W, R, K, smem > 0, active,
                                             S, E, scratch, L, rl, nblobs);
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
