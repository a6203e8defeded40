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
// Design.  Extraction (hd_run_extract, and the second half of
// hd_fill_extract) is one 256-thread block per row: each thread takes 8
// consecutive columns, one block scan of the run starts gives runid, and
// the threads that hold a run's first or last column write its slot.  The
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

#include "common.cuh"

namespace {

constexpr int kBig = 1 << 20;     // S / E of a slot past the row's runs
constexpr int kRowItems = 8;      // consecutive columns per thread in a row

// The run tables of one row whose runs are the columns c with
// (row[c] != 0) != invert.  Every thread of a kScanThreads block calls it.
__device__ void extract_row(const uint8_t* row, bool invert, int W, int R,
                            uint8_t* runid, int32_t* S, int32_t* E,
                            int32_t* nrun) {
  int carry = 0;
  int tail = 0;       // this thread's run pixels from the R-th run on
  for (int c0 = 0; c0 < W; c0 += kScanThreads * kRowItems) {
    int p0 = c0 + threadIdx.x * kRowItems;
    unsigned bits = 0;    // bit i: column p0 - 1 + i is in a run
    for (int i = 0; i < kRowItems + 2; ++i) {
      int c = p0 - 1 + i;
      if (c >= 0 && c < W && ((row[c] != 0) != invert)) bits |= 1u << i;
    }
    unsigned own = (bits >> 1) & ((1u << kRowItems) - 1u);
    unsigned starts = own & ~bits;          // previous column not in a run
    unsigned ends = own & ~(bits >> 2);     // next column not in a run
    int total;
    int id = carry + block_exclusive_scan(__popc(starts), &total);
    for (int i = 0; i < kRowItems && p0 + i < W; ++i) {
      int c = p0 + i;
      if (starts >> i & 1u) {
        ++id;
        if (id <= R) S[id - 1] = c;
      }
      if ((ends >> i & 1u) && id <= R) E[id - 1] = c;
      if ((own >> i & 1u) && id >= R) ++tail;
      runid[c] = (uint8_t)id;
    }
    carry += total;
  }
  for (int j = carry + threadIdx.x; j < R; j += blockDim.x) {
    S[j] = kBig;
    E[j] = -kBig;
  }
  tail = block_sum(tail);
  if (threadIdx.x == 0) {
    *nrun = carry;
    if (carry > R) E[R - 1] = S[R - 1] + tail - 1;
  }
}

// One block per (row, frame).
__global__ void k_run_extract(const uint8_t* plane, int invert, int H, int W,
                              int R, const int* active, uint8_t* runid,
                              int32_t* S, int32_t* E, int32_t* nrun) {
  int y = blockIdx.x, b = blockIdx.y;
  if (active != nullptr && active[b] == 0) return;
  long long row = (long long)b * H + y;
  extract_row(plane + row * W, invert != 0, W, R, runid + row * W,
              S + row * R, E + row * R, nrun + row);
}

// One block per (row, frame): filled = binary, or the background run's flag
// (1: not reached from the border), then the run tables of filled.
__global__ void k_fill_extract(int H, int W, int Rbg, int Rfg,
                               const int* active, const uint8_t* binary,
                               const uint8_t* runid_bg, const int32_t* F,
                               uint8_t* filled, uint8_t* runid_fg,
                               int32_t* S, int32_t* E, int32_t* nrun) {
  int y = blockIdx.x, b = blockIdx.y;
  if (active != nullptr && active[b] == 0) return;
  long long row = (long long)b * H + y;
  const uint8_t* bin = binary + row * W;
  const uint8_t* rid = runid_bg + row * W;
  const int32_t* flag = F + row * Rbg;
  uint8_t* out = filled + row * W;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    int j = min(max((int)rid[c] - 1, 0), Rbg - 1);
    out[c] = bin[c] != 0 || flag[j] != 0;
  }
  __syncthreads();
  extract_row(out, false, W, Rfg, runid_fg + row * W, S + row * Rfg,
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

}  // namespace

// plane u8 [B, H, W] -> runid u8 [B, H, W], S / E int32 [B, H, R], nrun
// int32 [B, H] of the runs of (plane != 0) != invert.  active: null, or
// int32 [B] (frames with 0 are skipped).  Returns the first CUDA error.
extern "C" int hd_run_extract(const uint8_t* plane, int invert, int B, int H,
                              int W, int R, const int* active,
                              uint8_t* runid, int32_t* S, int32_t* E,
                              int32_t* nrun, void* stream) {
  k_run_extract<<<dim3(H, B), kScanThreads, 0, (cudaStream_t)stream>>>(
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
  k_fill_extract<<<dim3(H, B), kScanThreads, 0, (cudaStream_t)stream>>>(
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
