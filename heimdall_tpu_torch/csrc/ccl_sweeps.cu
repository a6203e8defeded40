// Sweep and run-table connected-component labeling for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (heimdall_tpu_torch/ops/_cuda.py, wrapped by
// heimdall_tpu_torch/ops/ccl_sweeps.py).
//
// Replaces the Pallas kernel of heimdall_tpu's timing probe
// scripts/profile_ccl_variants.py:348 (ccl_param :206-301, VARIANTS
// :303-322, ccl_runtable :33-148; its "cur" is
// pallas_kernels.py::_ccl_sweeps, :325-429) and the run-table check
// scripts/check_runtable.py:42, on the filled mask.  The contract is the
// label kernel's "ccl" stage: every foreground pixel holds the least linear
// index of its 8-connected component, background H*W (S below).
//
// Sweep CCL (hd_sweep_ccl), per frame: labels start as the linear index on
// foreground and S elsewhere.  A phase takes, on foreground, the 3x3 min of
// the labels (nb), then the min over each foreground run of the row (or
// column): min-scans of run-packed keys label - run * big forward and label
// + run * big backward (big = 2^ceil(log2(S + 2)), so no run's keys reach
// another's), each a doubling ladder of `steps` (reach 2^steps - 1).  Every
// phase reads one plane and writes the other, as the TPU code's phases do,
// so a number of units gives the TPU code's labels.  A unit is row, column,
// row (or row, column); units repeat to the certificate.  The knobs:
//   ss_r, ss_c  ladder steps of the row and column phases (0: the whole
//               line, ceil(log2(length)) steps);
//   guard       8 rows of background above and below the frame, so the nb
//               of the frame's rows needs no row test, and the column
//               ladder runs over H + 16 rows (or none, and tests);
//   cert        "nb": one more nb lowers no label; "cheap": the unit
//               changed no label (counted as the phases write); "fixed":
//               `fixed` units, no certificate (a timing probe: a frame may
//               stop short of its labels);
//   presweep    one unit of whole-line ladders first.
// Run-table CCL (hd_runtable_ccl), per frame: the runs of each row go into
// tables [R][H] (first column, last column, label = the run's first pixel)
// in shared memory, from the mask's bits; then to a certified fixpoint: the
// min along each slot's vertical chains of overlapping runs (the packed
// ladder over the whole height, chain ids as the runs), and each entry the
// least label of the runs of rows r +- 1 that it 8-overlaps ([S - 1, E + 1]
// against [S', E']); labels are written back by each pixel's run slot.  A
// frame with a row of more than R runs gets fits = 0 and takes the sweep
// CCL ("cur") instead, chosen on the card: the run ids and the sweep
// kernel skip the frames whose fits is 1 (k_runtable_ccl below).
//
// Design: the run ids are common.cuh's k_run_ids (tensor-core products,
// one launch per orientation).  Then the units and the certificate run with
// no host sync on one of two paths, chosen by the host from the frame's
// shape (ops/ccl_sweeps.py::band_layout):
//   cluster  k_sweep_ccl_cluster: a thread-block cluster per frame whose C
//            blocks (16 at 640x480) each hold a band of rows of both label
//            planes in shared memory (sweep_cluster.cuh): a phase reads one
//            plane and writes the other without device memory, the column
//            ladder reads the other blocks' rows through the cluster's
//            window, the certificates are ORs over the cluster, and device
//            memory sees the mask and the run ids in and the labels out;
//   global   k_sweep_ccl, the first design, kept for the frames whose planes
//            do not fit the cluster (up to 1024 x 1008): one block per frame,
//            the planes [B, Hg, W] int32 in device memory, a row phase a warp
//            per row through a line buffer, a column phase 32 columns at a
//            time through a tile (common.cuh's sweep_phase).
// The run tables: one block a frame, 10 bytes a slot of a row (two blocks
// an SM at 640x480, R 12), built from the mask a warp a row and written
// back the same way; the run ids only for the frames that do not fit.
//
// What bounds it on an H100 SXM: bytes, the mask in and the labels out,
// 5 B/px (0.459 us per 640x480 frame at 3.35 TB/s; with the label kernel's
// fill in front, frames in and labels out, 7 B/px, 0.642 us).  The global
// path reads and writes a plane in device memory every phase with one block
// per frame.  The cluster path keeps the planes on chip: at 640x480, 16
// blocks of 228,416 bytes a frame, 7 clusters at once, and its time is
// the ladders' instructions (a lane's registers of a row and a column are
// a template parameter: <20, 16> up to 640x512) and the cluster barriers.
// "cur" alone, run ids included, batch 256 of the bench's filled masks:
// 25.91 us/frame on the cluster path, 97.72-97.97 on the global path; the
// probe with its fill 48.70-48.97 against the first design's 114.01-114.21
// (chip_smoke.py phase 5f, NVIDIA H100 80GB HBM3, 700.00 W).  The run
// tables alone, on the same masks, all of which fit: 1.22 us/frame, from
// 9.82 with the run ids of every frame and the tables built a pixel at a
// time (the same phase and card).  Their frames run in one wave, so a
// block's phases (the mask read, the fixpoint, the label writes) meet the
// other blocks' same phases, and reads never overlap writes.

#include <algorithm>

#include "common.cuh"
#include "sweep_cluster.cuh"

namespace {

constexpr int kWarps = 16;          // one block per frame

enum Cert { kCertNb = 0, kCertCheap = 1, kCertFixed = 2 };

struct Sweep {
  int steps_r, steps_c;   // ladder steps of the row and column phases
  int pre_r, pre_c;       // the presweep's (whole lines), or 0: none
  int unit;               // phases per unit: 3 (row, column, row) or 2
  int cert;               // Cert
  int fixed;              // units, with kCertFixed
  int big;                // the run ids' factor in the packed keys
};

// 3x3 min over the rows ru, r0, rd (null: outside the plane) around
// column x.
__device__ __forceinline__ int nb8_rows(const int32_t* ru, const int32_t* r0,
                                        const int32_t* rd, int x, int W,
                                        int S) {
  const int32_t* rows[3] = {ru, r0, rd};
  int m = S;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int32_t* r = rows[i];
    if (r == nullptr) continue;
    m = min(m, r[x]);
    if (x > 0) m = min(m, r[x - 1]);
    if (x < W - 1) m = min(m, r[x + 1]);
  }
  return m;
}

// 3x3 min of the labels p of the guarded plane around (y, x): neighbours
// outside the plane do not count; with guard rows the frame's rows need no
// row test.
template <bool kGuard>
__device__ __forceinline__ int nb8(const Plane& pl, const int32_t* p, int y,
                                   int x, int S) {
  const int32_t* r = p + (long long)y * pl.W;
  bool up = kGuard || y > 0, dn = kGuard || y < pl.Hg - 1;
  return nb8_rows(up ? r - pl.W : nullptr, r, dn ? r + pl.W : nullptr, x,
                  pl.W, S);
}

// One block per frame: the sweep CCL of mask u8 [B, H, W] into labels
// [B, H, W], through the planes a and b [B, Hg, W].  rb_r [B, Hg, W] and
// rb_t [B, W, Hg] are the foreground run ids.  A frame whose done[b] is
// nonzero is left as it is (done may be null).
template <bool kGuard>
__global__ void __launch_bounds__(kWarps * 32, 1)
    k_sweep_ccl(Plane pl, Sweep sw, const uint8_t* mask, const int16_t* rb_r,
                const int16_t* rb_t, const int32_t* done, int32_t* plane_a,
                int32_t* plane_b, int32_t* labels) {
  extern __shared__ int smem[];
  int b = blockIdx.x;
  if (done != nullptr && done[b]) return;
  int S = pl.H * pl.W;
  long long np = (long long)pl.Hg * pl.W;
  int32_t* cur = plane_a + b * np;
  int32_t* nxt = plane_b + b * np;
  const uint8_t* m = mask + (long long)b * S;
  const int16_t* rr = rb_r + b * np;
  const int16_t* rt = rb_t + b * np;
  for (long long i = threadIdx.x; i < np; i += blockDim.x) {
    int y = (int)(i / pl.W), x = (int)(i - (long long)y * pl.W);
    cur[i] = fg_at(pl, m, y, x) ? (y - pl.G) * pl.W + x : S;
    nxt[i] = S;                      // its guard rows stay S
  }
  __syncthreads();

  int y_lo = pl.G, y_hi = pl.G + pl.H;
  int changed = 0;
  // one phase from cur into nxt, then the two swap
  auto phase = [&](bool cols, int steps) {
    auto cand = [&](int y, int x) {
      int c = cur[(long long)y * pl.W + x];
      return c < S ? nb8<kGuard>(pl, cur, y, x, S) : S;
    };
    auto out = [&](int y, int x, int v) {
      long long i = (long long)y * pl.W + x;
      int c = cur[i], o = c < S ? v : S;
      changed |= o != c;
      nxt[i] = o;
    };
    if (cols)
      sweep_phase<true>(pl, y_lo, y_hi, rt, sw.big, steps, smem, kWarps, cand,
                        out);
    else
      sweep_phase<false>(pl, y_lo, y_hi, rr, sw.big, steps, smem, kWarps,
                         cand, out);
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  };
  auto unit = [&](int sr, int sc, int phases) {
    phase(false, sr);
    phase(true, sc);
    if (phases == 3) phase(false, sr);
  };

  if (sw.pre_r) unit(sw.pre_r, sw.pre_c, 3);
  for (int n = 1;; ++n) {
    changed = 0;
    unit(sw.steps_r, sw.steps_c, sw.unit);
    if (sw.cert == kCertFixed) {
      if (n >= sw.fixed) break;
      continue;
    }
    int more = changed;
    if (sw.cert == kCertNb) {
      more = 0;
      for (long long i = threadIdx.x + (long long)y_lo * pl.W;
           i < (long long)y_hi * pl.W; i += blockDim.x) {
        int y = (int)(i / pl.W), c = cur[i];
        if (c < S && nb8<kGuard>(pl, cur, y, (int)(i - (long long)y * pl.W),
                                 S) < c)
          more = 1;
      }
    }
    if (!__syncthreads_or(more)) break;
  }

  int32_t* out = labels + (long long)b * S;
  const int32_t* src = cur + (long long)pl.G * pl.W;
  for (long long i = threadIdx.x; i < S; i += blockDim.x) out[i] = src[i];
}

// A cluster per frame (sweep_cluster.cuh): the sweep CCL of mask u8
// [B, H, W] into labels [B, H, W] with both planes in the cluster's shared
// memory.  The units, ladders and certificates are k_sweep_ccl's: each
// phase reads one plane and writes the other.  A frame whose done[b] is
// nonzero is left as it is by every block of its cluster (done may be
// null).
template <int kPerR, int kPerC>
__global__ void __launch_bounds__(kBandWarps * 32, 1)
    k_sweep_ccl_cluster(Plane pl, Band bd, Sweep sw, const uint8_t* mask,
                        const int16_t* rb_r, const int16_t* rb_t,
                        const int32_t* done, int32_t* labels) {
  extern __shared__ int smem[];
  int b = blockIdx.y;
  if (done != nullptr && done[b]) return;
  BandFrame f(bd, smem);
  int W = pl.W, S = pl.H * W;
  const uint8_t* m = mask + (long long)b * S;
  long long np = (long long)pl.Hg * W;
  const int16_t* rr = rb_r + b * np;
  const int16_t* rt = rb_t + b * np;
  int* cur = f.A;
  int* nxt = f.B;
  // background holds S in both planes from here on (the phases skip the
  // lines that are all background)
  f.for_own([&](int y, int x) {
    int p = y * W + x;
    f.row(f.A, y)[x] = m[p] ? p : S;
    f.row(f.B, y)[x] = S;
  });
  f.cl.sync();     // every block has started and holds its planes and map

  int changed = 0;
  auto cand = [&](int y, int x) {
    int c = f.row(cur, y)[x];
    return c < S ? nb8_rows(f.row(cur, y - 1), f.row(cur, y),
                            f.row(cur, y + 1), x, W, S)
                 : S;
  };
  auto out = [&](int y, int x, int v, int c, int* nr) {
    int o = c < S ? v : S;
    changed |= o != c;
    nr[x] = o;
  };
  auto phase = [&](bool cols, int steps) {
    if (cols)
      band_phase<kPerR, kPerC, true, true, true>(f, pl, rt, sw.big, steps,
                                                 cur, nxt, cand, out);
    else
      band_phase<kPerR, kPerC, false, true, true>(f, pl, rr, sw.big, steps,
                                                  cur, nxt, cand, out);
    int* t = cur;
    cur = nxt;
    nxt = t;
  };
  auto unit = [&](int sr, int sc, int phases) {
    phase(false, sr);
    phase(true, sc);
    if (phases == 3) phase(false, sr);
  };

  if (sw.pre_r) unit(sw.pre_r, sw.pre_c, 3);
  for (int n = 1;; ++n) {
    changed = 0;
    unit(sw.steps_r, sw.steps_c, sw.unit);
    if (sw.cert == kCertFixed) {
      if (n >= sw.fixed) break;
      continue;
    }
    int more = changed;
    if (sw.cert == kCertNb) {
      more = 0;
      f.copy_halo(cur);
      f.for_own([&](int y, int x) {
        int c = f.row(cur, y)[x];
        if (c < S && nb8_rows(f.row(cur, y - 1), f.row(cur, y),
                              f.row(cur, y + 1), x, W, S) < c)
          more = 1;
      });
    }
    if (!f.any(more)) break;
  }

  int32_t* lab = labels + (long long)b * S;
  f.for_own([&](int y, int x) { lab[y * W + x] = f.row(cur, y)[x]; });
}

// ------------------------------------------------------ the run tables
//
// k_runtable_ccl: one 512-thread block a frame, its tables and a staging
// row a warp in shared memory (runtable_smem bytes: 10 a slot of a row, 1 a
// row and 2 KB a warp; R 12 at 480 rows 90,848 B, so two blocks an SM: one
// wave for batch 256 on 132 SMs):
//   L      int32 [R][H]  each run's label (its first pixel, then the least
//                        of its component's)
//   S, E   int16 [R][H]  each run's first and last column (W <= 32,767)
//   chain  int16 [R][H]  the chain id of each entry (a slot's vertical run
//                        of 8-overlapping entries)
//   nr     u8 [H]        each row's runs (R + 1: more than R)
// The tables come from the mask alone: a warp per row loads 16 columns a
// lane as one uint4, takes each lane's foreground as 16 bits, its run starts
// and ends from the neighbouring lanes' edge bits, and a run's slot as the
// starts before it (a popc, and a warp scan of the lanes' counts), so no
// run id is read.  Then, to the fixpoint: the min along each slot's chains
// (the packed ladder over the whole height, exact in one pass), and the
// exchange, each entry lowered to the least label of the runs of rows r +- 1
// that it 8-overlaps ([S - 1, E + 1] against [S', E']), in place; the loop
// ends when an exchange lowers no label.  The labels go out a warp a row,
// each pixel's label looked up by its run's slot from the same bits,
// staged, then stored as the warp's consecutive 16-byte words.  Each warp
// keeps its next row's loads in flight while it works on a row.

// The staging of a warp's 512 labels of a step, so that they go out in
// coalesced 16-byte stores.
constexpr int kStageInts = 512;

__host__ __device__ inline size_t runtable_tables(int R, int H) {
  return ((size_t)R * H * (4 + 2 + 2 + 2) + H + 15) & ~(size_t)15;
}

inline size_t runtable_smem(int R, int H) {
  return runtable_tables(R, H) + (size_t)kWarps * kStageInts * 4;
}

// The most dynamic shared memory a table block may take: the device's
// 232,448 bytes less the block's static int.
constexpr size_t kRuntableSmemMax = 232448 - 16;

// The foreground of mask bytes at columns c .. c + 15 of row m as 16 bits
// (bit i: column c + i), 0 past W; vec: one 16-byte load (c < W).
__device__ __forceinline__ uint32_t fg_bits16(const uint8_t* m, int c, int W,
                                              bool vec) {
  if (c >= W) return 0u;
  if (vec) {
    uint4 q = *reinterpret_cast<const uint4*>(m + c);
    uint32_t w[4] = {q.x, q.y, q.z, q.w}, bits = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // 0x80 in each nonzero byte, then the four high bits gathered
      uint32_t nz = (((w[i] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w[i]) &
                    0x80808080u;
      bits |= (((nz >> 7) * 0x01020408u) >> 24 & 15u) << (4 * i);
    }
    return bits;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c + i < W && m[c + i]) bits |= 1u << i;
  return bits;
}

// A row's foreground as bits, lane l's 16 columns 16 l .. 16 l + 15 of each
// 512-column step (W <= 1024: two steps).
constexpr int kRowSteps = 2;

__device__ __forceinline__ void row_bits(const uint8_t* m, int W, bool vec,
                                         int lane,
                                         uint32_t (&f)[kRowSteps]) {
#pragma unroll
  for (int s = 0; s < kRowSteps; ++s)
    f[s] = fg_bits16(m, 512 * s + 16 * lane, W, vec);
}

// A warp's pass over a row's bits f: hands each lane's first column c, its
// 16 bits of foreground, its run starts and ends and the slot of the run
// that its column c - 1 lies in (before any start of its own) to body(c,
// fg, starts, ends, slot), a step at a time; returns the row's runs.
template <typename Body>
__device__ __forceinline__ int row_runs(const uint32_t (&f)[kRowSteps],
                                        int W, int lane, Body body) {
  int runs = 0;
  uint32_t carry = 0;        // the foreground of the previous step's last
#pragma unroll
  for (int s = 0; s < kRowSteps; ++s) {
    if (512 * s >= W) break;
    uint32_t fg = f[s];
    uint32_t before = __shfl_up_sync(kFull, fg >> 15, 1);
    if (lane == 0) before = carry;
    // the foreground of column c + 16: the next lane's first, past the
    // step's last lane the next step's first
    uint32_t after = __shfl_down_sync(kFull, fg & 1u, 1);
    uint32_t next = 0u;
    if (s + 1 < kRowSteps)
      next = __shfl_sync(kFull, f[min(s + 1, kRowSteps - 1)] & 1u, 0);
    if (lane == 31) after = next;
    uint32_t starts = fg & ~((fg << 1) | before);
    uint32_t ends = fg & ~((fg >> 1) | (after << 15));
    int n = __popc(starts), incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    body(512 * s + 16 * lane, fg, starts, ends, runs + incl - n - 1);
    runs += __shfl_sync(kFull, incl, 31);
    carry = __shfl_sync(kFull, fg >> 15, 31);
  }
  return runs;
}

// One block per frame: the run-table CCL of mask u8 [B, H, W] with R slots
// per row (above).  Writes fits[b]; when it is 1, the labels.  Block 0 sets
// *runid_frames (if given) to 0 for the run-id product that follows.
// kPer: the chain ladder's registers a lane (H <= 32 * kPer).
template <int kPer>
__global__ void __launch_bounds__(kWarps * 32, kPer <= 16 ? 2 : 1)
    k_runtable_ccl(int H, int W, int R, int big, int steps, bool vec,
                   const uint8_t* mask, int32_t* fits, int32_t* labels,
                   int32_t* runid_frames) {
  extern __shared__ __align__(16) int sm[];
  __shared__ int s_maxr;
  const int RH = R * H, S = H * W;
  int* L = sm;
  int16_t* Sx = reinterpret_cast<int16_t*>(sm + RH);
  int16_t* Ex = Sx + RH;
  int16_t* chain = Ex + RH;
  uint8_t* nr = reinterpret_cast<uint8_t*>(chain + RH);
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* m = mask + (long long)b * S;
  if (threadIdx.x == 0) {
    s_maxr = 0;
    if (b == 0 && runid_frames != nullptr) *runid_frames = 0;
  }
  __syncthreads();

  // the tables, a warp a row, the next row's loads in flight
  int over = 0;
  uint32_t f[kRowSteps] = {}, g[kRowSteps] = {};
  if (warp < H) row_bits(m + (long long)warp * W, W, vec, lane, f);
  for (int y = warp; y < H; y += kWarps) {
    if (y + kWarps < H)
      row_bits(m + (long long)(y + kWarps) * W, W, vec, lane, g);
    int runs = row_runs(f, W, lane, [&](int c, uint32_t fg, uint32_t starts,
                                        uint32_t ends, int slot) {
      for (uint32_t e = starts | ends; e; e &= e - 1) {
        int i = __ffs(e) - 1;
        int k = slot + __popc(starts & ((2u << i) - 1u));
        if (k >= R) break;
        if (starts >> i & 1u) {
          Sx[k * H + y] = (int16_t)(c + i);
          L[k * H + y] = y * W + c + i;
        }
        if (ends >> i & 1u) Ex[k * H + y] = (int16_t)(c + i);
      }
    });
    for (int k = runs + lane; k < R; k += 32) L[k * H + y] = S;
    if (lane == 0) {
      nr[y] = (uint8_t)min(runs, R + 1);
      atomicMax(&s_maxr, min(runs, R));
    }
    over |= runs > R;
#pragma unroll
    for (int s = 0; s < kRowSteps; ++s) f[s] = g[s];
  }
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) fits[b] = !over;
  if (over) return;
  const int maxr = s_maxr;

  // chain ids: an entry starts a chain unless it and the same slot's entry
  // of the row above are runs that 8-overlap
  for (int k = warp; k < maxr; k += kWarps) {
    int run = 0;
    for (int r0 = 0; r0 < H; r0 += 32) {
      int r = r0 + lane, i = k * H + r;
      bool st = r < H;
      if (st && r > 0 && k < nr[r] && k < nr[r - 1])
        st = !(Sx[i] - 1 <= Ex[i - 1] && Ex[i] + 1 >= Sx[i - 1]);
      unsigned bal = __ballot_sync(kFull, st);
      if (r < H) chain[i] = (int16_t)(run + __popc(bal & ((2u << lane) - 1u)));
      run += __popc(bal);
    }
  }
  __syncthreads();

  while (true) {
    // the min along each slot's chains, the whole height, in place (the
    // slot's entries are the ladder's line buffer)
    for (int k = warp; k < maxr; k += kWarps) {
      int v[kPer], rb[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int r = 32 * j + lane;
        v[j] = r < H ? L[k * H + r] : 0;
        rb[j] = r < H ? big * chain[k * H + r] : 0;
      }
      run_min<kScanMasked>(v, rb, L + k * H, H, steps, lane);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int r = 32 * j + lane;
        if (r < H) L[k * H + r] = v[j];
      }
    }
    __syncthreads();
    // the exchange, in place: labels only fall, and each is a label of the
    // entry's component whichever write a read sees
    int more = 0;
    for (int i = threadIdx.x; i < maxr * H; i += blockDim.x) {
      int k = i / H, r = i - k * H;
      if (k >= nr[r]) continue;
      int s = Sx[i] - 1, e = Ex[i] + 1, acc = L[i];
      for (int d = -1; d <= 1; d += 2) {
        int r2 = r + d;
        if (r2 < 0 || r2 >= H) continue;
        for (int j = 0, n2 = nr[r2]; j < n2; ++j) {
          int q = j * H + r2;
          if (s <= Ex[q] && e >= Sx[q]) acc = min(acc, L[q]);
        }
      }
      if (acc < L[i]) {
        L[i] = acc;
        more = 1;
      }
    }
    if (!__syncthreads_or(more)) break;
  }

  // the labels, a warp a row: each lane's 16 looked up by their runs'
  // slots, staged in shared memory (each lane's four groups rotated by
  // lane / 2, so that neither side of the staging meets a bank twice),
  // then stored as the warp's consecutive 16-byte words
  int32_t* out = labels + (long long)b * S;
  int* stage = reinterpret_cast<int*>(
                   reinterpret_cast<uint8_t*>(sm) + runtable_tables(R, H)) +
               warp * kStageInts;
  int4* stage4 = reinterpret_cast<int4*>(stage);
  if (warp < H) row_bits(m + (long long)warp * W, W, vec, lane, f);
  for (int y = warp; y < H; y += kWarps) {
    if (y + kWarps < H)
      row_bits(m + (long long)(y + kWarps) * W, W, vec, lane, g);
    int32_t* row = out + (long long)y * W;
    row_runs(f, W, lane, [&](int c, uint32_t fg, uint32_t starts, uint32_t,
                             int slot) {
      int lab[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        slot += starts >> i & 1u;
        lab[i] = fg >> i & 1u ? L[slot * H + y] : S;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        stage4[4 * lane + ((q + (lane >> 1)) & 3)] =
            make_int4(lab[4 * q], lab[4 * q + 1], lab[4 * q + 2],
                      lab[4 * q + 3]);
      __syncwarp();
      int x0 = c - 16 * lane;
      if (vec) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int col = x0 + 128 * q + 4 * lane, src = 8 * q + (lane >> 2);
          if (col < W)
            *reinterpret_cast<int4*>(row + col) =
                stage4[4 * src + (((lane & 3) + (src >> 1)) & 3)];
        }
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          int e = 32 * q + lane, src = e >> 4, grp = (e >> 2) & 3;
          if (x0 + e < W)
            row[x0 + e] =
                stage[4 * (4 * src + ((grp + (src >> 1)) & 3)) + (e & 3)];
        }
      }
      __syncwarp();
    });
#pragma unroll
    for (int s = 0; s < kRowSteps; ++s) f[s] = g[s];
  }
}

int packed_big(int S) { return 1 << ceil_log2(S + 2); }

// The sweep's ladders: ss 0 is the whole line.
Sweep sweep_of(const Plane& pl, int ss_r, int ss_c, int unit, int cert,
               int fixed, int presweep) {
  int full_r = ceil_log2(pl.W), full_c = ceil_log2(pl.Hg);
  Sweep sw;
  sw.steps_r = ss_r > 0 ? std::min(ss_r, full_r) : full_r;
  sw.steps_c = ss_c > 0 ? std::min(ss_c, full_c) : full_c;
  sw.pre_r = presweep ? full_r : 0;
  sw.pre_c = presweep ? full_c : 0;
  sw.unit = unit;
  sw.cert = cert;
  sw.fixed = fixed;
  sw.big = packed_big(pl.H * pl.W);
  return sw;
}

bool sweep_fits(const Plane& pl) {
  return pl.W <= 32 * kMaxPerLane && pl.Hg <= 32 * kMaxPerLane &&
         sweep_phase_smem(pl, kWarps) <= 232448 &&
         // packed keys: at most max(W, Hg) / 2 + 1 runs a line
         (long long)(std::max(pl.W, pl.Hg) / 2 + 2) * packed_big(pl.H * pl.W) +
                 pl.H * pl.W <
             (1LL << 30);
}

// The sweep's second stage on the path the host chose: a cluster of
// `cluster` blocks a frame with `pass_cols` columns a pass, or (cluster 0)
// one block per frame over plane_a and plane_b.
int launch_sweep(const Plane& pl, const Sweep& sw, int B, int cluster,
                 int pass_cols, const uint8_t* mask, const int16_t* rb_r,
                 const int16_t* rb_t, const int32_t* done, int32_t* plane_a,
                 int32_t* plane_b, int32_t* labels, cudaStream_t st) {
  if (cluster) {
    // the band holds the frame's H rows, not the guard rows: a column
    // ladder of ceil(log2(H)) steps already reaches the whole column, and
    // a longer one would shift past its line
    Sweep sc = sw;
    sc.steps_c = std::min(sw.steps_c, ceil_log2(pl.H));
    sc.pre_c = std::min(sw.pre_c, ceil_log2(pl.H));
    Band bd = band_of(pl.H, pl.W, cluster, pass_cols, 0);
    auto kernel = band_small(bd) ? k_sweep_ccl_cluster<20, 16>
                                 : k_sweep_ccl_cluster<kMaxPerLane, kMaxPerLane>;
    return band_launch(kernel, bd, B, st, pl, bd, sc, mask, rb_r, rb_t, done,
                       labels);
  }
  auto kernel = pl.G ? k_sweep_ccl<true> : k_sweep_ccl<false>;
  size_t smem = sweep_phase_smem(pl, kWarps);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, kWarps * 32, smem, st>>>(pl, sw, mask, rb_r, rb_t, done,
                                       plane_a, plane_b, labels);
  HD_CHECK();
  return 0;
}

// Whether the path is one the kernels take at this shape: a cluster band
// that fits the device's shared memory, or the global path's planes.
int path_ok(const Plane& pl, int cluster, int pass_cols, bool* ok) {
  if (!cluster) {
    *ok = sweep_fits(pl);
    return 0;
  }
  return band_fits(band_of(pl.H, pl.W, cluster, pass_cols, 0), ok);
}

}  // namespace

// The sweep CCL of mask u8 [B, H, W] (nonzero = foreground): labels int32
// [B, H, W].  guard 0 or 1 (8 rows); ss_r, ss_c the ladder steps (0: whole
// lines); unit 2 or 3 phases; cert 0 "nb", 1 "cheap", 2 "fixed" (`fixed`
// units); presweep 0 or 1.  cluster: the cluster path's blocks a frame (1,
// 2, 4, 8 or 16) with pass_cols (8, 16 or 32) columns a pass, or 0 for the
// global path.  done: null, or int32 [B] (frames with nonzero flags are
// left as they are).  Scratch: rb_r, rb_t int16, (H + 16 guard) x W each
// per frame, and for the global path plane_a, plane_b int32 of that size
// (null on the cluster path).  W and H + 16 guard at most 1024.  Returns
// the first CUDA error.
extern "C" int hd_sweep_ccl(const uint8_t* mask, int B, int H, int W,
                            int guard, int ss_r, int ss_c, int unit, int cert,
                            int fixed, int presweep, int cluster,
                            int pass_cols, const int32_t* done,
                            int16_t* rb_r, int16_t* rb_t, int32_t* plane_a,
                            int32_t* plane_b, int32_t* labels, void* stream) {
  Plane pl = plane_of(H, W, guard);
  bool ok = false;
  int err = path_ok(pl, cluster, pass_cols, &ok);
  if (err) return err;
  if (!ok || !sweep_fits(pl) || (unit != 2 && unit != 3) || cert < 0 ||
      cert > 2 || (cert == kCertFixed && fixed < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  err = launch_run_ids_rc<kPackMxu, kRunsFg>(pl, B, mask, 1, rb_r, rb_t, st);
  if (err) return err;
  return launch_sweep(pl, sweep_of(pl, ss_r, ss_c, unit, cert, fixed,
                                   presweep),
                      B, cluster, pass_cols, mask, rb_r, rb_t, done, plane_a,
                      plane_b, labels, st);
}

// How many clusters of the sweep CCL's cluster path the current device runs
// at once for H x W frames (guarded), or minus a CUDA error.
extern "C" int hd_sweep_ccl_clusters(int H, int W, int cluster,
                                     int pass_cols) {
  if (cluster < 1) return -(int)cudaErrorInvalidValue;
  Band bd = band_of(H, W, cluster, pass_cols, 0);
  return band_clusters(band_small(bd)
                           ? k_sweep_ccl_cluster<20, 16>
                           : k_sweep_ccl_cluster<kMaxPerLane, kMaxPerLane>,
                       bd);
}

// The run-table CCL of mask u8 [B, H, W] with rmax runs per row (1..16):
// labels int32 [B, H, W], and fits int32 [B] (1: the frame took the
// tables; 0: a row has more runs, and the frame took the sweep CCL "cur" on
// the path cluster / pass_cols, as hd_sweep_ccl's).  The tables run first
// and write fits; the run ids and the sweep then skip the frames that fit.
// runid_frames: null, or int32 [1], which gets the number of frames the
// run-id product numbered.  Scratch as hd_sweep_ccl's with guard rows
// (the run ids are written only for the frames that do not fit).  Four
// launches.  Returns the first CUDA error.
extern "C" int hd_runtable_ccl(const uint8_t* mask, int B, int H, int W,
                               int rmax, int cluster, int pass_cols,
                               int16_t* rb_r, int16_t* rb_t, int32_t* plane_a,
                               int32_t* plane_b, int32_t* fits,
                               int32_t* labels, int32_t* runid_frames,
                               void* stream) {
  Plane pl = plane_of(H, W, 1);
  size_t smem = runtable_smem(rmax, H);
  bool ok = false;
  int err = path_ok(pl, cluster, pass_cols, &ok);
  if (err) return err;
  if (!ok || !sweep_fits(pl) || rmax < 1 || rmax > kWarps ||
      smem > kRuntableSmemMax ||
      (long long)(H + 2) * packed_big(H * W) + H * W >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto kernel = H <= 16 * 32 ? k_runtable_ccl<16> : k_runtable_ccl<32>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // rows of whole 16-byte lanes take one load and four stores a lane
  bool vec = W % 16 == 0 && (uintptr_t)mask % 16 == 0 &&
             (uintptr_t)labels % 16 == 0;
  kernel<<<B, kWarps * 32, smem, st>>>(H, W, rmax, packed_big(H * W),
                                       ceil_log2(H), vec, mask, fits, labels,
                                       runid_frames);
  HD_CHECK();
  // the frames that do not fit: their run ids, then the sweep CCL "cur"
  // (ss 5, nb certificate)
  err = launch_run_ids_rc<kPackMxu, kRunsFg, true>(pl, B, mask, 1, rb_r,
                                                   rb_t, st, fits,
                                                   runid_frames);
  if (err) return err;
  return launch_sweep(pl, sweep_of(pl, 5, 5, 3, kCertNb, 0, 0), B, cluster,
                      pass_cols, mask, rb_r, rb_t, fits, plane_a, plane_b,
                      labels, st);
}
