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
// in shared memory, from the rows' run ids; then to a certified fixpoint:
// each entry takes the least label of the runs of rows r +- 1 that it
// 8-overlaps ([S - 1, E + 1] against [S', E']), then the min along each
// slot's vertical chains of overlapping runs (the packed ladder over the
// whole height, chain ids as the runs); labels are written back through
// the run ids.  A frame with a row of more than R runs gets fits = 0 and
// takes the sweep CCL ("cur") instead, chosen on the card: the sweep
// kernel skips the frames whose fits is 1.
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
// The run tables of a frame fit one block's shared memory (5 x R x H ints).
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
// (chip_smoke.py phase 5f, NVIDIA H100 80GB HBM3, 700.00 W).

#include <algorithm>

#include "common.cuh"
#include "sweep_cluster.cuh"

namespace {

constexpr int kWarps = 16;          // one block per frame
constexpr int kBigc = 1 << 20;      // the TPU code's BIGC: no run

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

// One block per frame: the run-table CCL of mask u8 [B, H, W] with R slots
// per row.  rb_r: the foreground run ids along the rows of the plane with
// guard rows [B, H + 16, W].  Writes fits[b]; when it is 1, the labels.
// Shared memory: the tables S, E, L, L' and the chain ids, [R][H] each.
__global__ void __launch_bounds__(kWarps * 32, 1)
    k_runtable_ccl(Plane pl, int R, int big, int steps, const uint8_t* mask,
                   const int16_t* rb_r, int32_t* fits, int32_t* labels) {
  extern __shared__ int sm[];
  int H = pl.H, W = pl.W, RH = R * H, S = H * W;
  int *Sx = sm, *Ex = sm + RH, *Lc = sm + 2 * RH, *Ln = sm + 3 * RH,
      *pack = sm + 4 * RH;
  int b = blockIdx.x;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* m = mask + (long long)b * S;
  const int16_t* rr = rb_r + ((long long)b * pl.Hg + pl.G) * W;

  // a row's run id at its last column is its number of runs
  int over = 0;
  for (int y = threadIdx.x; y < H; y += blockDim.x)
    over |= rr[(long long)y * W + W - 1] > R;
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) fits[b] = !over;
  if (over) return;

  for (int i = threadIdx.x; i < RH; i += blockDim.x) {
    Sx[i] = kBigc;
    Ex[i] = -kBigc;
    Lc[i] = S;
  }
  __syncthreads();
  // each run's first and last column, and its label (its first pixel)
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    if (!m[i]) continue;
    int y = i / W, x = i - y * W, k = (rr[i] - 1) * H + y;
    if (x == 0 || !m[i - 1]) {
      Sx[k] = x;
      Lc[k] = i;
    }
    if (x == W - 1 || !m[i + 1]) Ex[k] = x;
  }
  __syncthreads();
  // chain ids: a slot's entry starts a chain unless it 8-overlaps the same
  // slot's entry of the row above
  for (int k = warp; k < R; k += kWarps) {
    int run = 0;
    for (int r0 = 0; r0 < H; r0 += 32) {
      int r = r0 + lane, i = k * H + r;
      bool st = r < H && (r == 0 || !(Sx[i] - 1 <= Ex[i - 1] &&
                                      Ex[i] + 1 >= Sx[i - 1]));
      unsigned bal = __ballot_sync(kFull, st);
      if (r < H) pack[i] = big * (run + __popc(bal & ((2u << lane) - 1u)));
      run += __popc(bal);
    }
  }
  __syncthreads();

  while (true) {
    // the exchange: the least label among the runs of rows r +- 1 that the
    // entry 8-overlaps
    for (int i = threadIdx.x; i < RH; i += blockDim.x) {
      int r = i % H, s = Sx[i] - 1, e = Ex[i] + 1, acc = Lc[i];
      for (int d = -1; d <= 1; d += 2) {
        int r2 = r + d;
        if (r2 < 0 || r2 >= H) continue;
        for (int j = r2; j < RH; j += H)
          if (s <= Ex[j] && e >= Sx[j]) acc = min(acc, Lc[j]);
      }
      Ln[i] = acc;
    }
    __syncthreads();
    // the min along each slot's chains, the whole height
    for (int k = warp; k < R; k += kWarps) {
      int v[kMaxPerLane], rb[kMaxPerLane];
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        int r = 32 * j + lane;
        v[j] = r < H ? Ln[k * H + r] : 0;
        rb[j] = r < H ? pack[k * H + r] : 0;
      }
      run_min<kScanMasked>(v, rb, Ln + k * H, H, steps, lane);
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        int r = 32 * j + lane;
        if (r < H) Ln[k * H + r] = v[j];
      }
    }
    __syncthreads();
    int more = 0;
    for (int i = threadIdx.x; i < RH; i += blockDim.x) more |= Ln[i] < Lc[i];
    int* t = Lc;
    Lc = Ln;
    Ln = t;
    if (!__syncthreads_or(more)) break;
  }

  int32_t* out = labels + (long long)b * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    out[i] = m[i] ? Lc[(rr[i] - 1) * H + i / W] : S;
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
// the path cluster / pass_cols, as hd_sweep_ccl's).  Scratch as
// hd_sweep_ccl's with guard rows.  Returns the first CUDA error.
extern "C" int hd_runtable_ccl(const uint8_t* mask, int B, int H, int W,
                               int rmax, int cluster, int pass_cols,
                               int16_t* rb_r, int16_t* rb_t, int32_t* plane_a,
                               int32_t* plane_b, int32_t* fits,
                               int32_t* labels, void* stream) {
  Plane pl = plane_of(H, W, 1);
  size_t smem = (size_t)5 * rmax * H * 4;
  bool ok = false;
  int err = path_ok(pl, cluster, pass_cols, &ok);
  if (err) return err;
  if (!ok || !sweep_fits(pl) || rmax < 1 || rmax > kWarps || smem > 232448 ||
      (long long)(H + 2) * packed_big(H * W) + H * W >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  err = launch_run_ids_rc<kPackMxu, kRunsFg>(pl, B, mask, 1, rb_r, rb_t, st);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      k_runtable_ccl, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k_runtable_ccl<<<B, kWarps * 32, smem, st>>>(
      pl, rmax, packed_big(H * W), ceil_log2(H), mask, rb_r, fits, labels);
  HD_CHECK();
  // the frames that do not fit: the sweep CCL "cur" (ss 5, nb certificate)
  return launch_sweep(pl, sweep_of(pl, 5, 5, 3, kCertNb, 0, 0), B, cluster,
                      pass_cols, mask, rb_r, rb_t, fits, plane_a, plane_b,
                      labels, st);
}
