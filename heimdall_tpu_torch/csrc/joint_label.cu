// Joint hole fill and labeling for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (heimdall_tpu_torch/ops/_cuda.py, wrapped
// by heimdall_tpu_torch/ops/joint_label.py).
//
// Replaces the Pallas kernel of heimdall_tpu's timing probe
// scripts/profile_joint_variants.py:98, whose labeling is
// pallas_kernels.py::_label_flood_joint (:734-894), on the preprocessed
// mask: one fixpoint over one value plane v for both classes, which gives
// the label kernel's "fill" and "ccl" stages at once.
//   foreground  its label (the least linear index reached so far);
//   background  0 once reached from the frame border, OFFSET + L in a hole
//               (L: the least label next to it), INF0 = OFFSET + H*W when
//               nothing has reached it (OFFSET = 2^19).
// The exchange (:835-856) gives each pixel a candidate from its neighbours:
// foreground the min over its foreground 8-neighbours; background the min
// over its background 4-neighbours and OFFSET + its foreground
// 4-neighbours.  A class penalty CPEN = 2^26 on the other class's values
// keeps them out of the min (2^26 + 2^30 stays below 2^31).  A phase is the
// exchange, then the min over each class run (a maximal stretch of one
// class) of the row or column, by min-scans of run-packed keys (big =
// 2^ceil(log2(INF0 + 2)); ladder of ss_r or ss_c steps).  Unit: row,
// column, row.  Loop 1 runs units until one exchange lowers nothing; then
// loop 2 lets foreground also read hole-carried labels (v - OFFSET from
// background 8-neighbours holding v >= OFFSET), which merges islands in
// holes with their enclosing component.  Loop 2 starts only after loop 1
// has converged: before that an exterior pixel may carry a passing OFFSET +
// label that would bridge two blobs (:770-777).  Then labels = v on
// foreground, v - OFFSET on holes, H*W elsewhere; filled = foreground or
// holes.
//
// The plane has no guard rows: a neighbour outside the frame does not
// count (the TPU code's guard rows and edge penalties do the same).
//
// Design: as ccl_sweeps.cu's sweep CCL, on one of two paths the host
// chooses from the frame's shape (ops/ccl_sweeps.py::band_layout with the
// mask rows): the cluster path, k_joint_label_cluster, a cluster of blocks
// per frame with both value planes and the mask rows in shared memory
// (sweep_cluster.cuh; both loops' certificates ORs over the cluster; device
// memory sees the mask and the class run ids in, the labels and the filled
// mask out), or the global path, k_joint_label, the first design kept for
// frames whose planes do not fit (one block per frame to both
// certificates, planes [B, H, W] int32 in device memory, common.cuh's
// sweep_phase).  Both take the class run ids from k_run_ids.
//
// What bounds it on an H100 SXM: bytes, the mask in and the labels and the
// filled mask out, 6 B/px (0.550 us per 640x480 frame at 3.35 TB/s; with
// the label kernel's pre stage in front, frames in: 8 B/px, 0.733 us).
// At 640x480 the cluster path takes 16 blocks of 218,176 bytes a frame, 7
// clusters at once; every pixel takes part in both loops (the background
// carries the border's flood), so no line is skipped.  rowFull_col5 alone,
// run ids included, batch 256 of the bench's pre masks: 72.56-73.07
// us/frame on the cluster path, 148.60-148.61 on the global path; the
// probe with its pre stage 85.44-85.49 against the first design's
// 157.95-158.00 (chip_smoke.py phase 5f, NVIDIA H100 80GB HBM3, 700.00 W).

#include <algorithm>

#include "common.cuh"
#include "sweep_cluster.cuh"

namespace {

constexpr int kWarps = 16;          // one block per frame
constexpr int kOffset = 1 << 19;
constexpr int kCpen = 1 << 26;      // class penalty, also "no candidate"

struct Joint {
  int steps_r, steps_c, big, inf0;
};

// The exchange at column x of a row: p0 its values and m0 its mask, pu / mu
// and pd / md the rows above and below (null outside the frame); feedback:
// loop 2's rule.
__device__ __forceinline__ int exchange_rows(const int32_t* pu,
                                             const int32_t* p0,
                                             const int32_t* pd,
                                             const uint8_t* mu,
                                             const uint8_t* m0,
                                             const uint8_t* md, int x, int W,
                                             bool feedback) {
  bool up = pu != nullptr, dn = pd != nullptr, lf = x > 0, rt = x < W - 1;
  // the other class's values carry the penalty
  auto vf = [&](const int32_t* p, const uint8_t* m, int j) {
    return p[j] + (m[j] ? 0 : kCpen);
  };
  auto vb = [&](const int32_t* p, const uint8_t* m, int j) {
    return p[j] + (m[j] ? kCpen : 0);
  };
  auto vh = [&](const int32_t* p, const uint8_t* m, int j) {
    return !m[j] && p[j] >= kOffset ? p[j] : kCpen;
  };
  int v = p0[x];
  // the min of vf (lh: of vh) over a row's three pixels around x
  auto lm = [&](const int32_t* p, const uint8_t* m) {
    int a = vf(p, m, x);
    if (lf) a = min(a, vf(p, m, x - 1));
    if (rt) a = min(a, vf(p, m, x + 1));
    return a;
  };
  int l0 = lm(p0, m0);
  if (m0[x]) {
    int c = l0;
    if (up) c = min(c, lm(pu, mu));
    if (dn) c = min(c, lm(pd, md));
    if (feedback) {
      auto lh = [&](const int32_t* p, const uint8_t* m) {
        int a = vh(p, m, x);
        if (lf) a = min(a, vh(p, m, x - 1));
        if (rt) a = min(a, vh(p, m, x + 1));
        return a;
      };
      int h = lh(p0, m0);
      if (up) h = min(h, lh(pu, mu));
      if (dn) h = min(h, lh(pd, md));
      c = min(c, h - kOffset);
    }
    return min(v, c);
  }
  int c = l0;
  if (up) c = min(c, vf(pu, mu, x));
  if (dn) c = min(c, vf(pd, md, x));
  c += kOffset;
  if (up) c = min(c, vb(pu, mu, x));
  if (dn) c = min(c, vb(pd, md, x));
  return min(v, c);
}

// The exchange at (y, x) of the plane p [H, W] with mask m.
__device__ __forceinline__ int exchange(const Plane& pl, const int32_t* p,
                                        const uint8_t* m, int y, int x,
                                        bool feedback) {
  long long r = (long long)y * pl.W;
  bool up = y > 0, dn = y < pl.H - 1;
  return exchange_rows(up ? p + r - pl.W : nullptr, p + r,
                       dn ? p + r + pl.W : nullptr, up ? m + r - pl.W : nullptr,
                       m + r, dn ? m + r + pl.W : nullptr, x, pl.W, feedback);
}

// One block per frame: the joint fixpoint of mask u8 [B, H, W] into labels
// int32 and filled u8 [B, H, W], through the planes a and b [B, H, W].
// rb_r [B, H, W] and rb_t [B, W, H] are the class run ids.
__global__ void __launch_bounds__(kWarps * 32, 1)
    k_joint_label(Plane pl, Joint jt, const uint8_t* mask,
                  const int16_t* rb_r, const int16_t* rb_t, int32_t* plane_a,
                  int32_t* plane_b, int32_t* labels, uint8_t* filled) {
  extern __shared__ int smem[];
  int b = blockIdx.x, H = pl.H, W = pl.W, S = H * W;
  int32_t* cur = plane_a + (long long)b * S;
  int32_t* nxt = plane_b + (long long)b * S;
  const uint8_t* m = mask + (long long)b * S;
  const int16_t* rr = rb_r + (long long)b * S;
  const int16_t* rc = rb_t + (long long)b * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    int y = i / W, x = i - y * W;
    bool border = y == 0 || y == H - 1 || x == 0 || x == W - 1;
    cur[i] = m[i] ? i : (border ? 0 : jt.inf0);
  }
  __syncthreads();

  bool feedback = false;
  auto phase = [&](bool cols, int steps) {
    auto cand = [&](int y, int x) {
      return exchange(pl, cur, m, y, x, feedback);
    };
    auto out = [&](int y, int x, int v) { nxt[(long long)y * W + x] = v; };
    if (cols)
      sweep_phase<true>(pl, 0, H, rc, jt.big, steps, smem, kWarps, cand, out);
    else
      sweep_phase<false>(pl, 0, H, rr, jt.big, steps, smem, kWarps, cand,
                         out);
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  };
  // does one exchange lower any value?
  auto more = [&]() {
    int lower = 0;
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      int y = i / W;
      lower |= exchange(pl, cur, m, y, i - y * W, feedback) < cur[i];
    }
    return __syncthreads_or(lower);
  };
  auto unit = [&]() {
    phase(false, jt.steps_r);
    phase(true, jt.steps_c);
    phase(false, jt.steps_r);
  };

  do unit();
  while (more());
  feedback = true;
  while (more()) unit();

  int32_t* lab = labels + (long long)b * S;
  uint8_t* fil = filled + (long long)b * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    int v = cur[i];
    bool hole = !m[i] && v >= kOffset;
    lab[i] = m[i] ? v : (hole ? v - kOffset : S);
    fil[i] = m[i] || hole;
  }
}

// A cluster per frame (sweep_cluster.cuh): the joint fixpoint of mask u8
// [B, H, W] into labels int32 and filled u8 [B, H, W], with both value
// planes and the mask rows in the cluster's shared memory; the loops and
// certificates are k_joint_label's.
template <int kPerR, int kPerC>
__global__ void __launch_bounds__(kBandWarps * 32, 1)
    k_joint_label_cluster(Plane pl, Band bd, Joint jt, const uint8_t* mask,
                          const int16_t* rb_r, const int16_t* rb_t,
                          int32_t* labels, uint8_t* filled) {
  extern __shared__ int smem[];
  BandFrame f(bd, smem);
  int b = blockIdx.y, H = pl.H, W = pl.W, S = H * W;
  const uint8_t* m = mask + (long long)b * S;
  const int16_t* rr = rb_r + (long long)b * S;
  const int16_t* rc = rb_t + (long long)b * S;
  f.load_mask(m);
  int* cur = f.A;
  int* nxt = f.B;
  f.for_own([&](int y, int x) {
    int p = y * W + x;
    bool border = y == 0 || y == H - 1 || x == 0 || x == W - 1;
    f.row(f.A, y)[x] = m[p] ? p : (border ? 0 : jt.inf0);
  });
  f.cl.sync();     // every block has started and holds its rows and map

  bool feedback = false;
  auto ex = [&](int y, int x) {
    return exchange_rows(f.row(cur, y - 1), f.row(cur, y), f.row(cur, y + 1),
                         f.mrow(y - 1), f.mrow(y), f.mrow(y + 1), x, W,
                         feedback);
  };
  auto out = [&](int, int x, int v, int, int* nr) { nr[x] = v; };
  auto phase = [&](bool cols, int steps) {
    if (cols)
      band_phase<kPerR, kPerC, true, false, false>(f, pl, rc, jt.big, steps,
                                                   cur, nxt, ex, out);
    else
      band_phase<kPerR, kPerC, false, false, false>(f, pl, rr, jt.big, steps,
                                                    cur, nxt, ex, out);
    int* t = cur;
    cur = nxt;
    nxt = t;
  };
  // does one exchange lower any value?
  auto more = [&]() {
    f.copy_halo(cur);
    int lower = 0;
    f.for_own([&](int y, int x) { lower |= ex(y, x) < f.row(cur, y)[x]; });
    return f.any(lower);
  };
  auto unit = [&]() {
    phase(false, jt.steps_r);
    phase(true, jt.steps_c);
    phase(false, jt.steps_r);
  };

  do unit();
  while (more());
  feedback = true;
  while (more()) unit();

  int32_t* lab = labels + (long long)b * S;
  uint8_t* fil = filled + (long long)b * S;
  f.for_own([&](int y, int x) {
    int v = f.row(cur, y)[x];
    bool fg = f.mrow(y)[x], hole = !fg && v >= kOffset;
    lab[y * W + x] = fg ? v : (hole ? v - kOffset : S);
    fil[y * W + x] = fg || hole;
  });
}

// The joint fixpoint's parameters for H x W frames and ladder steps ss_r,
// ss_c (0: whole lines), and whether the shape is in range.
bool joint_of(int H, int W, int ss_r, int ss_c, Joint* jt) {
  jt->inf0 = kOffset + H * W;
  jt->big = 1 << ceil_log2(jt->inf0 + 2);
  int full_r = ceil_log2(W), full_c = ceil_log2(H);
  jt->steps_r = ss_r > 0 ? std::min(ss_r, full_r) : full_r;
  jt->steps_c = ss_c > 0 ? std::min(ss_c, full_c) : full_c;
  return W <= 32 * kMaxPerLane && H <= 32 * kMaxPerLane && H * W < kOffset &&
         (long long)std::max(W, H) * jt->big + jt->inf0 < (1LL << 30) &&
         sweep_phase_smem(plane_of(H, W, 0), kWarps) <= 232448;
}

}  // namespace

// The joint fill and labeling of mask u8 [B, H, W] (nonzero = foreground):
// labels int32 [B, H, W] (background H*W) and filled u8 [B, H, W] (0/1).
// ss_r, ss_c: the ladder steps of the row and column phases (0: whole
// lines).  cluster: the cluster path's blocks a frame (1, 2, 4, 8 or 16)
// with pass_cols (8, 16 or 32) columns a pass, or 0 for the global path.
// Scratch: rb_r, rb_t int16, H x W each per frame, and for the global path
// plane_a, plane_b int32 of that size (null on the cluster path).  W and H
// at most 1024, H*W below 2^19 and the packed keys below 2^30.  Returns the
// first CUDA error.
extern "C" int hd_joint_label(const uint8_t* mask, int B, int H, int W,
                              int ss_r, int ss_c, int cluster, int pass_cols,
                              int16_t* rb_r, int16_t* rb_t, int32_t* plane_a,
                              int32_t* plane_b, int32_t* labels,
                              uint8_t* filled, void* stream) {
  Plane pl = plane_of(H, W, 0);
  Joint jt;
  bool ok = joint_of(H, W, ss_r, ss_c, &jt);
  Band bd = band_of(H, W, cluster > 0 ? cluster : 1, pass_cols, 1);
  if (ok && cluster) {
    int err = band_fits(bd, &ok);
    if (err) return err;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_run_ids_rc<kPackMxu, kRunsClass>(pl, B, mask, 1, rb_r,
                                                    rb_t, st);
  if (err) return err;
  if (cluster)
    return band_launch(band_small(bd)
                           ? k_joint_label_cluster<20, 16>
                           : k_joint_label_cluster<kMaxPerLane, kMaxPerLane>,
                       bd, B, st, pl, bd, jt, mask, (const int16_t*)rb_r,
                       (const int16_t*)rb_t, labels, filled);
  size_t smem = sweep_phase_smem(pl, kWarps);
  cudaError_t e = cudaFuncSetAttribute(
      k_joint_label, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k_joint_label<<<B, kWarps * 32, smem, st>>>(pl, jt, mask, rb_r, rb_t,
                                              plane_a, plane_b, labels,
                                              filled);
  HD_CHECK();
  return 0;
}

// How many clusters of the joint fixpoint's cluster path the current
// device runs at once for H x W frames, or minus a CUDA error.
extern "C" int hd_joint_label_clusters(int H, int W, int cluster,
                                       int pass_cols) {
  if (cluster < 1) return -(int)cudaErrorInvalidValue;
  Band bd = band_of(H, W, cluster, pass_cols, 1);
  return band_clusters(band_small(bd)
                           ? k_joint_label_cluster<20, 16>
                           : k_joint_label_cluster<kMaxPerLane, kMaxPerLane>,
                       bd);
}
