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
// Design: as ccl_sweeps.cu's sweep CCL (one block per frame to both
// certificates with no host sync; planes [B, H, W] int32 in device memory,
// read by one phase and written by the next; common.cuh's sweep_phase for
// the rows and the 32-column tiles; the class run ids from k_run_ids).
//
// What bounds it on an H100 SXM: bytes, the mask in and the labels and the
// filled mask out, 6 B/px (frames in: 8 B/px, 0.733 us per 640x480 frame
// at 3.35 TB/s).  This first design is far from that, as the sweep CCL.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;          // one block per frame
constexpr int kOffset = 1 << 19;
constexpr int kCpen = 1 << 26;      // class penalty, also "no candidate"

struct Joint {
  int steps_r, steps_c, big, inf0;
};

// The exchange at (y, x) of the plane p (feedback: loop 2's rule).
__device__ __forceinline__ int exchange(const Plane& pl, const int32_t* p,
                                        const uint8_t* m, int y, int x,
                                        bool feedback) {
  int W = pl.W;
  long long i = (long long)y * W + x;
  bool up = y > 0, dn = y < pl.H - 1, lf = x > 0, rt = x < W - 1;
  // the other class's values carry the penalty
  auto vf = [&](long long j) { return p[j] + (m[j] ? 0 : kCpen); };
  auto vb = [&](long long j) { return p[j] + (m[j] ? kCpen : 0); };
  auto vh = [&](long long j) {
    return !m[j] && p[j] >= kOffset ? p[j] : kCpen;
  };
  int v = p[i];
  // the min of vf (lh: of vh) over a row's three pixels around x
  auto lm = [&](long long r) {
    int a = vf(r);
    if (lf) a = min(a, vf(r - 1));
    if (rt) a = min(a, vf(r + 1));
    return a;
  };
  int l0 = lm(i);
  if (m[i]) {
    int c = l0;
    if (up) c = min(c, lm(i - W));
    if (dn) c = min(c, lm(i + W));
    if (feedback) {
      auto lh = [&](long long r) {
        int a = vh(r);
        if (lf) a = min(a, vh(r - 1));
        if (rt) a = min(a, vh(r + 1));
        return a;
      };
      int h = lh(i);
      if (up) h = min(h, lh(i - W));
      if (dn) h = min(h, lh(i + W));
      c = min(c, h - kOffset);
    }
    return min(v, c);
  }
  int c = l0;
  if (up) c = min(c, vf(i - W));
  if (dn) c = min(c, vf(i + W));
  c += kOffset;
  if (up) c = min(c, vb(i - W));
  if (dn) c = min(c, vb(i + W));
  return min(v, c);
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

}  // namespace

// The joint fill and labeling of mask u8 [B, H, W] (nonzero = foreground):
// labels int32 [B, H, W] (background H*W) and filled u8 [B, H, W] (0/1).
// ss_r, ss_c: the ladder steps of the row and column phases (0: whole
// lines).  Scratch: rb_r, rb_t int16 and plane_a, plane_b int32, H x W each
// per frame.  W and H at most 1024, H*W below 2^19 and the packed keys
// below 2^30.  Returns the first CUDA error.
extern "C" int hd_joint_label(const uint8_t* mask, int B, int H, int W,
                              int ss_r, int ss_c, int16_t* rb_r,
                              int16_t* rb_t, int32_t* plane_a,
                              int32_t* plane_b, int32_t* labels,
                              uint8_t* filled, void* stream) {
  Plane pl = plane_of(H, W, 0);
  Joint jt;
  jt.inf0 = kOffset + H * W;
  jt.big = 1 << ceil_log2(jt.inf0 + 2);
  int full_r = ceil_log2(W), full_c = ceil_log2(H);
  jt.steps_r = ss_r > 0 ? std::min(ss_r, full_r) : full_r;
  jt.steps_c = ss_c > 0 ? std::min(ss_c, full_c) : full_c;
  size_t smem = sweep_phase_smem(pl, kWarps);
  if (W > 32 * kMaxPerLane || H > 32 * kMaxPerLane || H * W >= kOffset ||
      (long long)std::max(W, H) * jt.big + jt.inf0 >= (1LL << 30) ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_run_ids_rc<kPackMxu, kRunsClass>(pl, B, mask, 1, rb_r,
                                                    rb_t, st);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      k_joint_label, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k_joint_label<<<B, kWarps * 32, smem, st>>>(pl, jt, mask, rb_r, rb_t,
                                              plane_a, plane_b, labels,
                                              filled);
  HD_CHECK();
  return 0;
}
