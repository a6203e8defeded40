// The per-step primitive microbench (ops/primitives.py): one primitive of
// the sweep kernels applied `iters` times to each frame's plane [sub, W]
// with a data-dependent carry, then rows [0, out_rows) stored as int32.
// Replaces the Pallas kernel of heimdall_tpu's scripts/microbench_vpu.py
// (make_call's kernel, :280-306, launched at :296), whose 27 variants time
// the TPU's per-step costs by differencing N = 36 against N = 4.
//
// What bounds it: the steps' integer operations (and mxu_cumsum's
// tensor-core products): device memory is read once and written once per
// call, and that cancels in the difference.  So the carry stays on chip for
// all N steps, as the TPU keeps it in VMEM, and between two operations of a
// step it stays in registers:
//
// * row-local steps (every step but transpose_pair, mxu_cumsum and the
//   four cross-row ones): a warp per row, 20 values a lane.  A shifted
//   read is a register move or a warp shuffle, never shared memory.  The
//   layout is chosen per step: blocked (x = 20 * lane + j) for the
//   one-shift steps and masked_ladder5, where a shift by d < 20 costs d
//   shuffles a lane; strided (x = 32 * j + lane) for the 10-rung ladders,
//   where a shift by 32 q is a register rename and d < 32 one shuffle an
//   element, and for add and select, which read no neighbour (their
//   loads coalesce).  A read off the line's start is a test on the lane alone.
//   The roll's wrap at W = 640 is the same move; a roll of a narrower row
//   reads through a line buffer in shared memory, as its wrap is not a
//   register move (the bench's rows are 640 wide);
// * mxu_cumsum: 16 rows per block, the bf16 operand A double-buffered in
//   shared memory and written by the products' epilogue for the next
//   step, read as ldmatrix.x4 fragments, each reused by all of a warp's
//   column tiles; the triangular product on the tensor cores (mma_bf16,
//   the triangle's fragments from indices, the k tiles above the diagonal
//   skipped, as k_run_ids); one block barrier a step;
// * transpose_pair: a warp per 32 x 32 tile in registers, as 4 x 4 blocks
//   of 8 x 8 16-bit pairs in movmatrix's layout (int32: a plane of low and
//   one of high halves); a transpose is a movmatrix a block and a rename
//   of the blocks (the TPU transposes the whole plane on its XLU; the
//   result is the same);
// * cross-row steps (nbmin8, nbmin_guard, nbmin_masked_sub,
//   sublane_mask_add): one frame per cluster of blocks, a band of 4 rows
//   per warp in registers in the blocked layout (the lane part: register
//   moves and two shuffles a row).  A warp stores its band's edge rows
//   into its neighbours' halo slots (shared memory, or distributed shared
//   memory across blocks; double-buffered by the step's parity), arrives
//   at the cluster barrier, computes its interior rows, waits, and
//   computes its edge rows: one split cluster barrier a step.  Frames of
//   more than 1024 rows keep a block's band of rows in shared memory
//   (k_cross_rows: two cluster barriers a step), as registers cannot
//   hold them.
//
// The i16 and i8 variants keep their planes in their own type in memory
// and compute per element in int registers.  add wraps to the type once,
// at the store (v + N mod 2^16 or 2^8 is the type's N wrapped adds), and
// select never leaves the type (v + 1 only where v <= 0).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// ops/primitives.py: STEPS, in order
enum Step {
  kMinScan, kMaxScan, kOrRoll, kNbmin8, kAdd, kSelect, kTransposePair,
  kSegMin, kMxuCumsum, kCumsumLadder, kMaskedMin, kMaskedLadder5,
  kNbminGuard, kNbminMaskedSub, kOrAndMask, kMaxLadderFull, kSublaneMaskAdd
};

constexpr int kMaxW = 640;           // the widest plane: 20 values a lane
constexpr int kPer = kMaxW / 32;
constexpr int kWarps = 8;            // row-local and transpose blocks
constexpr int kCluster = 8;          // blocks of a frame in shared memory
constexpr int kCrossThreads = 640;
constexpr int kBandRows = 4;         // rows of a warp's band in registers
constexpr int kBandWarps = 16;       // most warps of a band block
constexpr int kMaxBandCluster = 16;
constexpr int kCumRows = 16;         // mxu_cumsum: rows of one mma tile
constexpr int kCumTiles = kMaxW / 8 / kWarps;   // column tiles of a warp
constexpr int kGuard = 1 << 24;      // nbmin_guard's and sublane's masks
constexpr int kFloor = -(1 << 22);   // max_ladder_full's

template <typename T>
constexpr int dtype_code() {
  return sizeof(T) == 4 ? 0 : (sizeof(T) == 2 ? 1 : 2);
}

// steps that roll a row (wrap at W), and those on the strided layout
__host__ __device__ constexpr bool rolls(int s) {
  return s == kOrRoll || s == kMaskedMin || s == kMaskedLadder5 ||
         s == kMaxLadderFull;
}
__host__ __device__ constexpr bool strided(int s) {
  return s == kCumsumLadder || s == kMaxLadderFull || s == kAdd ||
         s == kSelect;
}

// a + b with two's-complement wrap-around (the plain version's int add)
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// v in T, as the plain version's narrow add leaves it
template <typename T>
__device__ __forceinline__ int wrap(int v) {
  return (int)(T)v;
}

// v, hidden from the compiler, so that steps with no shifted read (add,
// select) are not folded across the loop (N adds into one).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// The position of a lane's j-th value: strided or blocked layout.
template <bool kStr>
__device__ __forceinline__ int pos(int j, int lane) {
  return kStr ? 32 * j + lane : kPer * lane + j;
}

// Blocked layout, 1 <= d < 20: u = the values at x - d, the lane's own
// v[j - d] or the previous lane's v[j - d + 20] (lane 0: lane 31's, at
// x - d + 640, the roll's wrap at W = 640).
template <int d>
__device__ __forceinline__ void lower_b(const int (&v)[kPer],
                                       int (&u)[kPer], int lane) {
  int src = (lane + 31) & 31;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    u[j] = j >= d ? v[j - d] : __shfl_sync(kFull, v[j - d + kPer], src);
}

// Strided layout, 1 <= d < 32: u = the values at x - d, from lane
// (lane - d) mod 32, which sends its v[j] or, to the lanes below d, its
// v[j - 1] (v[19] for j = 0: x - d + 640, the roll's wrap at W = 640).
template <int d>
__device__ __forceinline__ void lower_s(const int (&v)[kPer],
                                       int (&u)[kPer], int lane) {
  bool up = lane >= 32 - d;
  int src = (lane - d) & 31;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    u[j] = __shfl_sync(kFull, up ? v[(j + kPer - 1) % kPer] : v[j], src);
}

// roll(v, d) plus p where the read wrapped (every position when d >= W),
// through the warp's line buffer: rows narrower than 640, whose wrap is
// not a register move.
template <bool kStr>
__device__ __forceinline__ void roll_line(const int (&v)[kPer],
                                          int (&u)[kPer], int* line, int W,
                                          int lane, int d, int p) {
  __syncwarp();                      // the previous reads are done
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int x = pos<kStr>(j, lane);
    if (x < W) line[x] = v[j];
  }
  __syncwarp();
  int e = d < W ? d : d % W, all = d < W ? 0 : p;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int x = pos<kStr>(j, lane), s = x - e, w = s >> 31;
    u[j] = x < W ? wadd(line[s + (w & W)], (w & p) | all) : 0;
  }
}

// One ladder rung: v = max (kMax) or min of v and roll(v, d) plus p where
// the read wrapped (d < 20 blocked; any d < 640 strided).
template <int d, bool kMax, bool kStr, bool kW640>
__device__ __forceinline__ void pen_rung(int (&v)[kPer], int* line, int W,
                                         int lane, int p) {
  int u[kPer];
  if constexpr (!kW640) {
    roll_line<kStr>(v, u, line, W, lane, d, p);
  } else if constexpr (!kStr) {
    lower_b<d>(v, u, lane);
#pragma unroll
    for (int j = 0; j < d; ++j) u[j] = wadd(u[j], lane == 0 ? p : 0);
  } else if constexpr (d < 32) {
    lower_s<d>(v, u, lane);
    u[0] = wadd(u[0], lane < d ? p : 0);
  } else {
    constexpr int q = d / 32;        // a rename: x - d is 32 (j - q) + lane
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      u[j] = j >= q ? v[j - q] : wadd(v[j - q + kPer], p);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    v[j] = kMax ? max(v[j], u[j]) : min(v[j], u[j]);
}

// The rungs d, 2 d, ... < kEnd of a ladder, in order.
template <int d, int kEnd, bool kMax, bool kStr, bool kW640>
__device__ __forceinline__ void pen_ladder(int (&v)[kPer], int* line, int W,
                                           int lane, int p) {
  pen_rung<d, kMax, kStr, kW640>(v, line, W, lane, p);
  if constexpr (2 * d < kEnd)
    pen_ladder<2 * d, kEnd, kMax, kStr, kW640>(v, line, W, lane, p);
}

// cumsum_ladder's rungs d, 2 d, ... < 1024 (strided): v += v at x - d, 0
// off the line's start.
template <int d>
__device__ __forceinline__ void sum_ladder(int (&v)[kPer], int lane) {
  if constexpr (d < 32) {
    int u[kPer];
    lower_s<d>(v, u, lane);
    u[0] = lane < d ? 0 : u[0];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = wadd(v[j], u[j]);
  } else {
    constexpr int q = d / 32;
#pragma unroll
    for (int j = kPer - 1; j >= q; --j) v[j] = wadd(v[j], v[j - q]);
  }
  if constexpr (2 * d < 1024) sum_ladder<2 * d>(v, lane);
}

// v = v op (v at x - 1, or fill at x = 0), blocked layout.
template <typename Op>
__device__ __forceinline__ void scan_step(int (&v)[kPer], int lane,
                                          int fill, Op op) {
  int u[kPer];
  lower_b<1>(v, u, lane);
  u[0] = lane == 0 ? fill : u[0];
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = op(v[j], u[j]);
}

// One step of a row-local primitive on the warp's row v (seg_min_step:
// values v, flags f).
template <int kS, typename T, bool kW640>
__device__ __forceinline__ void row_step(int (&v)[kPer], int (&f)[kPer],
                                         int* line, int W, int lane) {
  if constexpr (kS == kMinScan) {
    scan_step(v, lane, 63, [](int a, int u) { return min(a, u); });
  } else if constexpr (kS == kMaxScan) {
    scan_step(v, lane, -1, [](int a, int u) { return max(a, u); });
  } else if constexpr (kS == kOrAndMask) {
    scan_step(v, lane, 0, [](int a, int u) { return a | u; });
  } else if constexpr (kS == kOrRoll) {
    int u[kPer];
    if constexpr (kW640) lower_b<1>(v, u, lane);
    else roll_line<false>(v, u, line, W, lane, 1, 0);
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] |= u[j];
  } else if constexpr (kS == kAdd) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = opaque(wadd(v[j], 1));
  } else if constexpr (kS == kSelect) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = opaque(v[j] > 0 ? v[j] : v[j] + 1);
  } else if constexpr (kS == kSegMin) {
    int u[kPer], g[kPer];
    lower_b<1>(v, u, lane);
    lower_b<1>(f, g, lane);
    u[0] = lane == 0 ? 63 : u[0];
    g[0] = lane == 0 ? 1 : g[0];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = f[j] > 0 ? v[j] : min(v[j], u[j]);
      f[j] |= g[j];
    }
  } else if constexpr (kS == kCumsumLadder) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] &= 1;
    sum_ladder<1>(v, lane);
  } else if constexpr (kS == kMaskedMin) {
    pen_rung<1, false, false, kW640>(v, line, W, lane, kPen);
  } else if constexpr (kS == kMaskedLadder5) {
    pen_ladder<1, 32, false, false, kW640>(v, line, W, lane, kPen);
  } else if constexpr (kS == kMaxLadderFull) {
    pen_ladder<1, 1024, true, true, kW640>(v, line, W, lane, kFloor);
  }
}

// Row-local steps: a warp per row (seg_min_step: per pair of rows r and
// r + sub / 2), blocks of kWarps rows of one frame (blockIdx.y).  kW640:
// W is 640 (a roll's wrap is a register move).
template <int kS, typename T, bool kW640>
__global__ void __launch_bounds__(kWarps * 32)
    k_rows(const T* x, int sub, int W, int iters, int out_rows,
           int32_t* out) {
  constexpr bool kStr = strided(kS);
  constexpr bool kLine = rolls(kS) && !kW640;
  __shared__ int s_line[kLine ? kWarps : 1][kLine ? kMaxW : 1];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int units = kS == kSegMin ? sub / 2 : sub;
  int row = blockIdx.x * kWarps + warp, b = blockIdx.y;
  if (row >= units) return;
  const T* xb = x + (long long)b * sub * W;
  int v[kPer], f[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int xx = pos<kStr>(j, lane);
    v[j] = xx < W ? (int)xb[(long long)row * W + xx] : 0;
    f[j] = kS == kSegMin && xx < W ? (int)xb[(long long)(row + units) * W + xx]
                                   : 0;
  }
  int* line = s_line[kLine ? warp : 0];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) row_step<kS, T, kW640>(v, f, line, W, lane);
  if (out_rows == 1 && row > 0) return;
  int32_t* ob = out + (long long)b * out_rows * W;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int xx = pos<kStr>(j, lane);
    if (xx >= W) continue;
    ob[(long long)row * W + xx] = kS == kAdd ? wrap<T>(v[j]) : v[j];
    if (kS == kSegMin && out_rows > 1)
      ob[(long long)(row + units) * W + xx] = f[j];
  }
}

// The 8 x 8 transpose of a warp's 16-bit pairs (row lane / 4, columns
// 2 (lane % 4) and + 1, the lower column in the low half).
__device__ __forceinline__ uint32_t movm(uint32_t a) {
  uint32_t t;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(t) : "r"(a));
  return t;
}

// m (kP planes of 4 x 4 blocks) = its 32 x 32 transpose.
template <int kP>
__device__ __forceinline__ void transpose32(uint32_t (&m)[kP][4][4]) {
  uint32_t t[kP][4][4];
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) t[p][i][k] = movm(m[p][k][i]);
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) m[p][i][k] = t[p][i][k];
}

// transpose_pair: a warp per 32 x 32 tile, blocks of kWarps tiles of one
// frame.  The tile's 8 x 8 block (I, J) is one register a lane (two
// planes, low and high halves, for int32): lane l holds row 8 I + l / 4,
// columns 8 J + 2 (l % 4) and + 1.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    k_transpose_pair(const T* x, int sub, int W, int iters, int out_rows,
                     int32_t* out) {
  constexpr int kP = sizeof(T) == 4 ? 2 : 1;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int tiles_x = (W + 31) / 32, tiles = (sub + 31) / 32 * tiles_x;
  int t = blockIdx.x * kWarps + warp, b = blockIdx.y;
  if (t >= tiles) return;
  int y0 = t / tiles_x * 32 + (lane >> 2), x0 = t % tiles_x * 32 +
                                                2 * (lane & 3);
  const T* xb = x + (long long)b * sub * W;
  uint32_t m[kP][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int y = y0 + 8 * i, c = x0 + 8 * k;
      const T* p = xb + (long long)y * W + c;
      int a = y < sub && c < W ? (int)p[0] : 0;
      int e = y < sub && c + 1 < W ? (int)p[1] : 0;
      m[0][i][k] = __byte_perm(a, e, 0x5410);
      if constexpr (kP == 2) m[kP - 1][i][k] = __byte_perm(a, e, 0x7632);
    }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    transpose32(m);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (kP == 1) {
          m[0][i][k] = __vmins2(m[0][i][k], 0x003F003Fu);
        } else {
          int a = min((int)__byte_perm(m[0][i][k], m[1][i][k], 0x5410), 63);
          int e = min((int)__byte_perm(m[0][i][k], m[1][i][k], 0x7632), 63);
          m[0][i][k] = __byte_perm(a, e, 0x5410);
          m[1][i][k] = __byte_perm(a, e, 0x7632);
        }
      }
    transpose32(m);
  }
  int32_t* ob = out + (long long)b * out_rows * W;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int y = y0 + 8 * i, c = x0 + 8 * k;
      if (y >= out_rows) continue;
      uint32_t lo = m[0][i][k], hi = m[kP - 1][i][k];
      int a = kP == 2 ? (int)__byte_perm(lo, hi, 0x5410)
                      : (int)(lo << 16) >> 16;
      int e = kP == 2 ? (int)__byte_perm(lo, hi, 0x7632) : (int)lo >> 16;
      if (c < W) ob[(long long)y * W + c] = a;
      if (c + 1 < W) ob[(long long)y * W + c + 1] = e;
    }
}

// A's fragment of one 16 x 16 k tile (ldmatrix.x4; lane l gives the
// address of row l % 16, columns 8 (l / 16) ..): mma_bf16's a0 .. a3.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const void* p) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// mxu_cumsum: kCumRows rows of one frame per block, their low bits as bf16
// A [2][16][648] (double-buffered by the step's parity; a 640-wide plane
// whatever W, the columns past W zero at first and never read into a
// column below W); each step d = A x U (U[k][j] = k <= j) on the tensor
// cores.  Warp w holds the accumulators of the 8-wide column tiles nt = w
// + 8 q (q < 10), whose last k tile, at the diagonal, is 4 q + w / 2: so
// the k tiles run in chunks, chunk q0 ending at q0's diagonal and taking
// the tiles q >= q0, with no test in the loop, and each k tile's fragment
// of A is loaded once (ldmatrix.x4) for all of them.  The epilogue writes
// the next step's A, (int)d & 1, and the last step's d gives the carry,
// (int)d & 63.
__global__ void __launch_bounds__(kWarps * 32)
    k_mxu_cumsum(const int32_t* x, int sub, int W, int iters, int out_rows,
                 int32_t* out) {
  extern __shared__ __align__(16) uint32_t s_a[];
  constexpr int stride = kMaxW + 8, half = stride / 2;   // bf16, words
  uint16_t* s16 = reinterpret_cast<uint16_t*>(s_a);
  int y0 = blockIdx.x * kCumRows, b = blockIdx.y;
  const int32_t* xb = x + (long long)b * sub * W;
  int32_t* ob = out + (long long)b * out_rows * W;
  if (iters == 0) {
    for (int i = threadIdx.x; i < kCumRows * W; i += blockDim.x) {
      int r = i / W, c = i - r * W;
      if (y0 + r < out_rows) ob[(long long)(y0 + r) * W + c] =
          xb[(long long)(y0 + r) * W + c];
    }
    return;
  }
  for (int i = threadIdx.x; i < 2 * kCumRows * half; i += blockDim.x)
    s_a[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < kCumRows * W; i += blockDim.x) {
    int r = i / W, c = i - r * W;
    s16[r * stride + c] = (uint16_t)bf16_one(
        y0 + r < sub && (xb[(long long)(y0 + r) * W + c] & 1));
  }
  __syncthreads();
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int gid = lane >> 2, tig = lane & 3, h = warp >> 1;
  // the diagonal tile's U fragment: j - k there is 8 (w % 2) + gid - 2 tig
  int jr = 8 * (warp & 1) + gid, kr = 2 * tig;
  uint32_t t0 = bf16_one(kr <= jr) | bf16_one(kr + 1 <= jr) << 16;
  uint32_t t1 = bf16_one(kr + 8 <= jr) | bf16_one(kr + 9 <= jr) << 16;
  constexpr uint32_t kOnes = 0x3F803F80u;
  const uint16_t* a_row = s16 + (lane & 15) * stride + (lane >> 4) * 8;
  float d[kCumTiles][4];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const uint16_t* A = a_row + (it & 1) * kCumRows * stride;
#pragma unroll
    for (int q = 0; q < kCumTiles; ++q)
      d[q][0] = d[q][1] = d[q][2] = d[q][3] = 0.f;
    uint32_t a[4];
#pragma unroll
    for (int q0 = 0; q0 < kCumTiles; ++q0) {
      int kt_hi = 4 * q0 + h;                  // q0's diagonal
#pragma unroll 1
      for (int kt = q0 == 0 ? 0 : kt_hi - 3; kt < kt_hi; ++kt) {
        ldmatrix_x4(a, A + kt * 16);
#pragma unroll
        for (int q = q0; q < kCumTiles; ++q) mma_bf16(d[q], a, kOnes, kOnes);
      }
      ldmatrix_x4(a, A + kt_hi * 16);
      mma_bf16(d[q0], a, t0, t1);
#pragma unroll
      for (int q = q0 + 1; q < kCumTiles; ++q)
        mma_bf16(d[q], a, kOnes, kOnes);
    }
    // the next step's A, into the other buffer: the step's reads of it
    // ended at the previous step's barrier
    uint32_t* An = s_a + ((it + 1) & 1) * kCumRows * half;
#pragma unroll
    for (int q = 0; q < kCumTiles; ++q) {
      int w = (8 * (warp + kWarps * q) + 2 * tig) >> 1;
      An[gid * half + w] = bf16_one((int)d[q][0] & 1) |
                           bf16_one((int)d[q][1] & 1) << 16;
      An[(gid + 8) * half + w] = bf16_one((int)d[q][2] & 1) |
                                 bf16_one((int)d[q][3] & 1) << 16;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kCumTiles; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = y0 + gid + (i >> 1) * 8;
      int c = 8 * (warp + kWarps * q) + 2 * tig + (i & 1);
      if (r < out_rows && c < W)
        ob[(long long)r * W + c] = (int)d[q][i] & 63;
    }
}

// The lane part of a cross-row step on one row v of a band (blocked
// layout): v = min(v, left, right), the neighbours filled with 63
// (nbmin8) or rolled with the guard added where they wrap (nbmin_guard,
// nbmin_masked_sub).  kW640: W is 640, so that a lane's edge and the
// roll's wrap are the shuffles' own; else the position W - 1 and the wrap
// are tested per value.
template <int kS, bool kW640>
__device__ __forceinline__ void lane_part(int (&v)[kPer], int W, int lane) {
  constexpr bool kRoll = kS != kNbmin8;
  int left = __shfl_sync(kFull, v[kPer - 1], (lane + 31) & 31);
  int right = __shfl_sync(kFull, v[0], (lane + 1) & 31);
  int first = __shfl_sync(kFull, v[0], 0);        // position 0
  int last_v = 0;                                   // position W - 1
  if constexpr (kRoll && !kW640) {
    int j_last = (W - 1) % kPer, r = v[0];
#pragma unroll
    for (int j = 1; j < kPer; ++j) r = j == j_last ? v[j] : r;
    last_v = __shfl_sync(kFull, r, (W - 1) / kPer);
  }
  if (lane == 0)
    left = kRoll ? wadd(kW640 ? left : last_v, kGuard) : 63;
  int edge = kRoll ? wadd(first, kGuard) : 63;    // the right of W - 1
  if (kW640 && lane == 31) right = edge;
  int prev = left;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int r = j + 1 < kPer ? v[j + 1] : right;
    if (!kW640 && kPer * lane + j == W - 1) r = edge;
    int cur = v[j];
    v[j] = min(cur, min(prev, r));
    prev = cur;
  }
}

// A band's row (20 values a lane) into a halo slot at off (lane's values
// at off + 32 j): the block's own shared memory, or far, another block's
// (distributed shared memory).
__device__ __forceinline__ void put_row(int* s_halo, int off, int* far,
                                        const int (&row)[kPer]) {
  if (far) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) far[off + j * 32] = row[j];
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) s_halo[off + j * 32] = row[j];
  }
}

// Cross-row steps with the frame in registers: one frame (blockIdx.y) per
// cluster of C blocks of wb warps; warp w of block c holds the band g =
// c wb + w, rows [4 g, 4 g + n) (n < 4 only in the frame's last band gl),
// and two halo slots per parity in shared memory: s_halo[parity][0][w]
// the row above the band, [1][w] the row below, each 20 values a lane
// stored at j * 32 + lane.  A step: the lane part of each row; the band's
// last row into the above-slot of band g + 1 and its first row into the
// below-slot of band g - 1 (the wrap variants: band gl's last row into
// band 0's above-slot, nbmin_guard band 0's first row into band gl's
// below-slot), remote where the band is another block's; the cluster
// barrier's arrival; the interior rows; its wait; the edge rows.
template <int kS, typename T, bool kW640>
__global__ void __launch_bounds__(kBandWarps * 32, 1)
    k_cross_bands(const T* x, int sub, int W, int iters, int out_rows,
                  int32_t* out) {
  extern __shared__ __align__(16) int s_halo[];
  constexpr bool kWrapUp = kS == kNbminGuard || kS == kSublaneMaskAdd;
  constexpr bool kBelow = kS != kSublaneMaskAdd;
  constexpr bool kWrapDown = kS == kNbminGuard;
  cg::cluster_group cluster = cg::this_cluster();
  int wb = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int c = (int)cluster.block_rank(), b = blockIdx.y;
  int g = c * wb + warp, y0 = g * kBandRows;
  int n = max(0, min(kBandRows, sub - y0));
  int gl = (sub - 1) / kBandRows;
  int slot = 2 * wb * kMaxW;                       // a parity's slots
  // the slots this band writes: their offsets in the target block's
  // s_halo, and the target's window where it is another block
  int up_off = -1, down_off = -1;
  int* up_far = nullptr;
  int* down_far = nullptr;
  if (n > 0 && (g < gl || kWrapUp)) {
    int t = g < gl ? g + 1 : 0;
    up_off = (t % wb) * kMaxW + lane;
    if (t / wb != c) up_far = cluster.map_shared_rank(s_halo, t / wb);
  }
  if (kBelow && n > 0 && (g > 0 || kWrapDown)) {
    int t = g > 0 ? g - 1 : gl;
    down_off = (wb + t % wb) * kMaxW + lane;
    if (t / wb != c) down_far = cluster.map_shared_rank(s_halo, t / wb);
  }
  bool has_up = g > 0 || kWrapUp, has_down = g < gl || kWrapDown;
  const int* above = s_halo + warp * kMaxW + lane;
  const int* below = s_halo + (wb + warp) * kMaxW + lane;

  const T* xb = x + (long long)b * sub * W + (long long)y0 * W;
  int v[kBandRows][kPer];
#pragma unroll
  for (int r = 0; r < kBandRows; ++r)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int xx = kPer * lane + j;
      v[r][j] = r < n && xx < W ? (int)xb[(long long)r * W + xx] : 0;
    }
  cluster.sync();          // every block runs before one stores into another
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    int par = (it & 1) * slot;
    if constexpr (kS != kSublaneMaskAdd) {
#pragma unroll
      for (int r = 0; r < kBandRows; ++r)
        if (r < n) lane_part<kS, kW640>(v[r], W, lane);
    }
    // the edge rows to the neighbours
    if (up_off >= 0) {
      if (n == kBandRows) {
        put_row(s_halo, up_off + par, up_far, v[kBandRows - 1]);
      } else {       // the wrap variants' short last band: row n - 1, by
        int e[kPer];       // value (an index into v would put v in memory)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          e[j] = v[0][j];
#pragma unroll
          for (int r = 1; r < kBandRows; ++r) e[j] = r < n ? v[r][j] : e[j];
        }
        put_row(s_halo, up_off + par, up_far, e);
      }
    }
    if (down_off >= 0) put_row(s_halo, down_off + par, down_far, v[0]);
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    if (n == kBandRows) {
      // interior rows now; rows 0 and 3 keep min(v0, v1), min(v2, v3)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if constexpr (kS == kSublaneMaskAdd) {
#pragma unroll
          for (int r = kBandRows - 1; r > 0; --r)
            v[r][j] = min(v[r][j], v[r - 1][j]);
        } else {
          int p[kBandRows - 1];
#pragma unroll
          for (int r = 0; r + 1 < kBandRows; ++r)
            p[r] = min(v[r][j], v[r + 1][j]);
#pragma unroll
          for (int r = 1; r + 1 < kBandRows; ++r)
            v[r][j] = min(p[r - 1], p[r]);
          v[0][j] = p[0];
          v[kBandRows - 1][j] = p[kBandRows - 2];
        }
      }
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if (n == kBandRows) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int a = has_up ? above[par + j * 32] : 63;
        if constexpr (kS == kSublaneMaskAdd) {
          v[0][j] = min(v[0][j], wadd(a, g == 0 ? kGuard : 0));
        } else {
          int z = has_down ? below[par + j * 32] : 63;
          v[0][j] = min(v[0][j], a);
          v[kBandRows - 1][j] = min(v[kBandRows - 1][j], z);
        }
      }
    } else if (n > 0) {
      // the frame's last band, short: each row from its old neighbours
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int prev = has_up ? above[par + j * 32] : 63;
        if constexpr (kS == kSublaneMaskAdd) prev = wadd(prev, g == 0 ? kGuard : 0);
        int z = kBelow && has_down ? below[par + j * 32] : 63;
#pragma unroll
        for (int r = 0; r < kBandRows; ++r) {
          if (r >= n) continue;
          int cur = v[r][j], nb = z;
          if (r + 1 < kBandRows && r + 1 < n) nb = v[r + 1][j];
          v[r][j] = kBelow ? min(cur, min(prev, nb)) : min(cur, prev);
          prev = cur;
        }
      }
    }
  }
  int32_t* ob = out + (long long)b * out_rows * W;
#pragma unroll
  for (int r = 0; r < kBandRows; ++r)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int xx = kPer * lane + j;
      if (r < n && y0 + r < out_rows && xx < W)
        ob[(long long)(y0 + r) * W + xx] = v[r][j];
    }
}

// roll(line, d)[x], plus p where the read wrapped: the TPU code's roll and
// precomputed edge mask (k_cross_rows's lane part).  |d| <= W.
template <typename T>
__device__ __forceinline__ int pen_at(const T* line, int x, int d, int W,
                                      int p) {
  int s = x - d;
  int w = (d > 0 ? s : W - 1 - s) >> 31;       // -1 where the read wraps
  return wadd((int)line[d > 0 ? s + (w & W) : s - (w & W)], w & p);
}

// The value at x - d of a line in shared memory, or fill where x - d
// leaves the line.
template <typename T>
__device__ __forceinline__ int sh_at(const T* line, int x, int d, int W,
                                     int fill) {
  int s = x - d;
  return (d > 0 ? s >= 0 : s < W) ? (int)line[s] : fill;
}

// Cross-row steps on frames of more than 1024 rows: one frame
// (blockIdx.y) per cluster of kCluster blocks; block c holds rows [c * R,
// c * R + n) in s rows 1..n, a halo row above (s row 0) and below (s row
// n + 1).  A step: the lane part in place (a warp per row, reading its own
// row), a cluster barrier, the halos from the neighbours' edge rows
// (distributed shared memory; the wrap variants take block 0's upper halo
// from the last block's last row and the last block's lower one from block
// 0's first row), a cluster barrier, then the row part in place, down each
// column with the previous row's old value in a register.
template <int kS, typename T>
__global__ void __launch_bounds__(kCrossThreads)
    k_cross_rows(const T* x, int sub, int W, int R, int iters, int out_rows,
                 int32_t* out) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s = reinterpret_cast<T*>(s_raw);
  cg::cluster_group cluster = cg::this_cluster();
  constexpr bool kWrapRows = kS == kNbminGuard || kS == kSublaneMaskAdd;
  int c = (int)cluster.block_rank(), b = blockIdx.y;
  int y0 = c * R, n = max(0, min(R, sub - y0));
  int last = (sub - 1) / R, n_last = sub - last * R;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int warps = blockDim.x >> 5;
  T* own = s + W;
  const T* xb = x + (long long)b * sub * W + (long long)y0 * W;
  for (int i = threadIdx.x; i < n * W; i += blockDim.x) own[i] = xb[i];
  // the rows above and below this block's, in their blocks' buffers
  const T* up = nullptr;
  const T* down = nullptr;
  if (n > 0 && (c > 0 || kWrapRows))
    up = cluster.map_shared_rank(s, c > 0 ? c - 1 : last) +
         (c > 0 ? R : n_last) * W;
  if (kS != kSublaneMaskAdd && n > 0 && (c < last || kWrapRows))
    down = cluster.map_shared_rank(s, c < last ? c + 1 : 0) + W;
  __syncthreads();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if constexpr (kS != kSublaneMaskAdd) {
      for (int y = warp; y < n; y += warps) {
        T* line = own + (long long)y * W;
        int r[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          int xx = 32 * j + lane;
          if (xx >= W) continue;
          int a = (int)line[xx], l, rr;
          if (kS == kNbmin8) {
            l = sh_at(line, xx, 1, W, 63);
            rr = sh_at(line, xx, -1, W, 63);
          } else {
            l = pen_at(line, xx, 1, W, kGuard);
            rr = pen_at(line, xx, -1, W, kGuard);
          }
          r[j] = min(a, min(l, rr));
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          int xx = 32 * j + lane;
          if (xx < W) line[xx] = (T)r[j];
        }
        __syncwarp();
      }
    }
    cluster.sync();                  // every block's rows hold the lane part
    if (n > 0) {
      T* below = own + (long long)n * W;
      for (int xx = threadIdx.x; xx < W; xx += blockDim.x) {
        int top = up ? (int)up[xx] : 63;
        if (kS == kSublaneMaskAdd && c == 0) top = wadd(top, kGuard);
        s[xx] = (T)top;
        if (kS != kSublaneMaskAdd) below[xx] = down ? down[xx] : (T)63;
      }
    }
    cluster.sync();                  // the halos are read
    for (int xx = threadIdx.x; xx < W; xx += blockDim.x) {
      int prev = (int)s[xx];
      for (int y = 0; y < n; ++y) {
        T* p = own + (long long)y * W + xx;
        int cur = (int)*p, nv = min(cur, prev);
        if (kS != kSublaneMaskAdd) nv = min(nv, (int)p[W]);
        *p = (T)nv;
        prev = cur;
      }
    }
    __syncthreads();
  }
  __syncthreads();
  int rows = min(n, out_rows - y0);
  int32_t* ob = out + (long long)b * out_rows * W + (long long)y0 * W;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) ob[i] = own[i];
}

// Launches kernel on clusters of C blocks of `threads` threads with smem
// bytes of dynamic shared memory, after checking that such a cluster fits
// the card.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int C, int B, int threads,
                   size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters == 0) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)e;
}

template <int kS, typename T>
int launch(const void* xv, int B, int sub, int W, int iters, int out_rows,
           int32_t* out, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  if constexpr (kS == kTransposePair) {
    int tiles = (sub + 31) / 32 * ((W + 31) / 32);
    k_transpose_pair<T><<<dim3((tiles + kWarps - 1) / kWarps, B),
                          kWarps * 32, 0, st>>>(x, sub, W, iters, out_rows,
                                                out);
  } else if constexpr (kS == kMxuCumsum) {
    size_t smem = (size_t)2 * kCumRows * (kMaxW + 8) * 2;
    cudaError_t e = cudaFuncSetAttribute(
        k_mxu_cumsum, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    k_mxu_cumsum<<<dim3((sub + kCumRows - 1) / kCumRows, B), kWarps * 32,
                   smem, st>>>(x, sub, W, iters, out_rows, out);
  } else if constexpr (kS == kNbmin8 || kS == kNbminGuard ||
                       kS == kNbminMaskedSub || kS == kSublaneMaskAdd) {
    int bands = (sub + kBandRows - 1) / kBandRows, C = 1;
    while (C * kBandWarps < bands) C *= 2;
    int e = 0;
    if (C <= kMaxBandCluster) {
      int wb = (bands + C - 1) / C;
      size_t smem = (size_t)2 * 2 * wb * kMaxW * sizeof(int);
      bool w640 = true;                  // sublane_mask_add: no lane part
      if constexpr (kS != kSublaneMaskAdd) w640 = W == kMaxW;
      if (w640)
        e = launch_cluster(k_cross_bands<kS, T, true>, C, B, wb * 32, smem,
                           st, x, sub, W, iters, out_rows, out);
      else if constexpr (kS != kSublaneMaskAdd)
        e = launch_cluster(k_cross_bands<kS, T, false>, C, B, wb * 32, smem,
                           st, x, sub, W, iters, out_rows, out);
    } else {
      int R = (sub + kCluster - 1) / kCluster;
      e = launch_cluster(k_cross_rows<kS, T>, kCluster, B, kCrossThreads,
                         (size_t)(R + 2) * W * sizeof(T), st, x, sub, W, R,
                         iters, out_rows, out);
    }
    if (e != 0) return e;
  } else {
    int units = kS == kSegMin ? sub / 2 : sub;
    dim3 grid((units + kWarps - 1) / kWarps, B);
    bool w640 = true;
    if constexpr (rolls(kS)) w640 = W == kMaxW;
    if (w640)
      k_rows<kS, T, true><<<grid, kWarps * 32, 0, st>>>(x, sub, W, iters,
                                                        out_rows, out);
    else if constexpr (rolls(kS))
      k_rows<kS, T, false><<<grid, kWarps * 32, 0, st>>>(x, sub, W, iters,
                                                         out_rows, out);
  }
  HD_CHECK();
  return 0;
}

}  // namespace

// The 27 (step, type) pairs of ops/primitives.py's VARIANTS.
#define HD_PAIRS(X)                                                        \
  X(kMinScan, int32_t) X(kMinScan, int16_t) X(kMinScan, int8_t)            \
  X(kMaxScan, int16_t) X(kOrRoll, int32_t) X(kOrRoll, int16_t)             \
  X(kOrRoll, int8_t) X(kNbmin8, int32_t) X(kNbmin8, int16_t)               \
  X(kNbmin8, int8_t) X(kAdd, int32_t) X(kAdd, int16_t)                     \
  X(kSelect, int32_t) X(kSelect, int16_t) X(kTransposePair, int32_t)       \
  X(kTransposePair, int16_t) X(kSegMin, int32_t) X(kSegMin, int16_t)       \
  X(kMxuCumsum, int32_t) X(kCumsumLadder, int32_t) X(kMaskedMin, int32_t)  \
  X(kMaskedLadder5, int32_t) X(kNbminGuard, int32_t)                       \
  X(kNbminMaskedSub, int32_t) X(kOrAndMask, int32_t)                       \
  X(kMaxLadderFull, int32_t) X(kSublaneMaskAdd, int32_t)

// x: B planes [sub, W] of the step's type (dtype 0 int32, 1 int16, 2 int8);
// out: int32 [B, out_rows, W] (out_rows 1 or sub).  Returns 0, or a CUDA
// error (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int hd_primitive_steps(const void* x, int B, int sub, int W,
                                  int step, int dtype, int iters,
                                  int out_rows, int32_t* out,
                                  cudaStream_t st) {
  if (B < 1 || B > 65535 || sub < 1 || W < 1 || W > kMaxW || iters < 0 ||
      (out_rows != 1 && out_rows != sub) || (step == kSegMin && sub % 2) ||
      step < 0 || step > kSublaneMaskAdd || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  switch (step * 3 + dtype) {
#define HD_CASE(S, T)             \
  case S * 3 + dtype_code<T>():   \
    return launch<S, T>(x, B, sub, W, iters, out_rows, out, st);
    HD_PAIRS(HD_CASE)
#undef HD_CASE
  }
  return (int)cudaErrorInvalidValue;
}
