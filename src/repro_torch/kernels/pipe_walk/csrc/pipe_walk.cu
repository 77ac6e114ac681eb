// K9, the pipeline F/B/U walk of the canonical uniform dense family
// (stage tanh(x W_s + b_s), mean-squared-error loss), for sm_90a.  Built by
// repro_torch/_build.py and bound with ctypes by
// repro_torch/kernels/pipe_walk/kernel.py; the launcher returns the error
// of its launch.
//
// It replaces src/repro/engine/megakernel.py::_pipe_kernel, walked by
// _grid_walk (its pallas_call) from pipe_round_fn.  The Pallas walk ran the
// rows of a table one after another on one TPU core, each row a whole
// (Bt, D) x (D, D) product in VMEM.  Here the whole plan is ONE cooperative
// launch over state updated in place: the resident blocks take the
// current write-colored phase's tiles one at a time from a counter, and a
// grid barrier separates the phases (the rows of a phase touch
// pairwise-disjoint state, engine.megakernel.pipe_row_access).  A phase
// holds at most S rows, so each row is cut into tiles; the host hands the
// launch a work list (kernel.py::work_list): per phase, segments of
// consecutive tiles of one row and one kind, the kinds in the order COT,
// F, GW, U, so that the long split-K tiles start first and the short gW
// tiles fill the tail.  A block finds the segment of its tile by a binary
// search over their offsets.
//   F    (32 rows x 256 columns) tiles of h = tanh(in W_s + b_s), in = x[m]
//        on the first stage, else the previous stage's output, each split
//        over the reduction into blocks of KSPLIT (split-K).  Each block
//        writes its partial product to a scratch buffer; the tile's last
//        block to finish (an integer ticket, no float atomics) sums the
//        partials in split order, adds the bias and applies tanh.  On the
//        last stage it also seeds cot = (2 / numel)(h - y), and g = cot
//        (1 - h^2) beside it, and sums (h - y)^2 into a per-tile partial;
//        the row's last tile to finish (a second ticket) sums those in
//        tile order into loss[m].
//   COT  the split tiles of cot_in = g W_s^T (as F's, computed as its
//        transpose W_s g^T so that W_s's rows are a plain copy), on B
//        rows off the first stage; the last split also writes the
//        previous stage's g = cot_in (1 - h_in^2) beside cot_in.  So every
//        slot's g is ready, in a scratch slab, before its B row runs, and
//        a B row's tiles read it as a plain copy (read-only in the phase:
//        no block reads what another block of the phase writes).
//   GW   (64 x 128) tiles of gW_s += in^T g, the first tile row also
//        adding the column sums of g into gb_s.  The tile's old gW and
//        both operands are 16-byte cp.async copies into shared memory, in
//        flight together before the product.
//   U    8192-float tiles of gW_s *= 1/M (16-byte loads and stores), the
//        first tile also gb_s.
// Tickets and loss counters are back at 0 before the grid barrier, so the
// next phase reuses a slot's scratch.  Every element of the state is
// written by one thread of one block, and every sum runs in a fixed
// order, so two runs are bitwise equal.  L1 is not coherent across SMs:
// every read of state that another block may have written (acts, g, gw,
// gb, the partials, tickets and counters) goes past L1 (cp.async.cg,
// __ldcg); only w, b, x and y take __ldg.  Edges (Bt or D not a multiple
// of a tile) are masked; D not a multiple of 4 takes the same kernel with
// scalar loads (VEC = false).
//
// The products run in fp32 on the CUDA cores (TF32 is off in the port, as
// the reference computes them in fp32).  Each thread keeps 4 x 8 outputs
// in registers and reads its operands from shared memory as float4 (a
// warp spans 4 row groups x 8 column groups, so a k step costs a warp
// three 128-byte shared-memory wavefronts against 32 FMAs a lane); the
// reduction is staged through a ring of NSTAGE chunks, filled by 16-byte
// cp.async (plain copies) or, for cot_in's small transposed g, by
// registers loaded a chunk ahead.  What bounds the walk
// at (S, M, Bt, D) = (8, 64, 32, 2048): its 395 GFLOP take 5.9 ms at the
// card's 67 TFLOP/s fp32 rate, but one row at a time (as the reference
// walks) every row re-reads W_s (16.8 MB) and every B row reads and
// writes gW_s: about 35.6 GB, 10.6 ms at 3.35 TB/s (eight stages' W and gW
// do not fit the 50 MB L2).  Measured on an NVIDIA H100 80GB HBM3 at 700
// W: 19.7-20.2 ms a plan in one launch (chip_smoke.py,
// tools/compare_walks.py), where the first form, a launch a phase with
// 2 x 4 register tiles, takes 32.4-32.5 ms in 143 launches on the same
// card; the walk reaches 0.53 of the row-traffic floor.
// tools/pipe_walk_stamps.py: cot_in
// tiles 81 us, F 74 us, gW 6.6 us (means), the blocks busy 83 % of each
// phase's span, 3.3 us a grid barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;   // 8 warps; a thread holds 4 x 8 outputs
constexpr int TK = 16;         // reduction chunk of a ring stage: F, cot_in
constexpr int TK_GW = 32;      //   and gW (Bt = 32 is one chunk)
constexpr int NSTAGE = 3;      // ring depth
constexpr int ACT_TM = 32;     // F and cot_in output tiles: rows (Bt)
constexpr int ACT_TN = 256;    //   and columns (D)
constexpr int KSPLIT = 512;    // reduction length of one F / cot_in block
constexpr int GW_TM = 64;      // gW output tiles: rows
constexpr int GW_TN = 128;     //   and columns
constexpr int U_TILE = 8192;   // floats of gW one U tile scales
constexpr int A_STRIDE = TK + 4;            // A staged [m][k], padded rows
constexpr int A_FLOATS = TK_GW * GW_TM;     // >= ACT_TM * A_STRIDE
constexpr int B_FLOATS = TK * ACT_TN;       // >= TK_GW * GW_TN
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr int OLD_FLOATS = GW_TM * GW_TN;   // a gW tile's old values
constexpr int SMEM_FLOATS = NSTAGE * STAGE_FLOATS + OLD_FLOATS;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;
static_assert(A_FLOATS >= ACT_TM * A_STRIDE, "A stage too small");
static_assert(B_FLOATS >= TK_GW * GW_TN, "B stage too small");

// segment kinds, in the order a phase takes them (kernel.py::SEG_*)
enum { SEG_COT = 0, SEG_F = 1, SEG_GW = 2, SEG_U = 3 };

struct Walk {
  const int* desc;        // (rows, width) int32: [etype, s, m, a_in, a_out,
  int width;              //   first, last, ...]
  const int* segs;        // (segments, 3): [row, kind, slot in its phase]
  const int* seg_offs;    // (segments + 1): the CSR of their tiles
  const int* phase_segs;  // (nphases + 1): each phase's segments
  int* next;              // (nphases): tiles of each phase taken, zeroed
  int nphases;
  const float* w;         // (S, D, D)
  const float* b;         // (S, D)
  const float* x;         // (M, Bt, D)
  const float* y;         // (M, Bt, D)
  float* acts;            // (S M, Bt, D), slot = stage M + micro
  float* cots;            // (S M, Bt, D)
  float* g;               // (S M, Bt, D): g = cot (1 - h^2) of each slot,
                          //   written with its cotangent
  float* gw;              // (S, D, D)
  float* gb;              // (S, D)
  float* loss;            // (M, 1)
  float* partials;        // (M, F tiles a row): the loss's per-tile sums
  int* counters;          // (M): tiles of a last-stage F row done, zeroed
  float* split;           // (rows a phase, splits, F tiles, ACT_TM ACT_TN):
                          //   the split-K partial products
  int* tickets;           // (rows a phase, F tiles): splits done, zeroed
  int bt, dim;
  float inv_m, inv_numel;
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive floats src[0..3] into shared dst[0..3]: only the first
// rem (and none unless ok) are read, the rest are 0.  VEC (D a multiple of
// 4, so a group is all in or all out): one 16-byte cp.async past L1,
// zero-filled when out; else scalar loads past L1.
template <bool VEC>
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       const float* base, bool ok, int rem) {
  if (VEC) {
    const bool in = ok && rem > 0;
    cp_async16(dst, in ? src : base, in);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[u] = (ok && u < rem) ? __ldcg(src + u) : 0.f;
  }
}

// src[0..3] into registers, as stage4 masks them; CG: past L1 (state
// another block may have written), else through it (w, b, x, y)
template <bool VEC, bool CG>
__device__ __forceinline__ float4 load4(const float* src, bool ok, int rem) {
  if (VEC) {
    if (!(ok && rem > 0)) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* p = reinterpret_cast<const float4*>(src);
    return CG ? __ldcg(p) : __ldg(p);
  }
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v[u] = (ok && u < rem) ? (CG ? __ldcg(src + u) : __ldg(src + u)) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 tanh_grad(float4 c, float4 h) {
  return make_float4(c.x * (1.f - h.x * h.x), c.y * (1.f - h.y * h.y),
                     c.z * (1.f - h.z * h.z), c.w * (1.f - h.w * h.w));
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// The thread's place in a tile of WR x WC warps (WR 16-row groups, WC
// 64-column groups): rows row0 + {0, 1, 2, 3} * rstep, columns col0 +
// {0..3} and col0 + 32 + {0..3}.  A staged [k][m] (A_KM) takes the thread's
// rows consecutive (one float4 a k); A staged [m][k] takes them 4 apart,
// so a warp's four row groups read four consecutive padded rows.
template <int WC, bool A_KM>
struct Frag {
  int row0, rstep, col0;
  __device__ __forceinline__ Frag() {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int lr = lane >> 3, lc = lane & 7;
    row0 = (w / WC) * 16 + (A_KM ? lr * 4 : lr);
    rstep = A_KM ? 1 : 4;
    col0 = (w % WC) * 64 + lc * 4;
  }
  __device__ __forceinline__ int row(int i) const { return row0 + i * rstep; }
  __device__ __forceinline__ int col(int jh) const { return col0 + jh * 32; }
};

// acc += the stage's A (KC x BM) times B (KC x BN), k in order.
template <int WC, bool A_KM, int KC>
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs,
                                          const Frag<WC, A_KM>& f,
                                          float (&acc)[4][8]) {
  constexpr int BN = WC * 64, BM = (THREADS / 32 / WC) * 16;
  if (A_KM) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + k * BM + f.row0);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * BN + f.col0);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + k * BN + f.col0 + 32);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + f.row(i) * A_STRIDE + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(Bs + (kk + u) * BN + f.col0);
        const float4 b1 =
            *reinterpret_cast<const float4*>(Bs + (kk + u) * BN + f.col0 + 32);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = comp(a[i], u);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
}

// The three products' inner loops, each on one ring stage (A then B in
// the stage's floats).  F: (32 x 256) += A [m][k] x B [k][n]; GW: (64 x
// 128) += A [k][m] x B [k][n]; COT: see MmaCot.
struct MmaF {
  __device__ __forceinline__ static void run(const float* st,
                                             float (&acc)[4][8]) {
    mma_stage<4, false, TK>(st, st + A_FLOATS, Frag<4, false>(), acc);
  }
};
struct MmaGw {
  __device__ __forceinline__ static void run(const float* st,
                                             float (&acc)[4][8]) {
    mma_stage<2, true, TK_GW>(st, st + A_FLOATS, Frag<2, true>(), acc);
  }
};

// cot_in^T = W_s g^T, a (256 x 32) tile (columns c of cot_in by rows r),
// so that W_s, whose rows are the reduction's, is a plain [c][k] copy: A
// = W[c0 .., k] [c][k] (padded rows of A_STRIDE) and B = g^T [k][r], the
// stage's floats from COT_A_FLOATS on.  A thread holds 8 columns c (4
// apart, so a warp's four row lanes read four consecutive padded rows) by
// 4 rows r: acc[u][i] is row r0 + rlane * 4 + u, column crow(i).
constexpr int COT_TC = ACT_TN;                     // columns c a tile
constexpr int COT_A_FLOATS = COT_TC * A_STRIDE;
static_assert(COT_A_FLOATS + TK * ACT_TM <= A_FLOATS + B_FLOATS,
              "cot_in stage too small");
__device__ __forceinline__ int cot_col(int i) {
  return (threadIdx.x >> 5) * 32 + ((threadIdx.x & 31) >> 3) + 4 * i;
}
__device__ __forceinline__ int cot_row(int u) {
  return (threadIdx.x & 7) * 4 + u;
}
struct MmaCot {
  __device__ __forceinline__ static void run(const float* st,
                                             float (&acc)[4][8]) {
    const float* As = st;
    const float* Bs = st + COT_A_FLOATS + (threadIdx.x & 7) * 4;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + cot_col(i) * A_STRIDE + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(Bs + (kk + q) * ACT_TM);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float bv = comp(b, u);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[u][i] = fmaf(comp(a[i], q), bv, acc[u][i]);
        }
      }
    }
  }
};

// acc = the product over nchunks chunks of KC, staged through the ring of
// NSTAGE stages: ld.issue(c, stage) starts chunk c's loads into a stage
// (cp.async, or into the loader's registers), ld.land(stage) stores what
// it holds in registers; MMA::run multiplies a stage.  Leaves every copy
// landed and the ring free.
template <int KC, class MMA, class L>
__device__ __forceinline__ void ring_product(L& ld, int nchunks, float* smem,
                                             float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto S = [&](int s) { return smem + s * STAGE_FLOATS; };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nchunks) {
      ld.issue(s, S(s));
      ld.land(S(s));
    }
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    const int nc = c + NSTAGE - 1, ns = nc % NSTAGE;
    if (nc < nchunks) ld.issue(nc, S(ns));
    MMA::run(S(c % NSTAGE), acc);
    if (nc < nchunks) ld.land(S(ns));
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
}

// F's operands: A = in[r0 .., k] staged [m][k], B = W[k, c0 ..], both
// plain copies.
template <bool VEC>
struct FLoad {
  const float* in;
  const float* W;
  int bt, dim, r0, c0, klo, khi;
  __device__ __forceinline__ void issue(int c, float* A) {
    float* B = A + A_FLOATS;
    const int k0 = klo + c * TK, tid = threadIdx.x;
    if (tid < ACT_TM * TK / 4) {
      const int m = tid / (TK / 4), kq = (tid % (TK / 4)) * 4;
      const int r = r0 + m, k = k0 + kq;
      stage4<VEC>(A + m * A_STRIDE + kq, in + (int64_t)r * dim + k, in,
                  r < bt, khi - k);
    }
#pragma unroll
    for (int u = 0; u < TK * ACT_TN / 4 / THREADS; ++u) {
      const int e = threadIdx.x + u * THREADS;
      const int kr = e / (ACT_TN / 4), cq = (e % (ACT_TN / 4)) * 4;
      const int k = k0 + kr, col = c0 + cq;
      stage4<VEC>(B + kr * ACT_TN + cq, W + (int64_t)k * dim + col, W,
                  k < khi, dim - col);
    }
  }
  __device__ __forceinline__ void land(float*) {}
};

// cot_in's operands (MmaCot): A = W[c0 + n, k] for the tile's 256
// columns n, a plain copy (four threads a row's 16 floats), and B = g^T
// [k][r] from the row's g slab, through registers a chunk ahead.
template <bool VEC>
struct CotLoad {
  const float* g;
  const float* W;
  int bt, dim, r0, c0, klo, khi;
  float4 gv;
  __device__ __forceinline__ void issue(int c, float* A) {
    const int k0 = klo + c * TK, tid = threadIdx.x;
#pragma unroll
    for (int u = 0; u < COT_TC * TK / 4 / THREADS; ++u) {
      const int e = tid + u * THREADS;
      const int n = e / (TK / 4), kq = (e % (TK / 4)) * 4;
      const int col = c0 + n, k = k0 + kq;
      stage4<VEC>(A + n * A_STRIDE + kq, W + (int64_t)col * dim + k, W,
                  col < dim, khi - k);
    }
    if (tid < ACT_TM * TK / 4) {
      const int r = r0 + tid / (TK / 4), k = k0 + (tid % (TK / 4)) * 4;
      gv = load4<VEC, true>(g + (int64_t)r * dim + k, r < bt, khi - k);
    }
  }
  __device__ __forceinline__ void land(float* A) {
    const int tid = threadIdx.x;
    if (tid < ACT_TM * TK / 4) {
      float* B = A + COT_A_FLOATS + (tid % (TK / 4)) * 4 * ACT_TM +
                 tid / (TK / 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) B[u * ACT_TM] = comp(gv, u);
    }
  }
};

// gW's operands, a chunk of TK_GW rows of the reduction, both plain
// copies: A[k][m] = in[k, i0 + m] (in's rows are the reduction) and
// B[k][n] = g[k, j0 + n].
template <bool VEC>
struct GwLoad {
  const float* in;
  const float* g;
  int bt, dim, i0, j0;
  __device__ __forceinline__ void issue(int c, float* A) {
    float* B = A + A_FLOATS;
    const int k0 = c * TK_GW;
#pragma unroll
    for (int u = 0; u < TK_GW * GW_TM / 4 / THREADS; ++u) {
      const int e = threadIdx.x + u * THREADS;
      const int kr = e / (GW_TM / 4), mq = (e % (GW_TM / 4)) * 4;
      const int k = k0 + kr, i = i0 + mq;
      stage4<VEC>(A + kr * GW_TM + mq, in + (int64_t)k * dim + i, in, k < bt,
                  dim - i);
    }
#pragma unroll
    for (int u = 0; u < TK_GW * GW_TN / 4 / THREADS; ++u) {
      const int e = threadIdx.x + u * THREADS;
      const int kr = e / (GW_TN / 4), nq = (e % (GW_TN / 4)) * 4;
      const int k = k0 + kr, j = j0 + nq;
      stage4<VEC>(B + kr * GW_TN + nq, g + (int64_t)k * dim + j, g, k < bt,
                  dim - j);
    }
  }
  __device__ __forceinline__ void land(float*) {}
};

// The loss of a last-stage F row: the block's sum of (h - y)^2 goes to
// partials[m, t]; the row's last tile to finish adds the partials in tile
// order.  The ticket is an integer atomic; the sums are fixed-order.
__device__ void loss_tile(const Walk& P, int m, int t, int ntiles,
                          float part) {
  __shared__ float red[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float sum = 0.f;
  for (int i = 0; i < THREADS / 32; ++i) sum += red[i];
  P.partials[(int64_t)m * ntiles + t] = sum;
  __threadfence();
  if (atomicAdd(P.counters + m, 1) != ntiles - 1) return;
  __threadfence();
  float tot = 0.f;
  for (int i = 0; i < ntiles; ++i)
    tot += __ldcg(P.partials + (int64_t)m * ntiles + i);
  P.loss[m] = tot * P.inv_numel;
  P.counters[m] = 0;
}

// One block's split sp of output tile o (ACT_TM x ACT_TN) of an F or
// cot_in product: written to the row's split-K scratch; the tile's last
// split to finish (an integer ticket) sums the partials in split order
// into acc and returns true, the others return false.  With one split the
// product is the tile's at once.  slot is the row's place in its phase.
template <class MMA, class L>
__device__ bool split_product(const Walk& P, int slot, int o, int sp, L& ld,
                              int nchunks, float* smem, float (&acc)[4][8]) {
  __shared__ int is_last;
  constexpr int TILE = ACT_TM * ACT_TN;
  ring_product<TK, MMA>(ld, nchunks, smem, acc);
  const int nks = cdiv(P.dim, KSPLIT);
  if (nks == 1) return true;
  const int ntf = cdiv(P.bt, ACT_TM) * cdiv(P.dim, ACT_TN);
  float* part = P.split + ((int64_t)slot * nks * ntf + o) * TILE;
  const int64_t stride = (int64_t)ntf * TILE;   // from one split to the next
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = q >> 1, j = (q & 1) * 4;
    *reinterpret_cast<float4*>(part + sp * stride + (q * THREADS + tid) * 4) =
        make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  }
  __threadfence();
  __syncthreads();
  int* ticket = P.tickets + (int64_t)slot * ntf + o;
  if (tid == 0) is_last = atomicAdd(ticket, 1) == nks - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  // split by split, the thread's eight float4s of each in flight at once
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < nks; ++k) {
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = __ldcg(reinterpret_cast<const float4*>(
          part + k * stride + (q * THREADS + tid) * 4));
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = q >> 1, j = (q & 1) * 4;
      acc[i][j] += v[q].x;
      acc[i][j + 1] += v[q].y;
      acc[i][j + 2] += v[q].z;
      acc[i][j + 3] += v[q].w;
    }
  }
  if (tid == 0) *ticket = 0;
  return true;
}

// F tile t of row [s, m, a_in, a_out, first, last]: split sp of output
// tile o; the tile's last split applies the bias and tanh, and on the last
// stage seeds the cotangent and the loss.
template <bool VEC>
__device__ void f_tile(const Walk& P, const int* row, int slot, int t,
                       float* smem) {
  const int s = row[1], m = row[2], a_in = row[3], a_out = row[4];
  const bool first = row[5] > 0, last = row[6] > 0;
  const int bt = P.bt, dim = P.dim, ntn = cdiv(dim, ACT_TN);
  const int nks = cdiv(dim, KSPLIT), o = t / nks, sp = t % nks;
  const int64_t slab = (int64_t)bt * dim;
  const int r0 = (o / ntn) * ACT_TM, c0 = (o % ntn) * ACT_TN;
  const int klo = sp * KSPLIT, khi = min(dim, klo + KSPLIT);
  FLoad<VEC> ld{first ? P.x + m * slab : P.acts + a_in * slab,
                P.w + (int64_t)s * dim * dim, bt, dim, r0, c0, klo, khi};
  float acc[4][8];
  if (!split_product<MmaF>(P, slot, o, sp, ld, cdiv(khi - klo, TK), smem,
                           acc))
    return;
  const Frag<4, false> f;
  const float* bias = P.b + (int64_t)s * dim;
  float* h_out = P.acts + a_out * slab;
  float* cot_out = P.cots + a_out * slab;
  float* g_out = P.g + a_out * slab;
  const float* ym = P.y + m * slab;
  const float seed = 2.f * P.inv_numel;
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + f.row(i);
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int c = c0 + f.col(jh);
      if (r >= bt || c >= dim) continue;
      const int64_t e = (int64_t)r * dim + c;
      if (VEC) {
        const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c));
        const float4 hv = make_float4(
            tanhf(acc[i][4 * jh] + bv.x), tanhf(acc[i][4 * jh + 1] + bv.y),
            tanhf(acc[i][4 * jh + 2] + bv.z), tanhf(acc[i][4 * jh + 3] + bv.w));
        *reinterpret_cast<float4*>(h_out + e) = hv;
        if (last) {
          const float4 yv = __ldg(reinterpret_cast<const float4*>(ym + e));
          const float4 d = make_float4(hv.x - yv.x, hv.y - yv.y, hv.z - yv.z,
                                       hv.w - yv.w);
          const float4 cv =
              make_float4(seed * d.x, seed * d.y, seed * d.z, seed * d.w);
          *reinterpret_cast<float4*>(cot_out + e) = cv;
          *reinterpret_cast<float4*>(g_out + e) = tanh_grad(cv, hv);
          part += d.x * d.x;
          part += d.y * d.y;
          part += d.z * d.z;
          part += d.w * d.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (c + u >= dim) break;
          const float hv = tanhf(acc[i][4 * jh + u] + bias[c + u]);
          h_out[e + u] = hv;
          if (last) {
            const float d = hv - ym[e + u];
            const float cv = seed * d;
            cot_out[e + u] = cv;
            g_out[e + u] = cv * (1.f - hv * hv);
            part += d * d;
          }
        }
      }
    }
  }
  if (last) loss_tile(P, m, o, cdiv(bt, ACT_TM) * ntn, part);
}

// COT tile t of a B row off the first stage: split sp of output tile o of
// cot_in = g W_s^T; the tile's last split writes it.
template <bool VEC>
__device__ void cot_tile(const Walk& P, const int* row, int slot, int t,
                         float* smem) {
  const int s = row[1], a_in = row[3], a_out = row[4];
  const int bt = P.bt, dim = P.dim, ntn = cdiv(dim, ACT_TN);
  const int nks = cdiv(dim, KSPLIT), o = t / nks, sp = t % nks;
  const int64_t slab = (int64_t)bt * dim;
  const int r0 = (o / ntn) * ACT_TM, c0 = (o % ntn) * ACT_TN;
  const int klo = sp * KSPLIT, khi = min(dim, klo + KSPLIT);
  CotLoad<VEC> ld{P.g + a_out * slab, P.w + (int64_t)s * dim * dim, bt, dim,
                  r0, c0, klo, khi};
  float acc[4][8];
  if (!split_product<MmaCot>(P, slot, o, sp, ld, cdiv(khi - klo, TK), smem,
                             acc))
    return;
  // cot_in and, with the previous stage's output h, its g
  float* out = P.cots + a_in * slab;
  float* g_out = P.g + a_in * slab;
  const float* h = P.acts + a_in * slab;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + cot_row(u);
    if (r >= bt) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + cot_col(i);
      if (c >= dim) continue;
      const int64_t e = (int64_t)r * dim + c;
      const float hv = __ldcg(h + e);
      out[e] = acc[u][i];
      g_out[e] = acc[u][i] * (1.f - hv * hv);
    }
  }
}

// GW tile t of the (D, D) grid: gW_s += in^T g; the first tile row also
// adds the column sums of g (rows in order) into gb_s.
template <bool VEC>
__device__ void gw_tile(const Walk& P, const int* row, int t, float* smem) {
  const int s = row[1], m = row[2], a_in = row[3], a_out = row[4];
  const bool first = row[5] > 0;
  const int bt = P.bt, dim = P.dim, ntn = cdiv(dim, GW_TN);
  const int64_t slab = (int64_t)bt * dim;
  const int ti = t / ntn, i0 = ti * GW_TM, j0 = (t % ntn) * GW_TN;
  const float* g = P.g + a_out * slab;
  float* gws = P.gw + (int64_t)s * dim * dim;
  float* old = smem + NSTAGE * STAGE_FLOATS;
  const int tid = threadIdx.x;
  // the tile's old values first: their copies are in flight while the
  // operands stage
#pragma unroll
  for (int u = 0; u < OLD_FLOATS / 4 / THREADS; ++u) {
    const int e = tid + u * THREADS;
    const int r = e / (GW_TN / 4), q = (e % (GW_TN / 4)) * 4;
    stage4<VEC>(old + r * GW_TN + q, gws + (int64_t)(i0 + r) * dim + j0 + q,
                gws, i0 + r < dim, dim - (j0 + q));
  }
  cp_async_commit();
  GwLoad<VEC> ld{first ? P.x + m * slab : P.acts + a_in * slab, g, bt, dim,
                 i0, j0};
  float acc[4][8];
  ring_product<TK_GW, MmaGw>(ld, cdiv(bt, TK_GW), smem, acc);
  const Frag<2, true> f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = f.row(i);
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int c = f.col(jh);
      if (i0 + r >= dim || j0 + c >= dim) continue;
      const float4 ov = *reinterpret_cast<const float4*>(old + r * GW_TN + c);
      float* p = gws + (int64_t)(i0 + r) * dim + j0 + c;
      const float4 nv = make_float4(ov.x + acc[i][4 * jh], ov.y + acc[i][4 * jh + 1],
                                    ov.z + acc[i][4 * jh + 2],
                                    ov.w + acc[i][4 * jh + 3]);
      if (VEC) {
        *reinterpret_cast<float4*>(p) = nv;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (j0 + c + u < dim) p[u] = comp(nv, u);
      }
    }
  }
  if (ti != 0) return;
  // gb_s += the column sums of g: two threads a column, each over every
  // other row, their sums added in a fixed order (the ring is free)
  const int j = j0 + tid % GW_TN, q = tid / GW_TN;
  float sum = 0.f;
  if (j < dim) {
    for (int k = q; k < bt; k += 2) sum += __ldcg(g + (int64_t)k * dim + j);
  }
  smem[tid] = sum;
  __syncthreads();
  if (q == 0 && j < dim) {
    float* g = P.gb + (int64_t)s * dim + j;
    *g = __ldcg(g) + (sum + smem[tid + GW_TN]);
  }
}

// U tile t: gW_s *= 1/M over U_TILE consecutive floats; tile 0 also gb_s.
template <bool VEC>
__device__ void u_tile(const Walk& P, const int* row, int t) {
  const int s = row[1], dim = P.dim;
  const int64_t n = (int64_t)dim * dim, base = (int64_t)t * U_TILE;
  float* gws = P.gw + (int64_t)s * n;
  const float inv_m = P.inv_m;
  if (VEC) {
#pragma unroll
    for (int u = 0; u < U_TILE / 4 / THREADS; ++u) {
      const int64_t e = base + 4 * (threadIdx.x + u * THREADS);
      if (e >= n) break;
      float4* p = reinterpret_cast<float4*>(gws + e);
      const float4 v = __ldcg(p);
      *p = make_float4(v.x * inv_m, v.y * inv_m, v.z * inv_m, v.w * inv_m);
    }
  } else {
    const int64_t end = n < base + U_TILE ? n : base + U_TILE;
    for (int64_t e = base + threadIdx.x; e < end; e += THREADS)
      gws[e] = __ldcg(gws + e) * inv_m;
  }
  if (t != 0) return;
  for (int j = threadIdx.x; j < dim; j += THREADS) {
    float* g = P.gb + (int64_t)s * dim + j;
    *g = __ldcg(g) * inv_m;
  }
}

// The whole plan: phase p is segments phase_segs[p] .. phase_segs[p + 1]
// - 1, whose tiles are seg_offs[...].  A block takes the phase's tiles
// one at a time from the phase's counter next[p] (an integer atomic), so
// a block that drew short tiles takes more of them: which block runs a
// tile changes from run to run, what the tile computes does not.  A grid
// barrier ends every phase but the last.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2) pipe_walk_kernel(Walk P) {
  extern __shared__ float4 smem4[];
  __shared__ int tile;
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  for (int p = 0; p < P.nphases; ++p) {
    const int s0 = __ldg(P.phase_segs + p), s1 = __ldg(P.phase_segs + p + 1);
    const int t0 = __ldg(P.seg_offs + s0), t1 = __ldg(P.seg_offs + s1);
    for (;;) {
      __syncthreads();          // the last tile is done with smem and tile
      if (threadIdx.x == 0) tile = t0 + atomicAdd(P.next + p, 1);
      __syncthreads();
      const int t = tile;
      if (t >= t1) break;
      int lo = s0, hi = s1;     // the segment with seg_offs[lo] <= t
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(P.seg_offs + mid) <= t) lo = mid; else hi = mid;
      }
      const int* sg = P.segs + 3 * lo;
      const int* row = P.desc + (int64_t)__ldg(sg) * P.width;
      const int kind = __ldg(sg + 1), slot = __ldg(sg + 2);
      const int lt = t - __ldg(P.seg_offs + lo);
      switch (kind) {
        case SEG_F:
          f_tile<VEC>(P, row, slot, lt, smem);
          break;
        case SEG_COT:
          cot_tile<VEC>(P, row, slot, lt, smem);
          break;
        case SEG_GW:
          gw_tile<VEC>(P, row, lt, smem);
          break;
        case SEG_U:
          u_tile<VEC>(P, row, lt);
          break;
        default:
          break;
      }
    }
    if (p + 1 < P.nphases) grid.sync();
  }
}

template <bool VEC>
cudaError_t resident(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      pipe_walk_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pipe_walk_kernel<VEC>, THREADS, SMEM_BYTES);
  *blocks = per_sm * sms;
  return err;
}

}  // namespace

extern "C" {

// The tile shape the host's work list must be computed with:
// {ACT_TM, ACT_TN, KSPLIT, GW_TM, GW_TN, U_TILE}.
void pipe_tile_shape(int* out) {
  out[0] = ACT_TM;
  out[1] = ACT_TN;
  out[2] = KSPLIT;
  out[3] = GW_TM;
  out[4] = GW_TN;
  out[5] = U_TILE;
}

// Blocks of the walk resident on the current card at width dim: the
// largest grid its cooperative launch takes.
int pipe_walk_grid(int dim, int* blocks) {
  return (int)(dim % 4 == 0 ? resident<true>(blocks)
                            : resident<false>(blocks));
}

// The whole plan in one cooperative launch of min(resident blocks,
// max_tiles) blocks: nphases non-empty phases of the work list (segs,
// seg_offs, phase_segs on the card; max_tiles the most tiles a phase
// holds; next nphases zeroed ints).  All pointers are contiguous device buffers of the shapes in
// Walk (split and tickets hold the longest phase's rows; g is scratch of
// the slabs' shape); the state is updated in place.  A refused launch is returned, never retried.
int pipe_walk(const int* desc, int width, const int* segs,
              const int* seg_offs, const int* phase_segs, int* next,
              int nphases, int max_tiles, const float* w, const float* b,
              const float* x, const float* y, float* acts, float* cots,
              float* gw, float* gb, float* loss, float* g, float* partials,
              int* counters, float* split, int* tickets, int bt, int dim,
              float inv_m, float inv_numel, void* stream) {
  if (nphases < 1 || max_tiles < 1) return 0;
  int blocks = 0;
  const int err = pipe_walk_grid(dim, &blocks);
  if (err != 0) return err;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (max_tiles < blocks) blocks = max_tiles;
  Walk P{desc, width, segs,  seg_offs, phase_segs, next,     nphases,
         w,    b,     x,     y,        acts,       cots,     g,
         gw,   gb,    loss,  partials, counters,   split,    tickets,
         bt,   dim,   inv_m, inv_numel};
  void* args[] = {(void*)&P};
  const void* fn = dim % 4 == 0 ? (const void*)pipe_walk_kernel<true>
                                : (const void*)pipe_walk_kernel<false>;
  const cudaError_t launch = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(THREADS), args, SMEM_BYTES, (cudaStream_t)stream);
  if (launch != cudaSuccess) return (int)launch;
  return (int)cudaGetLastError();
}

}  // extern "C"
