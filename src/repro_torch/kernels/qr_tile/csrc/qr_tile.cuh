// Tile kernels of the tiled QR (paper §4.1) as device functions, one (b,b)
// float32 tile per thread block of QR_THREADS threads.  Tiles of b <= 64
// (QR_MAX_B) run the shared-memory bodies below; wider tiles run the
// blocked bodies at the end of this file (qr_*_wide).
//
// Replaces the bodies of the TPU kernels in src/repro/kernels/qr_tile/
// kernel.py: geqrf_math, tsqrf_math, apply_qt_math and apply_tsqt_math.
// The per-op kernels and the task-table walk (qr_tile.cu) call these same
// functions, which are __noinline__ so that every entry point runs one
// compiled copy of the arithmetic: with the same blockDim the four
// execution modes are bitwise equal on the card, as they are in the
// reference.  Every reduction has a fixed order (per-thread partial sums,
// then a butterfly over a fixed group of lanes), so a result never depends
// on scheduling, on gridDim or on which block runs a tile.
//
// What bounds them on an H100: latency, not bytes or flops.  A tile op
// moves 16-24 KB and does 0.3-1.2 MFLOP, microseconds of work for one SM,
// but the panels are b dependent column steps and the walk waits on the
// slowest op of each phase.  The design shortens every chain:
//   * panels (geqrf, tsqrf): the tile lives in registers, thread
//     (m = tid / 4, q = tid % 4) holding rows q, q + 4, ... of column m.
//     A column step is one block barrier: the pivot column's four threads
//     form the Householder vector (norm by a two-shuffle butterfly) and
//     publish it to shared memory; after the barrier every column's four
//     threads take v.a by the same butterfly and update their column in
//     registers.  Every shuffle runs with its warp converged, and the
//     pivot's row tests are resolved at compile time (a switch on the
//     warp-uniform j / 4).  Columns already done take the same dot, which
//     is the Gram column V^T v_j; T is built after the loop from that Gram
//     matrix, in 16-column blocks (T12 = -T1 G12 T2), not as a serial
//     chain inside it;
//   * applies (apply_qt, apply_tsqt): three b x b products, each thread a
//     4 x 4 block of outputs in 16 independent accumulators, both
//     operands read as float4 along rows of shared memory (V and V2 are
//     also kept transposed, so every product is A^T B), no division or
//     modulo in any inner loop.
//
// Layout: tiles live in shared memory row-major, qr_rows(b) rows with
// leading dimension qr_ld(b) (a multiple of 8, 8 mod 32), so float4 rows
// are aligned and the panels' column loads (rows q + 4r) fall in 32
// distinct banks.  Columns and rows past b hold anything: they feed only
// outputs past b, which are never stored.
//
// Conventions (LAPACK compact WY, as repro/kernels/qr_tile/ref.py):
//   geqrf: A -> R on and above the diagonal, V strictly below (unit
//          diagonal implicit), tau (b), T upper triangular, Q = I - V T V^T.
//   tsqrf: [R; A] with R upper triangular -> R' (upper triangle only: the
//          strict lower part of R is neither read nor written, which lets
//          the walk keep GEQRF's V there), V2 in place of A, tau, T.
//   apply_qt:   C <- C - V (T^T (V^T C)).
//   apply_tsqt: W = T^T (C1 + V2^T C2); C1 <- C1 - W; C2 <- C2 - V2 W.
#pragma once

#include <cuda_runtime.h>

#define QR_THREADS 256   // one blockDim for every entry point
#define QR_WARPS (QR_THREADS / 32)
#define QR_MAX_B 64      // widest tile of the shared-memory bodies: a panel
                         // holds 4 threads x 16 rows of a column
#define QR_TILES 6       // shared-memory tile slots of every kernel
#define QR_TB 16         // column block of the T build

// the wide bodies (b > QR_MAX_B): their 64-row slots' leading dimension
// and size, the rows of a panel column a thread holds in registers and the
// widest tile (a one-column panel: a column's rows over the whole block,
// QR_THREADS x QR_WR; 256 MB a tile)
#define QR_WL 72
#define QR_WS (QR_MAX_B * QR_WL)
#define QR_WR 32
#define QR_WIDE_MAX_B (QR_THREADS * QR_WR)
// widest tiles whose products sum as one float chain: T's merge
// (qr_w_merge, QR_CHAIN_MAX_B) and W = V^T M (qr_w_chunk,
// QR_W_CHAIN_MAX_B); past them the sums are blocked (qr_mm_nn4): float
// blocks of 16 rows into a call's float partials, summed in float (to
// QR_FLOAT_SUM_MAX_B), but W's call partials in double to QR_CHAIN_MAX_B
// and everything in double past QR_FLOAT_SUM_MAX_B.  The forms measured
// outside a criterion (PERF.md §6): at b = 256 W's float chain left K1
// past the card tests' limit from float64 on 2 of 40 random tiles
// (further than plain float32); float partials there, and double ones
// summed in double, left one element 1.027 and 1.41 times that limit
// from the plain version on the card test's tiles; past 2048
// (panels of 2 and 1, two and four times 2048's trailing updates) float
// sums left K1 up to 1.7 times as far from float64 as plain float32.
// Double partials cost 13-17 % at b = 512, where float ones meet both.
#define QR_CHAIN_MAX_B 256
#define QR_W_CHAIN_MAX_B 128
#define QR_FLOAT_SUM_MAX_B 2048
// tiles wider than this (panels of 4, 2 or 1 columns) factor in 64-column
// outer panels and apply Q in blocks of 64 reflectors, one 64-column chunk
// of C a work item (qr_o_* below)
#define QR_OUTER_MIN_B 1024

__host__ __device__ inline int qr_ld(int b) { return (b + 23) / 32 * 32 + 8; }
__host__ __device__ inline int qr_rows(int b) { return (b + 3) & ~3; }
// work items of an apply (apply_qt, apply_tsqt) at tile size b: past
// QR_OUTER_MIN_B one a 64-column chunk of C, each on a block of its own
__host__ __device__ inline int qr_apply_chunks(int b) {
  return b > QR_OUTER_MIN_B ? (b + 63) / 64 : 1;
}
__host__ __device__ inline int qr_slot_floats(int b) {
  return qr_rows(b) * qr_ld(b);
}

// A wide body's panel of nbw columns gives each column g = 256 / nbw
// threads (QR_WR rows each) and keeps it column-major at a column length
// of qr_wide_pld: b rounded up to 32, plus g mod 32, so that the g threads
// of each of a warp's columns read 32 distinct banks.
__host__ __device__ inline int qr_wide_group(int nbw) {
  return QR_THREADS / nbw;
}
__host__ __device__ inline int qr_wide_pld(int b, int nbw) {
  return ((b + 31) & ~31) + (qr_wide_group(nbw) & 31);
}
// panel width at tile size b: the widest power of two up to 64 whose
// columns' rows fit their g threads' QR_WR registers (b <= QR_WR g): 64 to
// b = 128, 32 to 256, 16 to 512, 8 to 1024 (g = 32: a column a warp), then
// 4, 2 and 1 to 2048, 4096 and QR_WIDE_MAX_B (g = 64, 128, 256: a column
// spread over 2, 4 and 8 warps)
__host__ __device__ inline int qr_wide_nb(int b) {
  int nb = QR_MAX_B;
  while (nb > 1 && b > QR_WR * qr_wide_group(nb)) nb >>= 1;
  return nb;
}
// floats of the slot that holds the panel's Householder vectors while it is
// factored (then qr_build_t's Y and the staged rows): up to g = 32 two
// buffers, 4 QR_WR g <= QR_WS floats; past 32 one buffer of a column's b
// doubles, 2 QR_WR g floats (qr_w_factor_span)
__host__ __device__ inline int qr_wide_sfloats(int g) {
  return g > 32 && 2 * QR_WR * g > QR_WS ? 2 * QR_WR * g : QR_WS;
}
// floats of the cross-warp partial sums of a column spread over several
// warps: QR_WARPS doubles of dots, QR_WARPS of squared norms, geqrf's
// alpha
#define QR_WRED (4 * QR_WARPS + 4)
// floats of dynamic shared memory of a wide body: the panel, three 64-row
// slots (T of the panel; Gram / W / X; tsqrf's block of R), the vector
// slot (qr_wide_sfloats), the panel's taus and the partial sums: 105 KB
// up to b = 1024, 150 KB at most (b > 4096)
__host__ __device__ inline int qr_wide_floats(int b) {
  const int nb = qr_wide_nb(b), pld = qr_wide_pld(b, nb);
  return nb * pld + 3 * QR_WS + qr_wide_sfloats(qr_wide_group(nb)) +
         QR_MAX_B + QR_WRED;
}

// floats of dynamic shared memory every entry point takes for tile size b:
// QR_TILES tile slots, two Householder-vector buffers and the taus; above
// QR_MAX_B the wide bodies' layout
__host__ __device__ inline int qr_smem_floats(int b) {
  return b > QR_MAX_B ? qr_wide_floats(b)
                      : QR_TILES * qr_slot_floats(b) + 3 * QR_MAX_B;
}

struct QrHouse {
  float beta, tau, inv;
};

// Householder scalars for pivot alpha and below-pivot squared norm sigma2,
// with the reference's guards: sigma2 == 0 gives tau = 0 and inv = 0, and
// a zero denominator is replaced by 1 (kernel.py::_householder).
__device__ __forceinline__ QrHouse qr_householder(float alpha, float sigma2) {
  QrHouse h;
  if (sigma2 == 0.0f) {
    h.beta = alpha;
    h.tau = 0.0f;
    h.inv = 0.0f;
    return h;
  }
  const float sign = alpha >= 0.0f ? 1.0f : -1.0f;
  h.beta = -sign * sqrtf(alpha * alpha + sigma2);
  const float denom = alpha - h.beta;
  h.tau = (h.beta - alpha) / h.beta;
  h.inv = 1.0f / (denom == 0.0f ? 1.0f : denom);
  return h;
}

// sum of x over the four lanes of a column group; every lane gets the
// same bits (float addition commutes)
__device__ __forceinline__ float qr_quad_sum(float x, unsigned mask) {
  x += __shfl_xor_sync(mask, x, 1);
  x += __shfl_xor_sync(mask, x, 2);
  return x;
}

// geqrf's pivot column j, in the lane of column group q: rows q + 4r with
// r < K = j / 4 lie above row j, rows with r > K below it, and row q + 4K
// is above, at or below j as q is <, = or > j % 4.  K is the same for the
// whole warp, so qr_pivot_geqrf switches on it (one jump, no divergence)
// into code whose row tests are all resolved at compile time: a chain of
// run-time compare / predicated-op pairs on one predicate register
// serialises the pivot step.
// sigma2: this lane's sum of squares below row j; alpha: row q + 4K.
template <int K>
__device__ __forceinline__ void qr_tail_geqrf(const float (&a)[16], int q,
                                              int jq, float& sigma2,
                                              float& alpha) {
  float s0 = q > jq ? a[K] * a[K] : 0.0f, s1 = 0.0f;
#pragma unroll
  for (int r = K + 1; r < 16; r += 2) {
    s1 = fmaf(a[r], a[r], s1);
    if (r + 1 < 16) s0 = fmaf(a[r + 1], a[r + 1], s0);
  }
  sigma2 = s0 + s1;
  alpha = a[K];
}

// the pivot column's update: rows above j keep R (v = 0), row j takes
// beta (v = 1), rows below take v = a * inv; v goes to vbuf
template <int K>
__device__ __forceinline__ void qr_pivot_geqrf(float (&a)[16], int q, int jq,
                                               const QrHouse& h, float* vj) {
#pragma unroll
  for (int r = 0; r < 16; r += 4) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int rr = r + k;
      if (rr < K) {
        v[k] = 0.0f;
      } else if (rr > K) {
        v[k] = a[rr] * h.inv;
        a[rr] = v[k];
      } else {
        v[k] = q < jq ? 0.0f : (q == jq ? 1.0f : a[rr] * h.inv);
        a[rr] = q < jq ? a[rr] : (q == jq ? h.beta : v[k]);
      }
    }
    *reinterpret_cast<float4*>(vj + r) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

#define QR_CASES(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) \
  X(10) X(11) X(12) X(13) X(14) X(15)

__device__ __forceinline__ void qr_zero_slot(float* X, int b) {
  for (int e = threadIdx.x; e < qr_slot_floats(b); e += QR_THREADS)
    X[e] = 0.0f;
}

// T (upper triangular, zero below) from the Gram matrix G (G[c][j] =
// v_c . v_j for c < j, V unit lower) and taus: the compact-WY
// recurrence T[:j, j] = -tau_j T[:j, :j] G[:j, j], T[j][j] = tau_j, taken
// in 16-column blocks — each diagonal block by its rows in parallel, then
// block column k as T[:j0, J] = -T[:j0, :j0] (G[:j0, J] T[J, J]).  Y is
// scratch.  T must be zero on entry; call after a barrier.
__device__ __forceinline__ void qr_build_t(float* T, const float* G,
                                           const float* taus, float* Y,
                                           int b) {
  const int ld = qr_ld(b);
  const int tid = threadIdx.x;
  if (tid < b) {                         // diagonal blocks: row r of its block
    const int r = tid, end = min((r | (QR_TB - 1)) + 1, b);
    float* tr = T + r * ld;
    tr[r] = taus[r];
    for (int j = r + 1; j < end; ++j) {
      float s = 0.0f;
#pragma unroll 4
      for (int c = r; c < j; ++c) s = fmaf(tr[c], G[c * ld + j], s);
      tr[j] = -taus[j] * s;
    }
  }
  for (int j0 = QR_TB; j0 < b; j0 += QR_TB) {
    const int nj = min(QR_TB, b - j0);
    __syncthreads();                     // T[:j0, :j0] and T[J, J] are done
    for (int e = tid; e < j0 * QR_TB; e += QR_THREADS) {
      const int r = e / QR_TB, jj = e % QR_TB;   // powers of two: shifts
      if (jj < nj) {                     // Y = G[:j0, J] T[J, J]
        float s = 0.0f;
#pragma unroll 4
        for (int c = j0; c <= j0 + jj; ++c)
          s = fmaf(G[r * ld + c], T[c * ld + j0 + jj], s);
        Y[r * ld + jj] = s;
      }
    }
    __syncthreads();
    for (int e = tid; e < j0 * QR_TB; e += QR_THREADS) {
      const int r = e / QR_TB, jj = e % QR_TB;
      if (jj < nj) {                     // T[:j0, J] = -T[:j0, :j0] Y
        float s = 0.0f;
#pragma unroll 4
        for (int c = r; c < j0; ++c) s = fmaf(T[r * ld + c], Y[c * ld + jj], s);
        T[r * ld + j0 + jj] = -s;
      }
    }
  }
  __syncthreads();
}

// The Householder panel, shared by geqrf (TS = false: A alone) and tsqrf
// (TS = true: [R; A], the top reflector block e_j).  A's columns live in
// registers (a[r] is row q + 4r of column m); R stays in shared memory,
// where lane 0 of column m's group alone reads and writes its row j.
// Iteration j applies reflector j - 1 to every column and forms reflector
// j in the pivot column's group, then meets the block at one barrier.
// Every shuffle runs with the whole warp converged (a shuffle inside a
// branch taken by part of a warp takes a slow, serialised path), so every
// group reduces its own column and the pivot group alone uses the result.
// vbuf: 2 x 64 floats (v of step j in half j & 1, stored at q * 16 + r);
// G, Y: scratch tiles; T: out; taus: b floats out.
template <bool TS>
__device__ __forceinline__ void qr_panel(float* R, float* A, float* T,
                                         float* taus, float* G, float* Y,
                                         float* vbuf, int b) {
  const int ld = qr_ld(b);
  const int tid = threadIdx.x, lane = tid & 31;
  const int m = tid >> 2, q = tid & 3;
  const bool own = m < b;
  const unsigned all = 0xffffffffu;
  float a[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int i = q + 4 * r;
    a[r] = own && i < b ? A[i * ld + m] : 0.0f;
  }
  qr_zero_slot(T, b);
  for (int j = 0;; ++j) {
    if (j > 0) {                         // apply reflector p = j - 1
      const int p = j - 1;
      const float* vp = vbuf + (p & 1) * QR_MAX_B + q * 16;
      const float tau = taus[p];
      float v[16];
#pragma unroll
      for (int r = 0; r < 16; r += 4) {
        const float4 x = *reinterpret_cast<const float4*>(vp + r);
        v[r] = x.x;
        v[r + 1] = x.y;
        v[r + 2] = x.z;
        v[r + 3] = x.w;
      }
      // v . column m (rows < p: v = 0); tsqrf's w adds R[p][m]
      const float rpm = TS && own && m > p && q == 0 ? R[p * ld + m] : 0.0f;
      float d[4] = {rpm, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 16; ++r) d[r & 3] = fmaf(v[r], a[r], d[r & 3]);
      const float dot = qr_quad_sum((d[0] + d[1]) + (d[2] + d[3]), all);
      if (own && m > p) {                // the trailing update
        if (TS) {                        // dot is w = R[p][m] + v . A[:, m]
#pragma unroll
          for (int r = 0; r < 16; ++r) a[r] = fmaf(-tau, v[r] * dot, a[r]);
          if (q == 0) R[p * ld + m] = fmaf(-tau, dot, rpm);
        } else {
          const float tw = tau * dot;
#pragma unroll
          for (int r = 0; r < 16; ++r) a[r] = fmaf(-v[r], tw, a[r]);
        }
      } else if (own && m < p && q == 0) {
        G[m * ld + p] = dot;             // a done column: the Gram column
      }
    }
    if (j == b) break;
    // reflector j, in the pivot column's warp only (a warp-uniform branch,
    // so its shuffles run converged): each group reduces its column below
    // row j (geqrf) or all of it (tsqrf); the pivot group's sum is used
    if (tid >> 5 == j >> 3) {
      const int jq = j & 3;
      float s0 = 0.0f, s1 = 0.0f, mine = 0.0f;
      if (TS) {                          // rows past b hold 0
#pragma unroll
        for (int r = 0; r < 16; r += 2) {
          s0 = fmaf(a[r], a[r], s0);
          s1 = fmaf(a[r + 1], a[r + 1], s1);
        }
        s0 += s1;
        if (own && q == 0) mine = R[j * ld + m];   // lane 0 alone reads R
      } else {
        switch (j >> 2) {
#define QR_TAIL(K) \
  case K:          \
    qr_tail_geqrf<K>(a, q, jq, s0, mine); \
    break;
          QR_CASES(QR_TAIL)
#undef QR_TAIL
        }
      }
      const float alpha = __shfl_sync(all, mine, (lane & ~3) | (TS ? 0 : jq));
      const float sigma2 = qr_quad_sum(s0, all);
      if (m == j) {                      // the pivot column's four threads
        const QrHouse h = qr_householder(alpha, sigma2);
        float* vj = vbuf + (j & 1) * QR_MAX_B + q * 16;
        if (TS) {
#pragma unroll
          for (int r = 0; r < 16; r += 4) {
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              v[k] = a[r + k] * h.inv;
              a[r + k] = v[k];
            }
            *reinterpret_cast<float4*>(vj + r) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        } else {
          switch (j >> 2) {
#define QR_PIVOT(K) \
  case K:           \
    qr_pivot_geqrf<K>(a, q, jq, h, vj); \
    break;
            QR_CASES(QR_PIVOT)
#undef QR_PIVOT
          }
        }
        if (q == 0) {
          taus[j] = h.tau;
          if (TS) R[j * ld + j] = h.beta;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int i = q + 4 * r;
    if (own && i < b) A[i * ld + m] = a[r];
  }
  __syncthreads();
  qr_build_t(T, G, taus, Y, b);
}

// GEQRF: A (b,b) -> RV in place, T, taus.  G, Y: scratch tiles; vbuf:
// 2 x 64 floats.
__device__ __noinline__ void geqrf_tile(float* A, float* T, float* taus,
                                        float* G, float* Y, float* vbuf,
                                        int b) {
  qr_panel<false>(nullptr, A, T, taus, G, Y, vbuf, b);
}

// TSQRF: [R; A] -> R' (upper triangle of R in place), V2 in place of A,
// T, taus.  G, Y: scratch tiles; vbuf: 2 x 64 floats.
__device__ __noinline__ void tsqrf_tile(float* R, float* A, float* T,
                                        float* taus, float* G, float* Y,
                                        float* vbuf, int b) {
  qr_panel<true>(R, A, T, taus, G, Y, vbuf, b);
}

// acc = A^T B on this thread's 4 x 4 block (rows r0.., columns c0..):
// acc[i][k] = sum_{t < n} A[t][r0 + i] B[t][c0 + k]
__device__ __forceinline__ void qr_mm_tn(const float* A, const float* B,
                                         int ld, int n, int r0, int c0,
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
  const float* pa = A + r0;
  const float* pb = B + c0;
#pragma unroll 4
  for (int t = 0; t < n; ++t, pa += ld, pb += ld) {
    const float4 x = *reinterpret_cast<const float4*>(pa);
    const float4 y = *reinterpret_cast<const float4*>(pb);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(xs[i], ys[k], acc[i][k]);
  }
}

// this thread's 4 x 4 output block of a product: rows 4 (tid / 16),
// columns 4 (tid % 16); false when it lies wholly past b
__device__ __forceinline__ bool qr_block(int b, int& r0, int& c0) {
  r0 = (threadIdx.x >> 4) * 4;
  c0 = (threadIdx.x & 15) * 4;
  return r0 < b && c0 < b;
}

__device__ __forceinline__ void qr_store_block(float* X, int ld,
                                               const float (&acc)[4][4],
                                               int r0, int c0) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(X + (r0 + i) * ld + c0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// X[r0 + i][c0 + k] -= acc[i][k] for the rows and columns inside b
__device__ __forceinline__ void qr_sub_block(float* X, int ld, int b,
                                             const float (&acc)[4][4],
                                             int r0, int c0) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (r0 + i < b && c0 + k < b) X[(r0 + i) * ld + c0 + k] -= acc[i][k];
}

// Walk the b x b elements so that a warp reads 8 rows x 4 columns and
// writes the transpose 4 rows x 8 columns (both near conflict-free at
// ld = 8 mod 32): fn(i, c) for every i, c < b.
template <typename Fn>
__device__ __forceinline__ void qr_each(int b, Fn fn) {
  for (int e = threadIdx.x; e < QR_MAX_B * QR_MAX_B; e += QR_THREADS) {
    const int i = (e & 7) | ((e >> 9) << 3), c = (e >> 3) & 63;
    if (i < b && c < b) fn(i, c);
  }
}

// LARFT apply: C <- C - V (T^T (V^T C)), V the unit-lower part of RV,
// which becomes V in place (RV is a shared-memory copy).  VT, W1, W2:
// scratch tiles.
__device__ __noinline__ void apply_qt_tile(float* RV, const float* T,
                                           float* C, float* VT, float* W1,
                                           float* W2, int b) {
  const int ld = qr_ld(b);
  qr_each(b, [&](int i, int c) {
    const float x = i > c ? RV[i * ld + c] : (i == c ? 1.0f : 0.0f);
    RV[i * ld + c] = x;
    VT[c * ld + i] = x;
  });
  __syncthreads();
  int r0, c0;
  const bool mine = qr_block(b, r0, c0);
  float acc[4][4];
  if (mine) {                            // W1 = V^T C
    qr_mm_tn(RV, C, ld, b, r0, c0, acc);
    qr_store_block(W1, ld, acc, r0, c0);
  }
  __syncthreads();
  if (mine) {                            // W2 = T^T W1
    qr_mm_tn(T, W1, ld, b, r0, c0, acc);
    qr_store_block(W2, ld, acc, r0, c0);
  }
  __syncthreads();
  if (mine) {                            // C -= V W2
    qr_mm_tn(VT, W2, ld, b, r0, c0, acc);
    qr_sub_block(C, ld, b, acc, r0, c0);
  }
  __syncthreads();
}

// SSRFT apply: W = T^T (C1 + V2^T C2); C1 -= W; C2 -= V2 W.
// W, V2T: scratch tiles.
__device__ __noinline__ void apply_tsqt_tile(const float* V2, const float* T,
                                             float* C1, float* C2, float* W,
                                             float* V2T, int b) {
  const int ld = qr_ld(b);
  qr_each(b, [&](int i, int c) { V2T[c * ld + i] = V2[i * ld + c]; });
  int r0, c0;
  const bool mine = qr_block(b, r0, c0);
  float acc[4][4];
  if (mine) {                            // W = C1 + V2^T C2
    qr_mm_tn(V2, C2, ld, b, r0, c0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[i][k] = C1[(r0 + i) * ld + c0 + k] + acc[i][k];
    qr_store_block(W, ld, acc, r0, c0);
  }
  __syncthreads();
  if (mine) {                            // X = T^T W; C1 -= X
    qr_mm_tn(T, W, ld, b, r0, c0, acc);
    qr_sub_block(C1, ld, b, acc, r0, c0);
  }
  __syncthreads();                       // every read of W is done
  if (mine) qr_store_block(W, ld, acc, r0, c0);   // W <- X
  __syncthreads();
  if (mine) {                            // C2 -= V2 X
    qr_mm_tn(V2T, W, ld, b, r0, c0, acc);
    qr_sub_block(C2, ld, b, acc, r0, c0);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// b > QR_MAX_B: the blocked bodies.  They replace the same TPU kernels
// (repro/kernels/qr_tile/kernel.py:173 geqrf, :190 tsqrf, :208 apply_qt,
// :221 apply_tsqt) and the bodies the walk runs (repro/engine/
// megakernel.py:236) at tiles wider than 64, up to QR_WIDE_MAX_B, one
// block an SM (their panel needs up to 255 registers a thread:
// qr_tile.cu).  The tiles stay where they lie in global memory and the
// bodies work through a shared-memory layout that depends on b only
// through the panel (qr_wide_floats: 105 KB up to b = 1024, at most 150
// KB).  All of an op's tiles do not fit a block
// (tsqrf's three 128^2 tiles are 192 KB, apply_tsqt's four 256 KB, a tile
// of b = 256 alone 256 KB).  Keeping just the tile an op updates in shared
// memory (up to b = 180, 175 KB at b = 128), each panel of V read once
// while it stays put, was built and timed on an H100 and was 0-5 % slower
// than staging it (PERF.md §6), so it is not used.  Nor is a
// cp.async ring for the staged blocks: its 4-byte copies (any b, any
// column offset) go through L1, which the walk may not read (below).
//
// What bounds them: as below 64, the chain of dependent column steps (b of
// them, one block barrier each), not bytes or flops.  The design:
//   * a blocked Householder: panels of nbw columns (qr_wide_nb: 64 up to
//     b = 128, 32 to 256, 16 to 512, 8 to 1024, then 4, 2, 1 to 2048,
//     4096, 8192), g = 256 / nbw threads a column, each holding QR_WR rows
//     of it in registers, in double.  Up to g = 32 (qr_w_factor) a column
//     step is one block barrier, as in qr_panel: every column takes its
//     dot with reflector j - 1 by a g-lane butterfly (the columns right of
//     it update their rows, the columns done give the Gram column), and
//     the pivot column's warp forms reflector j and publishes v
//     (double-buffered).  Past 32 a column spans g / 32 warps
//     (qr_w_factor_span): its sums add the warps' butterflies through
//     shared memory in warp order, at one more barrier a step;
//   * the trailing columns (and, for T, the columns left of the panel)
//     take the panel's compact WY as register-tiled products, 4 x 4
//     outputs a thread from float4 shared-memory reads: W = V^T M, staged
//     64 rows x 64 columns at a time from global memory (one coalesced
//     load of 16 floats a thread, all in flight), X = T_k^T W, then M -=
//     V X straight into global memory.  Past b = QR_W_CHAIN_MAX_B the sums
//     of W, past QR_CHAIN_MAX_B those of T's merge, are blocked
//     (qr_mm_nn4);
//   * T panel by panel: T_k from the panel's Gram by qr_build_t (the b <=
//     64 bodies' blocked recurrence), and T = [[T1, -T1 (V1^T V2) T2], [0,
//     T2]], the Y = V1^T V2 of the columns left of the panel coming out of
//     the same W product; the applies need only the diagonal blocks T_k,
//     applying Q = Q_1 Q_2 ... panel by panel;
//   * tsqrf's block of R (nbw x nbw) sits in shared memory, its top
//     reflector rows e_j entering each dot by one lane of the column.
// Every load of a tile goes past L1 (__ldcg): in the walk another SM may
// have written it in an earlier phase, and L1 is not coherent across SMs.
// Each result depends only on b and blockDim, never on gridDim or on the
// block, and every entry point runs these same functions.

// the dynamic shared memory of every entry point (qr_smem_floats(b)
// floats); the wide bodies address it directly, so that the compiler keeps
// their pointers in the shared window
extern __shared__ __align__(16) float qr_smem[];

// Built with -DQR_STAMPS (tools/qr_wide_stamps.py), thread 0 of block 0
// stamps clock64() after a block barrier at each stage of a wide body
// (qr_stamps in qr_tile.cu reads them); otherwise QR_STAMP is nothing.
#ifdef QR_STAMPS
__device__ long long qr_st[4096];
__device__ int qr_tag[4096];
__device__ int qr_sn;
#define QR_STAMP(t)                                                   \
  do {                                                                \
    __syncthreads();                                                  \
    if (threadIdx.x == 0 && blockIdx.x == 0 && qr_sn < 4096) {        \
      qr_tag[qr_sn] = (t);                                            \
      qr_st[qr_sn++] = clock64();                                     \
    }                                                                 \
  } while (0)
#else
#define QR_STAMP(t) \
  do {              \
  } while (0)
#endif

// this wide body's shared memory: the panel p (nbw columns of pld rows),
// the slots t (T of the panel, ld qr_ld(nb)), a (the Gram, then W and X),
// s (qr_wide_sfloats: while the panel is factored its Householder vectors
// in double, each as QR_WR / 2 double2 of each of a column's g threads:
// double2 r2 g + q holds rows q + g (2 r2) and q + g (2 r2 + 1) of it; then
// qr_build_t's Y, then the staged rows of the matrix updated), r (tsqrf's
// block of R, ld QR_WL), taus (nb) and red (QR_WRED: the cross-warp
// partial sums of qr_w_factor_span)
struct QrW {
  float *p, *t, *a, *s, *r, *taus;
  double* red;
  int nbw, g, pld;
};

__device__ __forceinline__ QrW qr_w(int b) {
  QrW w;
  w.nbw = qr_wide_nb(b);
  w.g = qr_wide_group(w.nbw);
  w.pld = qr_wide_pld(b, w.nbw);
  w.p = qr_smem;
  w.t = w.p + w.nbw * w.pld;
  w.a = w.t + QR_WS;
  w.s = w.a + QR_WS;
  w.r = w.s + qr_wide_sfloats(w.g);
  w.taus = w.r + QR_WS;
  w.red = reinterpret_cast<double*>(w.taus + QR_MAX_B);
  return w;
}

// sum of x over an aligned group of g lanes (a power of two up to 32), in
// a fixed order; every lane of the group gets the same bits.  Every lane of
// the warp calls it.
__device__ __forceinline__ double qr_group_sum(double x, int g) {
  for (int off = 1; off < g; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the sum of a column spread over gw warps from their partials (red[w0]
// .. red[w0 + gw - 1], one a warp), added in warp order: every thread of
// the column's group gets the same bits
__device__ __forceinline__ double qr_warps_sum(const double* red, int w0,
                                               int gw) {
  double x = red[w0];
  for (int k = 1; k < gw; ++k) x += red[w0 + k];
  return x;
}

// acc[i][k] += the four rows t .. t + 3 of qr_mm_nn4's sum (pa, pb at
// row t): four float4 of A along t and four of B along the columns, 64
// fmas
__device__ __forceinline__ void qr_mm_step(const float* pa, int lda,
                                           const float* pb, int ldb,
                                           float (&acc)[4][4]) {
  float xs[4][4], ys[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(pa + i * lda);
    const float4 y = *reinterpret_cast<const float4*>(pb + i * ldb);
    xs[i][0] = x.x; xs[i][1] = x.y; xs[i][2] = x.z; xs[i][3] = x.w;
    ys[i][0] = y.x; ys[i][1] = y.y; ys[i][2] = y.z; ys[i][3] = y.w;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[i][k] = fmaf(xs[i][u], ys[u][k], acc[i][k]);
}

#define QR_MM_IN 16   // rows of qr_mm_nn4's inner blocks (BLK)

// acc[i][k] += sum_{t < n} A[(r0 + i) lda + t] B[t ldb + c0 + k], n a
// multiple of 4 up to 64: four float4 of A along t and four of B along the
// columns a step, 64 fmas.  BLK (past the chain thresholds): the sum is
// blocked, QR_MM_IN rows into fresh float accumulators, added into the
// call's own partials of type P, added into acc (of type S) once a call
// (callers take up to 64 rows a call), so that a float32 rounding grows
// with QR_MM_IN and the calls (S = float) or with QR_MM_IN alone (P = S =
// double), not with the rows.  Summed as one float chain (acc updated by
// every fma, as up to the thresholds), W = V^T M over b = 512 or 1000 rows
// left R and T further from float64 than the plain float32 version
// (PERF.md §6).
template <bool BLK, typename P, typename S>
__device__ __forceinline__ void qr_mm_nn4(const float* A, int lda,
                                          const float* B, int ldb, int n,
                                          int r0, int c0, S (&acc)[4][4]) {
  const float* pa = A + r0 * lda;
  const float* pb = B + c0;
  if constexpr (BLK) {
    P mid[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) mid[i][k] = 0.0f;
    for (int t0 = 0; t0 < n; t0 += QR_MM_IN) {
      float in[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) in[i][k] = 0.0f;
#pragma unroll
      for (int t = 0; t < QR_MM_IN; t += 4, pa += 4, pb += 4 * ldb) {
        if (t0 + t >= n) break;
        qr_mm_step(pa, lda, pb, ldb, in);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) mid[i][k] += in[i][k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] += (S)mid[i][k];
  } else {
#pragma unroll 2
    for (int t = 0; t < n; t += 4, pa += 4, pb += 4 * ldb)
      qr_mm_step(pa, lda, pb, ldb, acc);
  }
}

// acc[i][k] = sum_{t < n} A[t lda + r0 + i] B[t ldb + c0 + k]
__device__ __forceinline__ void qr_mm_tn2(const float* A, int lda,
                                          const float* B, int ldb, int n,
                                          int r0, int c0,
                                          float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
  const float* pa = A + r0;
  const float* pb = B + c0;
#pragma unroll 4
  for (int t = 0; t < n; ++t, pa += lda, pb += ldb) {
    const float4 x = *reinterpret_cast<const float4*>(pa);
    const float4 y = *reinterpret_cast<const float4*>(pb);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(xs[i], ys[k], acc[i][k]);
  }
}

// S (64 rows at QR_WL) <- the n x nc block of X (row-major, ld ldx), zeros
// elsewhere: 16 coalesced loads a thread, all in flight before the stores
__device__ __forceinline__ void qr_w_stage(float* S, const float* X, int ldx,
                                           int n, int nc) {
  float x[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int e = threadIdx.x + k * QR_THREADS, i = e >> 6, c = e & 63;
    x[k] = i < n && c < nc ? __ldcg(X + (size_t)i * ldx + c) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int e = threadIdx.x + k * QR_THREADS, i = e >> 6, c = e & 63;
    S[i * QR_WL + c] = x[k];
  }
}

// the panel <- rows 0 .. rows - 1, columns 0 .. nb - 1 of X (the panel's
// top-left corner, row-major at ld ldx), column-major, zeros in every other
// row and column of it.  unit: geqrf's V from RV (1 on the diagonal, 0
// above it).  A warp reads a row's columns, so global loads coalesce.
__device__ __forceinline__ void qr_w_load_panel(const QrW& w, const float* X,
                                                int ldx, int rows, int nb,
                                                bool unit) {
  const int n = w.nbw * w.pld;
  for (int e0 = threadIdx.x; e0 < n; e0 += 8 * QR_THREADS) {
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * QR_THREADS, i = e / w.nbw, c = e % w.nbw;
      const bool in = e < n && i < rows && c < nb && (!unit || i >= c);
      x[k] = in ? (unit && i == c ? 1.0f : __ldcg(X + (size_t)i * ldx + c))
                : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * QR_THREADS, i = e / w.nbw, c = e % w.nbw;
      if (e < n) w.p[c * w.pld + i] = x[k];
    }
  }
}

// the panel's rows 0 .. rows - 1, columns 0 .. nb - 1 -> X; unit: the
// panel becomes geqrf's V (1 on the diagonal, 0 above it) in the same pass
__device__ __forceinline__ void qr_w_store_panel(const QrW& w, float* X,
                                                 int ldx, int rows, int nb,
                                                 bool unit) {
  for (int e = threadIdx.x; e < rows * nb; e += QR_THREADS) {
    const int i = e / nb, c = e % nb;
    float* p = w.p + c * w.pld + i;
    __stcg(X + (size_t)i * ldx + c, *p);
    if (unit && i <= c) *p = i == c ? 1.0f : 0.0f;
  }
}

// geqrf's pivot column j in a thread of its group (rows q + g r): rows
// with r < K = j / g lie above row j, rows with r > K below it, and row
// q + g K is above, at or below j as q is <, = or > jq = j % g.  K is the
// same for the whole warp, so qr_w_factor switches on it (one jump, no
// divergence) into code whose row tests are resolved at compile time, as
// qr_tail_geqrf and qr_pivot_geqrf do for the b <= 64 panel.
template <int K>
__device__ __forceinline__ void qr_w_tail(const double (&a)[QR_WR], int q,
                                          int jq, double& sigma2,
                                          double& alpha) {
  double s[4] = {q > jq ? a[K] * a[K] : 0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int r = K + 1; r < QR_WR; ++r) s[r & 3] = fma(a[r], a[r], s[r & 3]);
  sigma2 = (s[0] + s[1]) + (s[2] + s[3]);
  alpha = a[K];
}

template <int K>
__device__ __forceinline__ void qr_w_pivot(double (&a)[QR_WR], int q, int jq,
                                           const QrHouse& h, double2* vj,
                                           int g) {
  const double inv = h.inv;
#pragma unroll
  for (int r = 0; r < QR_WR; r += 2) {
    double v[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int rr = r + k;
      const double x = a[rr] * inv;
      if (rr < K) {
        v[k] = 0.0;
      } else if (rr > K) {
        v[k] = x;
        a[rr] = x;
      } else {
        v[k] = q < jq ? 0.0 : (q == jq ? 1.0 : x);
        a[rr] = q < jq ? a[rr] : (q == jq ? (double)h.beta : x);
      }
    }
    vj[(r >> 1) * g] = make_double2(v[0], v[1]);
  }
}

// The panel's column steps, g <= 32 (a column within one warp): geqrf (TS
// = false; the panel's row c is its column c's diagonal) or tsqrf (TS =
// true: [R; A], R's block in w.r, the top reflector block e_j).  Column m
// belongs to threads m g .. m g + g - 1, thread q of them holding rows q +
// g r (r < QR_WR) of it in registers,
// in double (a[r]; rows past the panel hold 0), read from w.p and rounded
// back to it at the end: within a panel the updates and their dots carry
// no float rounding.  At b = 256 float panels leave R up to 1.5 times the
// kernel-vs-plain limit from float64 on random tiles (as far as the plain
// float32 version itself lies), and the trailing matrix rounds once a
// panel instead.  The Householder scalars come from the column rounded to
// float, by qr_householder (the reference's guards); v = a * inv in double
// is rounded once, when the panel is written back.
// Step j applies reflector j - 1 to every column (the dot by a g-lane
// butterfly; tsqrf's w adds R[j - 1][m], read and written by lane q == 0
// alone): the columns right of it update their rows, the columns done give
// the Gram entry G[m][j - 1] = v_m . v_{j-1} (w.a at ld tld), from which
// qr_build_t builds T.  Then column j's warp forms reflector j (its v to
// w.s, half j & 1) and the block meets at one barrier.  Every shuffle runs
// with its warp converged.  taus: nb floats out (w.taus).
template <bool TS>
__device__ __forceinline__ void qr_w_factor(const QrW& w, int rows, int nb,
                                            int tld) {
  const int g = w.g, pld = w.pld;
  const int tid = threadIdx.x, lane = tid & 31, m = tid / g, q = tid % g;
  const bool own = m < nb;
  float* pm = w.p + m * pld + q;         // m < nbw: every thread's column
  const unsigned all = 0xffffffffu;
  double a[QR_WR];
#pragma unroll
  for (int r = 0; r < QR_WR; ++r)
    a[r] = own && q + g * r < rows ? (double)pm[g * r] : 0.0;
  double2* v2 = reinterpret_cast<double2*>(w.s);
  for (int j = 0;; ++j) {
    if (j > 0) {                         // apply reflector p = j - 1
      const int p = j - 1;
      const double2* vp = v2 + (p & 1) * (QR_WR / 2) * g + q;
      const double tau = w.taus[p];
      const float rpm = TS && own && m > p && q == 0 ? w.r[p * QR_WL + m]
                                                     : 0.0f;
      double v[QR_WR], d[4] = {rpm, 0.0, 0.0, 0.0};
#pragma unroll
      for (int r = 0; r < QR_WR; r += 2) {   // v: two rows a load
        const double2 x = vp[(r >> 1) * g];
        v[r] = x.x;
        v[r + 1] = x.y;
        d[r & 2] = fma(x.x, a[r], d[r & 2]);
        d[(r & 2) + 1] = fma(x.y, a[r + 1], d[(r & 2) + 1]);
      }
      const double dot = qr_group_sum((d[0] + d[1]) + (d[2] + d[3]), g);
      if (own && m > p) {                // the trailing update
        const double tw = tau * dot;
        if (TS && q == 0)
          w.r[p * QR_WL + m] = (float)fma(-tau, dot, (double)rpm);
#pragma unroll
        for (int r = 0; r < QR_WR; ++r) a[r] = fma(-v[r], tw, a[r]);
      } else if (own && m < p && q == 0) {
        w.a[m * tld + p] = (float)dot;   // a done column: the Gram entry
      }
    }
    if (j == nb) break;
    // reflector j, in column j's warp only (a warp-uniform branch, so its
    // shuffles run converged); the pivot group's sums are used
    if (tid >> 5 == (j * g) >> 5) {
      const int jq = j % g;
      double sigma2 = 0.0, mine = 0.0;
      if (TS) {
        double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int r = 0; r < QR_WR; ++r) s[r & 3] = fma(a[r], a[r], s[r & 3]);
        sigma2 = (s[0] + s[1]) + (s[2] + s[3]);
        mine = w.r[j * QR_WL + j];
      } else {
        switch (j / g) {
#define QR_W_TAIL(K) \
  case K:            \
    qr_w_tail<K>(a, q, jq, sigma2, mine); \
    break;
          QR_CASES(QR_W_TAIL)
#undef QR_W_TAIL
        }
      }
      const float alpha = (float)__shfl_sync(all, mine, (lane & ~(g - 1)) | jq);
      sigma2 = qr_group_sum(sigma2, g);
      __syncwarp();                      // every lane has read R[j][j]
      if (m == j) {                      // the pivot column's g threads
        const QrHouse h = qr_householder(alpha, (float)sigma2);
        double2* vj = v2 + (j & 1) * (QR_WR / 2) * g + q;
        if (TS) {
#pragma unroll
          for (int r = 0; r < QR_WR; r += 2) {
            a[r] *= (double)h.inv;
            a[r + 1] *= (double)h.inv;
            vj[(r >> 1) * g] = make_double2(a[r], a[r + 1]);
          }
        } else {
          switch (j / g) {
#define QR_W_PIVOT(K) \
  case K:             \
    qr_w_pivot<K>(a, q, jq, h, vj, g); \
    break;
            QR_CASES(QR_W_PIVOT)
#undef QR_W_PIVOT
          }
        }
        if (q == 0) {
          w.taus[j] = h.tau;
          if (TS) w.r[j * QR_WL + j] = h.beta;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < QR_WR; ++r)
    if (own && q + g * r < rows) pm[g * r] = (float)a[r];
}

// The column steps of qr_w_factor for g > 32 (panels of 4, 2 or 1
// columns): a column spans gw = g / 32 whole warps, so a sum over it is
// each warp's butterfly, then the gw warp sums from w.red in warp order
// (qr_warps_sum), and needs a barrier between the two.  With nb <= 4 < g,
// every row at or above a pivot j < nb is a thread's first row (r = 0, q
// <= j).  Step j, after barrier B of step j - 1 (every thread holding
// reflector j - 1's scalars h):
//   * every column takes its partial dot with v_{j-1} = u * inv (u the
//     published column, 0 at and above row j - 1, and 1 at row j - 1 for
//     geqrf), the warps' sums go to w.red; barrier A;
//   * each column adds its warps' sums: the columns right of j - 1 update
//     their rows, the columns done give the Gram entry.  Column j's group
//     publishes its rows u (below j for geqrf; all rows for tsqrf) and its
//     warps' squared norms, and geqrf's alpha (row j); barrier B;
//   * every thread forms reflector j's scalars from the same sums in the
//     same order (qr_householder: the same bits everywhere), and column j
//     turns its rows into v (beta on the diagonal for geqrf).
// Two barriers a column, one more than qr_w_factor; the vector slot holds
// one vector (u is written after barrier A, when every read of the last
// one is done).  Up to rounding of the sums' order, the arithmetic is
// qr_w_factor's: v = a * inv in double, the dots and the update in double.
template <bool TS>
__device__ __forceinline__ void qr_w_factor_span(const QrW& w, int rows,
                                                 int nb, int tld) {
  const int g = w.g, pld = w.pld, gw = g >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = tid / g, q = tid % g;
  const bool own = m < nb;
  float* pm = w.p + m * pld + q;         // m < nbw: every thread's column
  double* red = w.red;                   // [dots | squared norms | alpha]
  double a[QR_WR];
#pragma unroll
  for (int r = 0; r < QR_WR; ++r)
    a[r] = own && q + g * r < rows ? (double)pm[g * r] : 0.0;
  double2* u2 = reinterpret_cast<double2*>(w.s) + q;
  QrHouse h = {0.0f, 0.0f, 0.0f};
  for (int j = 0;; ++j) {
    if (j > 0) {                         // apply reflector p = j - 1
      const int p = j - 1;
      const double inv = (double)h.inv, tau = (double)h.tau;
      const float rpm = TS && own && m > p && q == 0 ? w.r[p * QR_WL + m]
                                                     : 0.0f;
      double v[QR_WR], d[4] = {rpm, 0.0, 0.0, 0.0};
#pragma unroll
      for (int r = 0; r < QR_WR; r += 2) {
        const double2 x = u2[(r >> 1) * g];
        v[r] = !TS && r == 0 && q == p ? 1.0 : x.x * inv;
        v[r + 1] = x.y * inv;
        d[r & 2] = fma(v[r], a[r], d[r & 2]);
        d[(r & 2) + 1] = fma(v[r + 1], a[r + 1], d[(r & 2) + 1]);
      }
      const double part = qr_group_sum((d[0] + d[1]) + (d[2] + d[3]), 32);
      if (lane == 0) red[warp] = part;
      __syncthreads();                   // A: every warp's dot is in red
      const double dot = qr_warps_sum(red, m * gw, gw);
      if (own && m > p) {                // the trailing update
        const double tw = tau * dot;
        if (TS && q == 0)
          w.r[p * QR_WL + m] = (float)fma(-tau, dot, (double)rpm);
#pragma unroll
        for (int r = 0; r < QR_WR; ++r) a[r] = fma(-v[r], tw, a[r]);
      } else if (own && m < p && q == 0) {
        w.a[m * tld + p] = (float)dot;   // a done column: the Gram entry
      }
    }
    if (j == nb) break;
    // reflector j: column j's g threads (whole warps) publish u and their
    // squared norms; every thread reads R[j][j] (tsqrf's alpha) before the
    // barrier, after which column j writes beta there
    const float alpha_ts = TS ? w.r[j * QR_WL + j] : 0.0f;
    if (m == j) {
      double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int r = 0; r < QR_WR; r += 2) {
        const double x0 = !TS && r == 0 && q <= j ? 0.0 : a[r];
        s[r & 2] = fma(x0, x0, s[r & 2]);
        s[(r & 2) + 1] = fma(a[r + 1], a[r + 1], s[(r & 2) + 1]);
        u2[(r >> 1) * g] = make_double2(x0, a[r + 1]);
      }
      const double part = qr_group_sum((s[0] + s[1]) + (s[2] + s[3]), 32);
      if (lane == 0) red[QR_WARPS + warp] = part;
      if (!TS && q == j) red[2 * QR_WARPS] = a[0];
    }
    __syncthreads();                     // B: u, the norms and alpha
    const double sigma2 = qr_warps_sum(red, QR_WARPS + j * gw, gw);
    h = qr_householder(TS ? alpha_ts : (float)red[2 * QR_WARPS],
                       (float)sigma2);
    if (m == j) {                        // column j becomes v_j
      const double inv = (double)h.inv;
#pragma unroll
      for (int r = 0; r < QR_WR; ++r)
        if (TS || r > 0 || q > j) a[r] *= inv;
        else if (q == j) a[r] = (double)h.beta;
      if (q == 0) {
        w.taus[j] = h.tau;
        if (TS) w.r[j * QR_WL + j] = h.beta;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < QR_WR; ++r)
    if (own && q + g * r < rows) pm[g * r] = (float)a[r];
}

// T[J, J] <- the panel's T (its strict lower part zero) and T[J, 0:j0] <-
// 0, J = j0 .. j0 + nb - 1 (T row-major at ld b)
__device__ __forceinline__ void qr_w_store_t(const QrW& w, float* T, int b,
                                             int j0, int nb, int tld) {
  const int n = j0 + nb;
  for (int e = threadIdx.x; e < nb * n; e += QR_THREADS) {
    const int i = e / n, c = e % n;
    __stcg(T + (size_t)(j0 + i) * b + c,
           c < j0 ? 0.0f : w.t[i * tld + c - j0]);
  }
}

// the panel's T <- the nb x nb diagonal block of T at X (row-major, ld b),
// its upper triangle, zeros in the rest of the slot
__device__ __forceinline__ void qr_w_load_t(const QrW& w, const float* X,
                                            int b, int nb, int tld) {
  for (int e = threadIdx.x; e < qr_rows(nb) * tld; e += QR_THREADS) {
    const int i = e / tld, c = e % tld;
    w.t[e] = i <= c && c < nb ? __ldcg(X + (size_t)i * b + c) : 0.0f;
  }
}

// tsqrf's block of R (nb x nb at X, row-major, ld b) <-> w.r: the upper
// triangle only (the strict lower part is neither read nor written)
__device__ __forceinline__ void qr_w_load_r(const QrW& w, const float* X,
                                            int b, int nb) {
  for (int e = threadIdx.x; e < nb * nb; e += QR_THREADS) {
    const int i = e / nb, c = e % nb;
    w.r[i * QR_WL + c] = i <= c ? __ldcg(X + (size_t)i * b + c) : 0.0f;
  }
}

__device__ __forceinline__ void qr_w_store_r(const QrW& w, float* X, int b,
                                             int nb) {
  for (int e = threadIdx.x; e < nb * nb; e += QR_THREADS) {
    const int i = e / nb, c = e % nb;
    if (i <= c) __stcg(X + (size_t)i * b + c, w.r[i * QR_WL + c]);
  }
}

// acc += V^T M[r0:r0 + rows, c0:c0 + nc] (V in w.p), M's rows staged 64
// at a time through w.s; every thread takes part, the mine ones sum
// (qr_mm_nn4<BLK, P>)
template <bool BLK, typename P, typename S>
__device__ __forceinline__ void qr_w_vtm(const QrW& w, const float* M,
                                         int b, int r0, int rows, int c0,
                                         int nc, int tr, int tc, bool mine,
                                         S (&acc)[4][4]) {
  for (int tb = 0; tb < rows; tb += QR_MAX_B) {
    const int n = min(QR_MAX_B, rows - tb);
    qr_w_stage(w.s, M + (size_t)(r0 + tb) * b + c0, b, n, nc);
    __syncthreads();
    if (mine)
      qr_mm_nn4<BLK, P>(w.p + tb, w.pld, w.s, QR_WL, (n + 3) & ~3, tr, tc,
                        acc);
    __syncthreads();
  }
}

// The panel's block reflector (V in w.p, T_k in w.t at ld tld) on columns
// c0 .. c1 - 1 (at most 64) of the row-major (ld b) matrix M, its rows r0
// .. r0 + rows - 1:
//   W = Top[:, c0:c1] + V^T M[r0:, c0:c1]   (Top: nb rows at ld b, or none)
//   X = T_k^T W
// then, for a chunk left of the panel (Z: T's block column), Z[c][r] =
// X[r][c] (Y T_k, Y = V_prev^T V); else Top -= X and M[r0:, c0:c1] -= V X.
// W's rows are staged 64 at a time; V X goes straight to global memory.
__device__ __forceinline__ void qr_w_chunk(const QrW& w, int nb, int tld,
                                           float* M, int b, int r0, int rows,
                                           int c0, int c1, float* Top,
                                           float* Z) {
  const int tr = (threadIdx.x >> 4) * 4, tc = (threadIdx.x & 15) * 4;
  const int nc = c1 - c0;
  const bool mine = tr < nb && tc < nc;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[i][k] = Top && mine && tr + i < nb && tc + k < nc
                      ? __ldcg(Top + (size_t)(tr + i) * b + c0 + tc + k)
                      : 0.0f;
  if (b > QR_FLOAT_SUM_MAX_B) {          // W = Top + V^T M
    double wd[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) wd[i][k] = acc[i][k];
    qr_w_vtm<true, double>(w, M, b, r0, rows, c0, nc, tr, tc, mine, wd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = (float)wd[i][k];
  } else if (b > QR_CHAIN_MAX_B) {
    qr_w_vtm<true, float>(w, M, b, r0, rows, c0, nc, tr, tc, mine, acc);
  } else if (b > QR_W_CHAIN_MAX_B) {
    qr_w_vtm<true, double>(w, M, b, r0, rows, c0, nc, tr, tc, mine, acc);
  } else {
    qr_w_vtm<false, float>(w, M, b, r0, rows, c0, nc, tr, tc, mine, acc);
  }
  if (mine) qr_store_block(w.a, QR_WL, acc, tr, tc);
  __syncthreads();
  if (mine) qr_mm_tn2(w.t, tld, w.a, QR_WL, nb, tr, tc, acc);   // X
  __syncthreads();                       // every read of W is done
  if (Z) {
    if (mine)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (tr + i < nb && tc + k < nc)
            __stcg(Z + (size_t)(c0 + tc + k) * b + tr + i, acc[i][k]);
    return;
  }
  if (mine) {
    qr_store_block(w.a, QR_WL, acc, tr, tc);
    if (Top)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (tr + i < nb && tc + k < nc) {
            float* p = Top + (size_t)(tr + i) * b + c0 + tc + k;
            __stcg(p, __ldcg(p) - acc[i][k]);
          }
  }
  __syncthreads();
  for (int i0 = tr; i0 < rows; i0 += QR_MAX_B) {  // M -= V X, rows i0 ..
    if (tc >= nc) break;
    qr_mm_tn2(w.p + i0, w.pld, w.a, QR_WL, nb, 0, tc, acc);
    float* row = M + (size_t)(r0 + i0) * b + c0 + tc;
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[i][k] = i0 + i < rows && tc + k < nc ? __ldcg(row + i * b + k) : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + i < rows && tc + k < nc)
          __stcg(row + i * b + k, x[i][k] - acc[i][k]);
  }
}

// rows i0 .. i0 + 63 of qr_w_merge (qr_mm_nn4<BLK, S> into S)
template <bool BLK, typename S>
__device__ __forceinline__ void qr_w_merge_rows(const QrW& w, float* T,
                                                int b, int j0, int nb,
                                                int i0) {
  const int tr = (threadIdx.x >> 4) * 4, tc = (threadIdx.x & 15) * 4;
  const int ni = min(QR_MAX_B, j0 - i0);
  const bool mine = tr < ni && tc < nb;
  S acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
  for (int t0 = i0; t0 < j0; t0 += QR_MAX_B) {   // T1 is upper triangular
    const int nt = min(QR_MAX_B, j0 - t0);
    __syncthreads();                     // the slots' last readers are done
    qr_w_stage(w.s, T + (size_t)i0 * b + t0, b, ni, nt);
    qr_w_stage(w.a, T + (size_t)t0 * b + j0, b, nt, nb);
    __syncthreads();
    if (mine)
      qr_mm_nn4<BLK, S>(w.s, QR_WL, w.a, QR_WL, (nt + 3) & ~3, tr, tc, acc);
  }
  if (mine)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (tr + i < ni && tc + k < nb)
          __stcg(T + (size_t)(i0 + tr + i) * b + j0 + tc + k,
                 -(float)acc[i][k]);
}

// T[lo:j0, J] <- -T[lo:j0, lo:j0] Z, Z = T[lo:j0, J] on entry (the chunks
// left of the panel wrote it), in 64-row blocks top down: block i reads
// Z's rows from i on only, so it may overwrite its own rows when it is
// done.  lo = 0 merges into the whole T; past QR_OUTER_MIN_B an inner
// panel merges into its outer panel's T (lo: the outer panel's first
// column) first
__device__ __forceinline__ void qr_w_merge(const QrW& w, float* T, int b,
                                           int lo, int j0, int nb) {
  for (int i0 = lo; i0 < j0; i0 += QR_MAX_B) {
    if (b > QR_FLOAT_SUM_MAX_B)
      qr_w_merge_rows<true, double>(w, T, b, j0, nb, i0);
    else if (b > QR_CHAIN_MAX_B)
      qr_w_merge_rows<true, float>(w, T, b, j0, nb, i0);
    else
      qr_w_merge_rows<false, float>(w, T, b, j0, nb, i0);
  }
}

// The panel of geqrf (TS = false: rows j0 .. b - 1 of A) or tsqrf (TS:
// all b rows of A under R's block) after its load: factor it, write it
// back, build its T, update the columns right of it, fold it into T.
// R: tsqrf's R (row-major, ld b); taus: b floats out, or null.
template <bool TS>
__device__ __forceinline__ void qr_w_fact_panel(const QrW& w, float* R,
                                                float* A, float* T,
                                                float* taus, int j0, int b) {
  const int nb = min(w.nbw, b - j0), tld = qr_ld(nb);
  const int r0 = TS ? 0 : j0, rows = b - r0;
  float* pa = A + (size_t)r0 * b + j0;
  QR_STAMP(1);
  if (w.g > 32)
    qr_w_factor_span<TS>(w, rows, nb, tld);
  else
    qr_w_factor<TS>(w, rows, nb, tld);
  __syncthreads();                       // the panel is back in w.p
  QR_STAMP(2);
  qr_w_store_panel(w, pa, b, rows, nb, !TS);   // RV / V2 out, V in w.p
  if (TS) qr_w_store_r(w, R + (size_t)j0 * b + j0, b, nb);
  if (taus)
    for (int c = threadIdx.x; c < nb; c += QR_THREADS)
      __stcg(taus + j0 + c, w.taus[c]);
  __syncthreads();
  QR_STAMP(3);
  qr_build_t(w.t, w.a, w.taus, w.s, nb);
  QR_STAMP(4);
  qr_w_store_t(w, T, b, j0, nb, tld);
  float* top = TS ? R + (size_t)j0 * b : nullptr;
  for (int c = j0 + nb; c < b; c += QR_MAX_B)    // the trailing columns
    qr_w_chunk(w, nb, tld, A, b, r0, rows, c, min(c + QR_MAX_B, b), top,
               nullptr);
  QR_STAMP(5);
  for (int c = 0; c < j0; c += QR_MAX_B)         // Y T_k, Y = V_prev^T V
    qr_w_chunk(w, nb, tld, A, b, r0, rows, c, min(c + QR_MAX_B, j0),
               nullptr, T + j0);
  QR_STAMP(6);
  qr_w_merge(w, T, b, 0, j0, nb);
  QR_STAMP(7);
}

// ---------------------------------------------------------------------------
// b > QR_OUTER_MIN_B: 64-column outer panels and 64-reflector blocks.  The
// register panel is 4, 2 or 1 columns wide there, and the bodies above pay
// one staged pass over the whole trailing matrix a panel (512 at b =
// 2048).  Here the WY block is decoupled from the register panel:
//   * geqrf, tsqrf factor each 64-column outer panel J in the register
//     panels of qr_wide_nb; an inner panel updates, and merges its T into,
//     the rest of J only (qr_o_inner: one staged pass over J's rows), and
//     J's 64-wide compact WY updates the trailing matrix once (qr_o_wy):
//     b / 64 passes over it instead of b / nbw;
//   * apply_qt, apply_tsqt apply Q block by block with the 64 x 64
//     diagonal blocks of the merged T, one 64-column chunk of C a call:
//     the chunks are independent, so a tile's ceil(b / 64) chunks run on
//     as many blocks (qr_apply_chunks; the per-op grid's y, the walk's
//     items), each chunk's arithmetic the same whichever block runs it.
// V_k (up to 8192 x 64 floats) does not fit shared memory: it streams from
// global memory in 64-row blocks beside the rows of the matrix it
// updates, the next block's loads in flight while the current one is
// summed.  The full T keeps its meaning (ref.py): T_J from the inner
// panels' merges, then T[0:j0, J] = -T[0:j0, 0:j0] (V_prev^T V_J) T_J.
// Sums: W = V^T M in 16-row float blocks into float call partials to
// QR_FLOAT_SUM_MAX_B and double ones past it (as above), X = T^T W and
// V X as float chains of 64 terms.

// x <- rows t0 .. t0 + 63, columns 0 .. 63 of X (row-major at ld ldx;
// zeros past row n and column nc), 16 coalesced loads a thread; unit:
// geqrf's V from RV (1 on the diagonal, 0 above it)
__device__ __forceinline__ void qr_o_load(float (&x)[16], const float* X,
                                          int ldx, int t0, int n, int nc,
                                          bool unit) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int e = threadIdx.x + k * QR_THREADS, r = t0 + (e >> 6),
              c = e & 63;
    const bool in = r < n && c < nc;
    x[k] = in && (!unit || r > c) ? __ldcg(X + (size_t)r * ldx + c)
                                  : (in && r == c ? 1.0f : 0.0f);
  }
}

// S (64 rows at QR_WL) <- qr_o_load's x
__device__ __forceinline__ void qr_o_store(float* S, const float (&x)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int e = threadIdx.x + k * QR_THREADS;
    S[(e >> 6) * QR_WL + (e & 63)] = x[k];
  }
}

// acc[i][k] += sum_{t < n} A[t lda + r0 + i] B[t ldb + c0 + k], n a
// multiple of QR_MM_IN: QR_MM_IN rows into fresh float accumulators, added
// into the call's partials of type P, added into acc once a call
// (qr_mm_nn4's blocking, with both operands along rows)
template <typename P>
__device__ __forceinline__ void qr_mm_tn4(const float* A, int lda,
                                          const float* B, int ldb, int n,
                                          int r0, int c0, P (&acc)[4][4]) {
  const float* pa = A + r0;
  const float* pb = B + c0;
  P mid[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) mid[i][k] = 0.0f;
  for (int t0 = 0; t0 < n; t0 += QR_MM_IN) {
    float in[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) in[i][k] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < QR_MM_IN; ++t, pa += lda, pb += ldb) {
      const float4 x = *reinterpret_cast<const float4*>(pa);
      const float4 y = *reinterpret_cast<const float4*>(pb);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) in[i][k] = fmaf(xs[i], ys[k], in[i][k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) mid[i][k] += in[i][k];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] += mid[i][k];
}

// The block reflector of the nv <= 64 reflectors V (global, row-major at
// ld b, rows 0 .. rows - 1; unit: geqrf's RV), T_k in w.t at ld tld, on
// columns c0 .. c1 - 1 (at most 64) of M (rows 0 .. rows - 1, ld b):
//   W = Top[:, c0:c1] + V^T M[:, c0:c1]   (Top: nv rows at ld b, or none)
//   X = T_k^T W
// then, for a chunk left of the outer panel (Z: T's block column), Z[c][r]
// = X[r][c] (Y T_k, Y = V_prev^T V); else Top -= X and M -= V X.  V's and
// M's 64-row blocks stage through w.s and w.r for W, V's again for V X,
// which goes straight to global memory; w.a holds W, then X.  A function
// of its own (one copy for every caller, its registers apart from the
// panels'); its shared-memory pointers come from qr_smem (qr_w), so they
// stay in the shared window.
template <typename P>
__device__ __noinline__ void qr_o_wy(int nv, int tld, const float* V,
                                     bool unit, float* M, int b, int rows,
                                     int c0, int c1, float* Top, float* Z) {
  const QrW w = qr_w(b);
  const int tr = (threadIdx.x >> 4) * 4, tc = (threadIdx.x & 15) * 4;
  const int nc = c1 - c0;
  const bool mine = tr < nv && tc < nc;
  P acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[i][k] = Top && mine && tr + i < nv && tc + k < nc
                      ? __ldcg(Top + (size_t)(tr + i) * b + c0 + tc + k)
                      : 0.0f;
  float xv[16], xm[16];
  qr_o_load(xv, V, b, 0, rows, nv, unit);
  qr_o_load(xm, M + c0, b, 0, rows, nc, false);
  for (int t0 = 0; t0 < rows; t0 += QR_MAX_B) {     // W = Top + V^T M
    const int n = (min(QR_MAX_B, rows - t0) + QR_MM_IN - 1) & ~(QR_MM_IN - 1);
    __syncthreads();                     // the slots' last readers are done
    qr_o_store(w.s, xv);
    qr_o_store(w.r, xm);
    __syncthreads();
    if (t0 + QR_MAX_B < rows) {          // the next block's loads in flight
      qr_o_load(xv, V, b, t0 + QR_MAX_B, rows, nv, unit);
      qr_o_load(xm, M + c0, b, t0 + QR_MAX_B, rows, nc, false);
    }
    if (mine) qr_mm_tn4<P>(w.s, QR_WL, w.r, QR_WL, n, tr, tc, acc);
  }
  float x[4][4];
  if (mine) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) x[i][k] = (float)acc[i][k];
    qr_store_block(w.a, QR_WL, x, tr, tc);
  }
  qr_o_load(xv, V, b, 0, rows, nv, unit);  // V X's first block in flight
  __syncthreads();
  if (mine) {
    qr_mm_tn2(w.t, tld, w.a, QR_WL, nv, tr, tc, x);  // X
  } else {                               // X's rows past nv are zero
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) x[i][k] = 0.0f;
  }
  __syncthreads();                       // every read of W is done
  if (Z) {
    if (mine)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (tr + i < nv && tc + k < nc)
            __stcg(Z + (size_t)(c0 + tc + k) * b + tr + i, x[i][k]);
    return;
  }
  qr_store_block(w.a, QR_WL, x, tr, tc);
  if (Top && mine)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (tr + i < nv && tc + k < nc) {
          float* p = Top + (size_t)(tr + i) * b + c0 + tc + k;
          __stcg(p, __ldcg(p) - x[i][k]);
        }
  const int nv4 = (nv + 3) & ~3;
  for (int t0 = 0; t0 < rows; t0 += QR_MAX_B) {     // M -= V X
    __syncthreads();                     // X is in w.a; w.s is free
    qr_o_store(w.s, xv);
    __syncthreads();
    if (t0 + QR_MAX_B < rows)
      qr_o_load(xv, V, b, t0 + QR_MAX_B, rows, nv, unit);
    float* row = M + (size_t)(t0 + tr) * b + c0 + tc;
    float m[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m[i][k] = t0 + tr + i < rows && tc + k < nc
                      ? __ldcg(row + (size_t)i * b + k) : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) x[i][k] = 0.0f;
    qr_mm_nn4<false, float>(w.s, QR_WL, w.a, QR_WL, nv4, tr, tc, x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (t0 + tr + i < rows && tc + k < nc)
          __stcg(row + (size_t)i * b + k, m[i][k] - x[i][k]);
  }
}

// An inner panel's (nb columns J_i = j1 .. j1 + nb - 1, V_i in w.p, T_i in
// w.t at ld tld) block reflector on the rest of its outer panel, columns j0
// .. je - 1 of A's rows r0 .. r0 + rows - 1, in one staged pass:
// W = V_i^T A[r0:, j0:je] (+ Top on the columns right of J_i), X = T_i^T W;
// the columns left of J_i give T[c, J_i] = (Y T_i)[c], Y = V_prev^T V_i
// (qr_w_merge then folds T_i into the outer panel's T); the columns right
// of it take Top -= X and A -= V_i X, as qr_w_chunk does.  Top: tsqrf's
// rows j1 .. of R (ld b), or null.  A function of its own, as qr_o_wy.
__device__ __noinline__ void qr_o_inner(int nb, int tld, float* A, int b,
                                        int r0, int rows, int j0, int j1,
                                        int je, float* Top, float* T) {
  const QrW w = qr_w(b);
  const int tr = (threadIdx.x >> 4) * 4, tc = (threadIdx.x & 15) * 4;
  const int nc = je - j0, jn = j1 + nb - j0;   // right columns: tc + k >= jn
  const bool mine = tr < nb && tc < nc;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[i][k] = Top && mine && tr + i < nb && tc + k < nc && tc + k >= jn
                      ? __ldcg(Top + (size_t)(tr + i) * b + j0 + tc + k)
                      : 0.0f;
  if (b > QR_FLOAT_SUM_MAX_B) {          // W
    double wd[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) wd[i][k] = acc[i][k];
    qr_w_vtm<true, double>(w, A, b, r0, rows, j0, nc, tr, tc, mine, wd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = (float)wd[i][k];
  } else {
    qr_w_vtm<true, float>(w, A, b, r0, rows, j0, nc, tr, tc, mine, acc);
  }
  if (mine) qr_store_block(w.a, QR_WL, acc, tr, tc);
  __syncthreads();
  if (mine) qr_mm_tn2(w.t, tld, w.a, QR_WL, nb, tr, tc, acc);   // X
  __syncthreads();                       // every read of W is done
  if (mine) {
    qr_store_block(w.a, QR_WL, acc, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = tc + k;
        if (tr + i >= nb || c >= nc) continue;
        if (c < j1 - j0) {               // Y T_i into T[c, J_i]
          __stcg(T + (size_t)(j0 + c) * b + j1 + tr + i, acc[i][k]);
        } else if (Top && c >= jn) {
          float* p = Top + (size_t)(tr + i) * b + j0 + c;
          __stcg(p, __ldcg(p) - acc[i][k]);
        }
      }
  }
  __syncthreads();
  if (j0 + tc + 3 < j1 + nb) return;     // none of this thread's columns
  for (int i0 = tr; i0 < rows; i0 += QR_MAX_B) {    // A -= V_i X, right of J_i
    if (tc >= nc) break;
    qr_mm_tn2(w.p + i0, w.pld, w.a, QR_WL, nb, 0, tc, acc);
    float* row = A + (size_t)(r0 + i0) * b + j0 + tc;
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[i][k] = i0 + i < rows && tc + k < nc && tc + k >= jn
                      ? __ldcg(row + i * b + k) : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + i < rows && tc + k < nc && tc + k >= jn)
          __stcg(row + i * b + k, x[i][k] - acc[i][k]);
  }
}

// qr_o_wy with W's call partials in float to QR_FLOAT_SUM_MAX_B, in
// double past it
__device__ __forceinline__ void qr_o_wy_b(int nv, int tld, const float* V,
                                          bool unit, float* M, int b,
                                          int rows, int c0, int c1,
                                          float* Top, float* Z) {
  if (b > QR_FLOAT_SUM_MAX_B)
    qr_o_wy<double>(nv, tld, V, unit, M, b, rows, c0, c1, Top, Z);
  else
    qr_o_wy<float>(nv, tld, V, unit, M, b, rows, c0, c1, Top, Z);
}

// geqrf (TS = false: A -> RV) or tsqrf (TS: [R; A] -> R', V2 in place of
// A) past QR_OUTER_MIN_B, with T and taus (or null) as the bodies above
// write them.  Each outer panel J = j0 .. je - 1: its inner panels (the
// register panels of qr_wide_nb: 4, 2 or 1 columns, a column over
// several warps) factor as in qr_w_fact_panel, but update and merge into
// J alone (qr_o_inner, qr_w_merge from j0); then J's T_J updates the
// columns right of J (qr_o_wy, V_J streamed from A), and the chunks left
// of J give Y T_J for T's merge.
template <bool TS>
__device__ __noinline__ void qr_o_factor(float* R, float* A, float* T,
                                         float* taus, int b) {
  const QrW w = qr_w(b);
  for (int j0 = 0; j0 < b; j0 += QR_MAX_B) {
    const int je = min(j0 + QR_MAX_B, b);
    for (int j1 = j0; j1 < je; j1 += w.nbw) {
      const int nb = min(w.nbw, je - j1), tld = qr_ld(nb);
      const int r0 = TS ? 0 : j1, rows = b - r0;
      float* pa = A + (size_t)r0 * b + j1;
      __syncthreads();                   // the last panel's readers are done
      qr_w_load_panel(w, pa, b, rows, nb, false);
      if (TS) qr_w_load_r(w, R + (size_t)j1 * b + j1, b, nb);
      qr_zero_slot(w.t, nb);
      __syncthreads();
      qr_w_factor_span<TS>(w, rows, nb, tld);      // g > 32 past 1024
      __syncthreads();                   // the panel is back in w.p
      qr_w_store_panel(w, pa, b, rows, nb, !TS);   // RV / V2 out, V in w.p
      if (TS) qr_w_store_r(w, R + (size_t)j1 * b + j1, b, nb);
      if (taus)
        for (int c = threadIdx.x; c < nb; c += QR_THREADS)
          __stcg(taus + j1 + c, w.taus[c]);
      __syncthreads();
      qr_build_t(w.t, w.a, w.taus, w.s, nb);
      qr_w_store_t(w, T, b, j1, nb, tld);
      if (je - j0 > nb)
        qr_o_inner(nb, tld, A, b, r0, rows, j0, j1, je,
                   TS ? R + (size_t)j1 * b : nullptr, T);
      if (j1 > j0) qr_w_merge(w, T, b, j0, j1, nb);
    }
    const int nv = je - j0, tld = qr_ld(nv);
    const int r0 = TS ? 0 : j0, rows = b - r0;
    const float* V = A + (size_t)r0 * b + j0;
    __syncthreads();                     // T_J is in T
    qr_w_load_t(w, T + (size_t)j0 * b + j0, b, nv, tld);
    for (int c = je; c < b; c += QR_MAX_B)       // the trailing columns
      qr_o_wy_b(nv, tld, V, !TS, A + (size_t)r0 * b, b, rows, c,
                min(c + QR_MAX_B, b), TS ? R + (size_t)j0 * b : nullptr,
                nullptr);
    for (int c = 0; c < j0; c += QR_MAX_B)       // Y T_J, Y = V_prev^T V_J
      qr_o_wy_b(nv, tld, V, !TS, A + (size_t)r0 * b, b, rows, c,
                min(c + QR_MAX_B, j0), nullptr, T + j0);
    if (j0 > 0) qr_w_merge(w, T, b, 0, j0, nv);
  }
  __syncthreads();
}

// apply_qt (TS = false: C = M, V_k from RV) or apply_tsqt (TS: Top = C1's
// rows J, M = C2, V_k = V2's columns J) past QR_OUTER_MIN_B on the chunk
// columns chunk * 64 .. + 63 of C, Q_1^T first, T_k the 64 x 64 diagonal
// blocks of T
template <bool TS>
__device__ __forceinline__ void qr_o_apply(const float* V, const float* T,
                                           float* C1, float* C, int b,
                                           int chunk) {
  const QrW w = qr_w(b);
  const int c0 = chunk * QR_MAX_B, c1 = min(c0 + QR_MAX_B, b);
  for (int j0 = 0; j0 < b; j0 += QR_MAX_B) {
    const int nv = min(QR_MAX_B, b - j0), tld = qr_ld(nv);
    const int r0 = TS ? 0 : j0;
    __syncthreads();                     // the last block's readers are done
    qr_w_load_t(w, T + (size_t)j0 * b + j0, b, nv, tld);
    qr_o_wy_b(nv, tld, V + (size_t)r0 * b + j0, !TS, C + (size_t)r0 * b, b,
              b - r0, c0, c1, TS ? C1 + (size_t)j0 * b : nullptr, nullptr);
  }
  __syncthreads();
}

// GEQRF, b > QR_MAX_B: A -> RV in place, T, taus (b floats, or null).
// The block's dynamic shared memory holds qr_wide_floats(b) floats.
__device__ __noinline__ void geqrf_wide(float* A, float* T, float* taus,
                                        int b) {
  const QrW w = qr_w(b);
  for (int j0 = 0; j0 < b; j0 += w.nbw) {
    const int nb = min(w.nbw, b - j0);
    __syncthreads();                     // the last panel's readers are done
    QR_STAMP(0);
    qr_w_load_panel(w, A + (size_t)j0 * b + j0, b, b - j0, nb, false);
    qr_zero_slot(w.t, nb);
    __syncthreads();
    qr_w_fact_panel<false>(w, nullptr, A, T, taus, j0, b);
  }
  __syncthreads();
}

// TSQRF, b > QR_MAX_B: [R; A] -> R' (upper triangle of R in place; the
// strict lower part is neither read nor written), V2 in place of A, T,
// taus (or null).
__device__ __noinline__ void tsqrf_wide(float* R, float* A, float* T,
                                        float* taus, int b) {
  const QrW w = qr_w(b);
  for (int j0 = 0; j0 < b; j0 += w.nbw) {
    const int nb = min(w.nbw, b - j0);
    __syncthreads();
    QR_STAMP(0);
    qr_w_load_panel(w, A + j0, b, b, nb, false);
    qr_w_load_r(w, R + (size_t)j0 * b + j0, b, nb);
    qr_zero_slot(w.t, nb);
    __syncthreads();
    qr_w_fact_panel<true>(w, R, A, T, taus, j0, b);
  }
  __syncthreads();
}

// The factorizations every entry point runs past QR_MAX_B: the outer
// panels past QR_OUTER_MIN_B, geqrf_wide / tsqrf_wide (which take any b)
// up to it.  The choice stays out of those bodies, whose registers it
// would change at b <= 1024 (a call inside them made their column steps
// spill: +3 % at b = 128).
__device__ __forceinline__ void geqrf_blocked(float* A, float* T,
                                              float* taus, int b) {
  if (b > QR_OUTER_MIN_B)
    qr_o_factor<false>(nullptr, A, T, taus, b);
  else
    geqrf_wide(A, T, taus, b);
}

__device__ __forceinline__ void tsqrf_blocked(float* R, float* A, float* T,
                                              float* taus, int b) {
  if (b > QR_OUTER_MIN_B)
    qr_o_factor<true>(R, A, T, taus, b);
  else
    tsqrf_wide(R, A, T, taus, b);
}

// LARFT apply, b > QR_MAX_B: C <- Q^T C, Q = Q_1 Q_2 ... the panels'
// block reflectors (V_k from the unit-lower part of RV, T_k the diagonal
// blocks of T), Q_1^T first.  Past QR_OUTER_MIN_B on the 64 columns of C
// from chunk * 64 (chunk < qr_apply_chunks(b)), else on all of C (chunk 0).
__device__ __noinline__ void apply_qt_wide(const float* RV, const float* T,
                                           float* C, int b, int chunk) {
  if (b > QR_OUTER_MIN_B) {
    qr_o_apply<false>(RV, T, nullptr, C, b, chunk);
    return;
  }
  const QrW w = qr_w(b);
  for (int j0 = 0; j0 < b; j0 += w.nbw) {
    const int nb = min(w.nbw, b - j0), tld = qr_ld(nb);
    __syncthreads();
    qr_w_load_panel(w, RV + (size_t)j0 * b + j0, b, b - j0, nb, true);
    qr_w_load_t(w, T + (size_t)j0 * b + j0, b, nb, tld);
    __syncthreads();
    QR_STAMP(8);
    for (int c = 0; c < b; c += QR_MAX_B)
      qr_w_chunk(w, nb, tld, C, b, j0, b - j0, c, min(c + QR_MAX_B, b),
                 nullptr, nullptr);
  }
  __syncthreads();
}

// SSRFT apply, b > QR_MAX_B: [C1; C2] <- Q^T [C1; C2] panel by panel: W =
// C1[J, :] + V2_k^T C2; X = T_k^T W; C1[J, :] -= X; C2 -= V2_k X.  Past
// QR_OUTER_MIN_B on the chunk's 64 columns of C1 and C2, as apply_qt_wide.
__device__ __noinline__ void apply_tsqt_wide(const float* V2, const float* T,
                                             float* C1, float* C2, int b,
                                             int chunk) {
  if (b > QR_OUTER_MIN_B) {
    qr_o_apply<true>(V2, T, C1, C2, b, chunk);
    return;
  }
  const QrW w = qr_w(b);
  for (int j0 = 0; j0 < b; j0 += w.nbw) {
    const int nb = min(w.nbw, b - j0), tld = qr_ld(nb);
    __syncthreads();
    qr_w_load_panel(w, V2 + j0, b, b, nb, false);
    qr_w_load_t(w, T + (size_t)j0 * b + j0, b, nb, tld);
    __syncthreads();
    QR_STAMP(8);
    for (int c = 0; c < b; c += QR_MAX_B)
      qr_w_chunk(w, nb, tld, C2, b, 0, b, c, min(c + QR_MAX_B, b),
                 C1 + (size_t)j0 * b, nullptr);
  }
  __syncthreads();
}
