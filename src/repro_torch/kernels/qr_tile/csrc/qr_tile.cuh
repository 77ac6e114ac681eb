// Tile kernels of the tiled QR (paper §4.1) as device functions, one (b,b)
// float32 tile per thread block of QR_THREADS threads.  Tiles of b <= 64
// (QR_MAX_B) run the shared-memory bodies below; wider tiles run the
// global-memory bodies at the end of this file (qr_*_wide).
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

__host__ __device__ inline int qr_ld(int b) { return (b + 23) / 32 * 32 + 8; }
__host__ __device__ inline int qr_rows(int b) { return (b + 3) & ~3; }
__host__ __device__ inline int qr_slot_floats(int b) {
  return qr_rows(b) * qr_ld(b);
}

// floats of dynamic shared memory every entry point takes for tile size b:
// QR_TILES tile slots, two Householder-vector buffers and the taus; above
// QR_MAX_B only the wide bodies' reduction buffer
__host__ __device__ inline int qr_smem_floats(int b) {
  return b > QR_MAX_B ? QR_WARPS
                      : QR_TILES * qr_slot_floats(b) + 3 * QR_MAX_B;
}

// floats of global scratch one block of a wide body (b > QR_MAX_B) takes:
// a b x b tile W, a b-vector u and the b taus
__host__ __device__ inline size_t qr_wide_floats(int b) {
  return (size_t)b * b + 2 * (size_t)b;
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
// b > QR_MAX_B: the four ops on tiles in global memory (row-major, leading
// dimension b), a simple form.  Six 128^2 tiles are 384 KB, beyond the
// 227 KB of shared memory a block may have, so the operands stay where they
// lie and the wrapper gives each block qr_wide_floats(b) floats of global
// scratch (W, u, taus).  A panel's column j: sigma^2 by a block reduction
// in a fixed order, the Householder scalars by every thread from the same
// bits (with the reference's guards, qr_householder), then one thread a
// trailing column takes its dot and its update down the rows; T is built
// after the loop a column at a time from the Gram column u = V^T v_j.  The
// applies give each thread one column of C: every column is independent,
// so the three products run without a barrier.  Every tile load and store
// goes past L1 (__ldcg / __stcg): in the walk another SM may have written
// the tile in an earlier phase, and L1 is not coherent across SMs.  Each
// result depends only on b and blockDim, never on gridDim or on the block.

__device__ __forceinline__ float qr_gl(const float* p) { return __ldcg(p); }
__device__ __forceinline__ void qr_gs(float* p, float x) { __stcg(p, x); }

// sum of every thread's x over the block in a fixed order (a butterfly in
// each warp, then the warps' sums 0, 1, ...); every thread gets the same
// bits.  red: QR_WARPS floats of shared memory.
__device__ __forceinline__ float qr_block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();                       // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < QR_WARPS; ++w) s += red[w];
  return s;
}

// T (b x b, upper triangular, zero below) from the reflectors V and taus:
// T[:j, j] = -tau_j T[:j, :j] u, u = V[:, :j]^T v_j, T[j][j] = tau_j.  TS:
// V is V2, dense (tsqrf: the top identity blocks add nothing to u); else V
// is the strict lower part of A with a unit diagonal (geqrf).  Thread c
// owns row c of T.  u: b floats of scratch.
template <bool TS>
__device__ __forceinline__ void qr_build_t_wide(const float* V, float* T,
                                                const float* taus, float* u,
                                                int b) {
  const int tid = threadIdx.x;
  for (int j = 0; j < b; ++j) {
    for (int c = tid; c < j; c += QR_THREADS) {
      float s = TS ? 0.0f : qr_gl(V + (size_t)j * b + c);   // v_c[j] * 1
      for (int i = TS ? 0 : j + 1; i < b; ++i)
        s = fmaf(qr_gl(V + (size_t)i * b + c), qr_gl(V + (size_t)i * b + j),
                 s);
      qr_gs(u + c, s);
    }
    __syncthreads();
    const float tj = qr_gl(taus + j);
    for (int c = tid; c < b; c += QR_THREADS) {
      float x = c == j ? tj : 0.0f;
      if (c < j) {
        float s = 0.0f;
        for (int k = c; k < j; ++k)
          s = fmaf(qr_gl(T + (size_t)c * b + k), qr_gl(u + k), s);
        x = -tj * s;
      }
      qr_gs(T + (size_t)c * b + j, x);
    }
    __syncthreads();                     // u is read before it is rewritten
  }
}

// GEQRF, b > QR_MAX_B: A -> RV in place, T, taus (b floats).  u: b
// floats of scratch; red: QR_WARPS floats of shared memory.
__device__ __noinline__ void geqrf_wide(float* A, float* T, float* taus,
                                        float* u, float* red, int b) {
  const int tid = threadIdx.x;
  for (int j = 0; j < b; ++j) {
    float s = 0.0f;
    for (int i = j + 1 + tid; i < b; i += QR_THREADS) {
      const float x = qr_gl(A + (size_t)i * b + j);
      s = fmaf(x, x, s);
    }
    const float sigma2 = qr_block_sum(s, red);
    const QrHouse h = qr_householder(qr_gl(A + (size_t)j * b + j), sigma2);
    for (int i = j + 1 + tid; i < b; i += QR_THREADS) {   // v below row j
      float* p = A + (size_t)i * b + j;
      qr_gs(p, qr_gl(p) * h.inv);
    }
    if (tid == 0) qr_gs(taus + j, h.tau);
    __syncthreads();
    for (int m = j + 1 + tid; m < b; m += QR_THREADS) {   // trailing columns
      float* aj = A + (size_t)j * b + m;
      float w = qr_gl(aj);                                // v_j = 1
      for (int i = j + 1; i < b; ++i)
        w = fmaf(qr_gl(A + (size_t)i * b + j), qr_gl(A + (size_t)i * b + m),
                 w);
      const float tw = h.tau * w;
      qr_gs(aj, qr_gl(aj) - tw);
      for (int i = j + 1; i < b; ++i) {
        float* p = A + (size_t)i * b + m;
        qr_gs(p, fmaf(-qr_gl(A + (size_t)i * b + j), tw, qr_gl(p)));
      }
    }
    if (tid == 0) qr_gs(A + (size_t)j * b + j, h.beta);
    __syncthreads();
  }
  qr_build_t_wide<false>(A, T, taus, u, b);
}

// TSQRF, b > QR_MAX_B: [R; A] -> R' (upper triangle of R in place; the
// strict lower part is neither read nor written), V2 in place of A, T,
// taus.  u: b floats of scratch; red: QR_WARPS floats of shared memory.
__device__ __noinline__ void tsqrf_wide(float* R, float* A, float* T,
                                        float* taus, float* u, float* red,
                                        int b) {
  const int tid = threadIdx.x;
  for (int j = 0; j < b; ++j) {
    float s = 0.0f;
    for (int i = tid; i < b; i += QR_THREADS) {
      const float x = qr_gl(A + (size_t)i * b + j);
      s = fmaf(x, x, s);
    }
    const float sigma2 = qr_block_sum(s, red);
    const QrHouse h = qr_householder(qr_gl(R + (size_t)j * b + j), sigma2);
    for (int i = tid; i < b; i += QR_THREADS) {           // v2 in column j
      float* p = A + (size_t)i * b + j;
      qr_gs(p, qr_gl(p) * h.inv);
    }
    if (tid == 0) qr_gs(taus + j, h.tau);
    __syncthreads();
    for (int m = j + 1 + tid; m < b; m += QR_THREADS) {
      float* rj = R + (size_t)j * b + m;
      const float rpm = qr_gl(rj);
      float w = rpm;                     // w = R[j][m] + v2 . A[:, m]
      for (int i = 0; i < b; ++i)
        w = fmaf(qr_gl(A + (size_t)i * b + j), qr_gl(A + (size_t)i * b + m),
                 w);
      qr_gs(rj, fmaf(-h.tau, w, rpm));
      for (int i = 0; i < b; ++i) {
        float* p = A + (size_t)i * b + m;
        qr_gs(p, fmaf(-h.tau, qr_gl(A + (size_t)i * b + j) * w, qr_gl(p)));
      }
    }
    if (tid == 0) qr_gs(R + (size_t)j * b + j, h.beta);
    __syncthreads();
  }
  qr_build_t_wide<true>(A, T, taus, u, b);
}

// w <- T^T w for the column m of W (T upper triangular), in place from
// the bottom row up: row r needs w[0 .. r] only
__device__ __forceinline__ void qr_tt_column(const float* T, float* W, int m,
                                             int b) {
  for (int r = b - 1; r >= 0; --r) {
    float s = 0.0f;
    for (int k = 0; k <= r; ++k)
      s = fmaf(qr_gl(T + (size_t)k * b + r), qr_gl(W + (size_t)k * b + m), s);
    qr_gs(W + (size_t)r * b + m, s);
  }
}

// LARFT apply, b > QR_MAX_B: C <- C - V (T^T (V^T C)), V the unit-lower
// part of RV (read only).  W: b x b scratch; thread m owns column m.
__device__ __noinline__ void apply_qt_wide(const float* RV, const float* T,
                                           float* C, float* W, int b) {
  for (int m = threadIdx.x; m < b; m += QR_THREADS) {
    for (int k = 0; k < b; ++k) {        // W = V^T C
      float s = qr_gl(C + (size_t)k * b + m);
      for (int i = k + 1; i < b; ++i)
        s = fmaf(qr_gl(RV + (size_t)i * b + k), qr_gl(C + (size_t)i * b + m),
                 s);
      qr_gs(W + (size_t)k * b + m, s);
    }
    qr_tt_column(T, W, m, b);            // W <- T^T W
    for (int i = 0; i < b; ++i) {        // C -= V W
      float s = qr_gl(W + (size_t)i * b + m);
      for (int k = 0; k < i; ++k)
        s = fmaf(qr_gl(RV + (size_t)i * b + k), qr_gl(W + (size_t)k * b + m),
                 s);
      float* p = C + (size_t)i * b + m;
      qr_gs(p, qr_gl(p) - s);
    }
  }
  __syncthreads();
}

// SSRFT apply, b > QR_MAX_B: W = T^T (C1 + V2^T C2); C1 -= W; C2 -= V2 W.
// W: b x b scratch; thread m owns column m.
__device__ __noinline__ void apply_tsqt_wide(const float* V2, const float* T,
                                             float* C1, float* C2, float* W,
                                             int b) {
  for (int m = threadIdx.x; m < b; m += QR_THREADS) {
    for (int k = 0; k < b; ++k) {        // W = C1 + V2^T C2
      float s = 0.0f;
      for (int i = 0; i < b; ++i)
        s = fmaf(qr_gl(V2 + (size_t)i * b + k), qr_gl(C2 + (size_t)i * b + m),
                 s);
      qr_gs(W + (size_t)k * b + m, qr_gl(C1 + (size_t)k * b + m) + s);
    }
    qr_tt_column(T, W, m, b);            // X = T^T W
    for (int k = 0; k < b; ++k) {        // C1 -= X
      float* p = C1 + (size_t)k * b + m;
      qr_gs(p, qr_gl(p) - qr_gl(W + (size_t)k * b + m));
    }
    for (int i = 0; i < b; ++i) {        // C2 -= V2 X
      float s = 0.0f;
      for (int k = 0; k < b; ++k)
        s = fmaf(qr_gl(V2 + (size_t)i * b + k), qr_gl(W + (size_t)k * b + m),
                 s);
      float* p = C2 + (size_t)i * b + m;
      qr_gs(p, qr_gl(p) - s);
    }
  }
  __syncthreads();
}
