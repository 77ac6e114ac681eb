// Tile kernels of the tiled QR (paper §4.1) as device functions, one (b,b)
// float32 tile per thread block, b <= 64.
//
// Replaces the bodies of the TPU kernels in src/repro/kernels/qr_tile/
// kernel.py: geqrf_math, tsqrf_math, apply_qt_math and apply_tsqt_math.
// The per-op kernels and the task-table walk (qr_tile.cu) call these same
// functions, which are __noinline__ so that every entry point runs one
// compiled copy of the arithmetic: with the same blockDim the four
// execution modes are bitwise equal on the card, as they are in the
// reference.  Every reduction has a fixed order (a per-lane strided sum,
// then a shuffle tree read from lane 0), so a result never depends on
// scheduling.
//
// Layout: tiles live in shared memory row-major with leading dimension
// ld = b + 1; the pad puts the elements of a column in distinct banks, so
// the column walks of the panel factorizations are free of bank conflicts.
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
#define QR_MAX_B 64      // six padded fp32 tiles fit the 227 KB of smem
#define QR_TILES 6       // shared-memory tile slots of every kernel

// floats of dynamic shared memory every entry point takes for tile size b:
// QR_TILES padded tiles, then three b-vectors and four scalars
__host__ __device__ inline int qr_smem_floats(int b) {
  return QR_TILES * b * (b + 1) + 3 * b + 4;
}

// lane 0 holds the sum of x over the warp, in a fixed order
__device__ __forceinline__ float qr_warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Householder scalars for pivot alpha and below-pivot squared norm sigma2,
// with the reference's guards: sigma2 == 0 gives tau = 0 and inv = 0, and
// a zero denominator is replaced by 1 (kernel.py::_householder).
__device__ __forceinline__ void qr_householder(float alpha, float sigma2,
                                               float* sc) {
  if (sigma2 == 0.0f) {
    sc[0] = alpha;
    sc[1] = 0.0f;
    sc[2] = 0.0f;
    return;
  }
  const float sign = alpha >= 0.0f ? 1.0f : -1.0f;
  const float beta = -sign * sqrtf(alpha * alpha + sigma2);
  const float denom = alpha - beta;
  sc[0] = beta;
  sc[1] = (beta - alpha) / beta;
  sc[2] = 1.0f / (denom == 0.0f ? 1.0f : denom);
}

// d[m] = sum_{i >= i0} v[i] X[i][m] for every column m != skip, one warp
// per column (lanes stride the rows, lane 0 stores)
__device__ __forceinline__ void qr_col_dots(const float* X, const float* v,
                                            float* d, int i0, int skip,
                                            int b) {
  const int ld = b + 1;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int m = threadIdx.x >> 5; m < b; m += nw) {
    if (m == skip) continue;
    float s = 0.0f;
    for (int i = i0 + lane; i < b; i += 32) s = fmaf(v[i], X[i * ld + m], s);
    s = qr_warp_sum(s);
    if (lane == 0) d[m] = s;
  }
}

// T[r][j] = -tau * sum_{r <= c < j} T[r][c] u[c] for r < j; T[j][j] = tau
__device__ __forceinline__ void qr_t_column(float* T, const float* u,
                                            float tau, int j, int b) {
  const int ld = b + 1;
  for (int r = threadIdx.x; r < j; r += blockDim.x) {
    float s = 0.0f;
    for (int c = r; c < j; ++c) s = fmaf(T[r * ld + c], u[c], s);
    T[r * ld + j] = -tau * s;
  }
  if (threadIdx.x == 0) T[j * ld + j] = tau;
}

__device__ __forceinline__ void qr_zero_tile(float* X, int b) {
  for (int e = threadIdx.x; e < b * (b + 1); e += blockDim.x) X[e] = 0.0f;
}

// GEQRF: A (b,b) -> RV in place, T, taus.  v, d: b floats; sc: 4 floats.
__device__ __noinline__ void geqrf_tile(float* A, float* T, float* taus,
                                        float* v, float* d, float* sc,
                                        int b) {
  const int ld = b + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  qr_zero_tile(T, b);
  for (int j = 0; j < b; ++j) {
    if (tid < 32) {                        // sigma2 over rows below j
      float s = 0.0f;
      for (int i = j + 1 + tid; i < b; i += 32) {
        const float x = A[i * ld + j];
        s = fmaf(x, x, s);
      }
      s = qr_warp_sum(s);
      if (tid == 0) qr_householder(A[j * ld + j], s, sc);
    }
    __syncthreads();
    const float tau = sc[1], inv = sc[2];
    for (int i = tid; i < b; i += nt)
      v[i] = i < j ? 0.0f : (i == j ? 1.0f : A[i * ld + j] * inv);
    __syncthreads();
    // d[m]: V^T v for m < j (the T recurrence), v^T A for m > j
    qr_col_dots(A, v, d, j, j, b);
    __syncthreads();
    const int w = b - j;                   // rows j.., columns j..
    for (int e = tid; e < w * w; e += nt) {
      const int i = j + e / w, m = j + e % w;
      if (m > j)
        A[i * ld + m] = fmaf(-v[i], tau * d[m], A[i * ld + m]);
      else
        A[i * ld + j] = i == j ? sc[0] : v[i];
    }
    qr_t_column(T, d, tau, j, b);
    if (tid == 0) taus[j] = tau;
    __syncthreads();
  }
}

// TSQRF: [R; A] -> R' (upper triangle of R in place), V2 in place of A,
// T, taus.  v, d: b floats; sc: 4 floats.
__device__ __noinline__ void tsqrf_tile(float* R, float* A, float* T,
                                        float* taus, float* v, float* d,
                                        float* sc, int b) {
  const int ld = b + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  qr_zero_tile(T, b);
  for (int j = 0; j < b; ++j) {
    if (tid < 32) {                        // sigma2 over the dense column
      float s = 0.0f;
      for (int i = tid; i < b; i += 32) {
        const float x = A[i * ld + j];
        s = fmaf(x, x, s);
      }
      s = qr_warp_sum(s);
      if (tid == 0) qr_householder(R[j * ld + j], s, sc);
    }
    __syncthreads();
    const float tau = sc[1], inv = sc[2];
    for (int i = tid; i < b; i += nt) v[i] = A[i * ld + j] * inv;
    __syncthreads();
    // d[m]: V2^T v for m < j (columns before j hold V2), v^T A for m > j
    qr_col_dots(A, v, d, 0, j, b);
    __syncthreads();
    for (int m = j + 1 + tid; m < b; m += nt) d[m] += R[j * ld + m];  // w
    __syncthreads();
    const int w = b - j;                   // all rows, columns j..
    for (int e = tid; e < b * w; e += nt) {
      const int i = e / w, m = j + e % w;
      A[i * ld + m] = m > j ? fmaf(-tau, v[i] * d[m], A[i * ld + m]) : v[i];
    }
    for (int m = j + tid; m < b; m += nt)
      R[j * ld + m] = m > j ? fmaf(-tau, d[m], R[j * ld + m]) : sc[0];
    qr_t_column(T, d, tau, j, b);
    if (tid == 0) taus[j] = tau;
    __syncthreads();
  }
}

// LARFT apply: C <- C - V (T^T (V^T C)), V the unit-lower part of RV.
// W1, W2: scratch tiles.
__device__ __noinline__ void apply_qt_tile(const float* RV, const float* T,
                                           float* C, float* W1, float* W2,
                                           int b) {
  const int ld = b + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < b * b; e += nt) {  // W1 = V^T C
    const int c = e / b, m = e % b;
    float s = C[c * ld + m];
    for (int i = c + 1; i < b; ++i) s = fmaf(RV[i * ld + c], C[i * ld + m], s);
    W1[c * ld + m] = s;
  }
  __syncthreads();
  for (int e = tid; e < b * b; e += nt) {  // W2 = T^T W1
    const int r = e / b, m = e % b;
    float s = 0.0f;
    for (int c = 0; c <= r; ++c) s = fmaf(T[c * ld + r], W1[c * ld + m], s);
    W2[r * ld + m] = s;
  }
  __syncthreads();
  for (int e = tid; e < b * b; e += nt) {  // C -= V W2
    const int i = e / b, m = e % b;
    float s = W2[i * ld + m];
    for (int c = 0; c < i; ++c) s = fmaf(RV[i * ld + c], W2[c * ld + m], s);
    C[i * ld + m] -= s;
  }
  __syncthreads();
}

// SSRFT apply: W = T^T (C1 + V2^T C2); C1 -= W; C2 -= V2 W.
// W, X: scratch tiles.
__device__ __noinline__ void apply_tsqt_tile(const float* V2, const float* T,
                                             float* C1, float* C2, float* W,
                                             float* X, int b) {
  const int ld = b + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < b * b; e += nt) {  // W = C1 + V2^T C2
    const int c = e / b, m = e % b;
    float s = 0.0f;
    for (int i = 0; i < b; ++i) s = fmaf(V2[i * ld + c], C2[i * ld + m], s);
    W[c * ld + m] = C1[c * ld + m] + s;
  }
  __syncthreads();
  for (int e = tid; e < b * b; e += nt) {  // X = T^T W
    const int r = e / b, m = e % b;
    float s = 0.0f;
    for (int c = 0; c <= r; ++c) s = fmaf(T[c * ld + r], W[c * ld + m], s);
    X[r * ld + m] = s;
  }
  __syncthreads();
  for (int e = tid; e < b * b; e += nt) {  // C1 -= X; C2 -= V2 X
    const int i = e / b, m = e % b;
    float s = 0.0f;
    for (int c = 0; c < b; ++c) s = fmaf(V2[i * ld + c], X[c * ld + m], s);
    C1[i * ld + m] -= X[i * ld + m];
    C2[i * ld + m] -= s;
  }
  __syncthreads();
}
