// K12, attention with an online softmax (flash attention), causal or not,
// for sm_90a.  Built by repro_torch/_build.py and bound with ctypes by
// repro_torch/kernels/flash_attention/kernel.py; each launcher returns
// cudaGetLastError() of its launch.
//
// It replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (_fa_kernel).  The Pallas kernel ran one program per (batch-head, query
// tile), in order on one TPU core, holding the whole (Sk, hd) K and V of
// its batch-head in VMEM, and walked the keys a block_k slice at a time
// with the online softmax (m, l, acc).  Here one block serves one
// (batch-head, query tile), all of them in parallel, and K and V stream
// through shared memory a key tile at a time.  The tiles are the kernel's
// own: the caller's block_q and block_k only decide the reference's tiling
// (kernel.py checks that they divide Sq and Sk, as the reference asserts),
// and this kernel masks its own ragged edges: keys >= Sk are -inf, rows
// >= Sq are not stored, columns >= hd are zero on load and not stored.
// The width HD is the next one built (32, 64, 96, 128, 192, 256) at or
// above the true hd, and above 256 the chunked path below; the scale is
// the true hd's, an argument.
//
// bf16 (fa_mma_kernel): the tensor-core design.
//   * A block is 8 warps; warp w owns query rows 16w .. 16w + 15 of the
//     block's tile (BQ = 128 rows), and key tiles are BK = 64.
//   * q.k^T and p.v run as bf16 mma.sync.m16n8k16 with float
//     accumulation, fed by ldmatrix (.trans for V) from shared memory whose
//     rows are padded by 16 bytes, so the 8 row addresses of an ldmatrix
//     fall in 8 distinct bank groups.
//   * Q is loaded once and stays in shared memory for the whole walk; its
//     fragments are re-read by ldmatrix each key tile, which leaves the
//     registers (at most 128 a thread for HD <= 128) to the accumulators,
//     so two blocks fit an SM.  Holding Q in registers took over 200 a
//     thread, one block an SM, and was slower at the timed shape (H100).
//   * K and V stream by cp.async (16 bytes a thread, zero-filled past Sk
//     and hd) into a ring of two stages: tile j + 1 loads while tile j is
//     computed, with one block barrier a key tile.
//   * The online-softmax state (m, l) and the output accumulator stay in
//     registers in the mma fragment layout: each thread holds two rows'
//     state; row maxima reduce over the quad of threads sharing a row by
//     two shuffles, row sums once at the end.  The score accumulator turns
//     into the A fragments of p.v in registers (FA2's layout identity).
//   * With causal masking only the tiles that cross the diagonal (or Sk)
//     are masked element by element; tiles wholly left of it take no mask
//     and tiles wholly right of it are skipped (p would be exactly 0).
//     A warp whose 16 rows all lie left of a tile's first key skips it.
//     The grid's slow axis is the query tile, reversed, so the most
//     expensive tiles (the triangle's long rows) are issued first.
//   Numerics: bf16 x bf16 products are exact in float, so q.k^T is the
//   reference's function (preferred_element_type float32).  p is rounded
//   to bf16 for the p.v product, as FA2/FA3 and SDPA do; l sums the
//   unrounded p.  kernel.py and chip_smoke.py hold the result to the
//   reference's bf16 tolerance (2e-2) and, at S 4096, every row to 2e-2
//   relative; PERF.md gives the measured error.
//
// float32 (fa_kernel): TF32 stays off (the port's parity rule), so float
// inputs take a CUDA-core kernel: one block of 16 x 16 threads per
// (batch-head, 64-row query tile), K and V staged as float through shared
// memory a 64-key tile at a time, the products and the online softmax in
// float, the same masking, skipping and tile order.
//
// hd > 256, float32 or bf16: the same CUDA-core kernel at HD 256 over
// chunks of the head.  q.k^T is summed over head-dim chunks of 256, Q and
// K staged chunk by chunk; the output's columns are split in chunks of
// 256 across the grid's z axis, and each chunk's block recomputes the
// scores.  bf16 is widened to float on staging and rounded once on the
// store.  It is slow by about the chunk count squared; no configuration
// of the repo goes above hd 192, and no model path calls the op.
//
// What bounds it: at S = 4096, hd = 128, causal, bf16 (the timed shape)
// the operations, 68.7 GFLOP, take 0.069 ms at the card's bf16 tensor-core
// rate (989 TFLOP/s); the 16.8 MB of q, k, v and o take 0.005 ms.  mma.sync
// reaches only part of that rate (wgmma, warpgroup tiles and TMA are the
// next step); the design keeps the tensor cores fed: two blocks of 8 warps
// fit an SM at HD 128 (104 KB of shared memory each), and the loads of
// the next key tile overlap the products of this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int FA_THREADS = 256;   // float kernel: a 16 x 16 thread grid
constexpr int F32_BQ = 64, F32_BK = 64;
constexpr int MMA_WARPS = 8;      // bf16 kernel: warps a block, 16 rows each
constexpr int MMA_BQ = 16 * MMA_WARPS, MMA_BK = 64;   // rows, keys a tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel

template <int HD>
constexpr int f32_smem_bytes() {
  return (F32_BQ * (HD + 1) + F32_BK * (HD + 1) + F32_BQ * (F32_BK + 1)) * 4;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows r0 .. r0 + ROWS - 1, head columns c0 .. c0 + HD - 1 of a (n_rows,
// hd) matrix into a ROWS x QP float tile, zero past n_rows and hd
template <int ROWS, int HD, typename T>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, int r0,
                                          int n_rows, int c0, int hd,
                                          int tid) {
  constexpr int QP = HD + 1;
  for (int e = tid; e < ROWS * HD; e += FA_THREADS) {
    const int r = e / HD, c = e % HD;
    dst[r * QP + c] = (r0 + r < n_rows && c0 + c < hd)
                          ? to_float(src[(int64_t)(r0 + r) * hd + c0 + c])
                          : 0.f;
  }
}

// HD is the width of one head-dim chunk: hd <= HD takes one chunk (Q
// staged once); hd > HD sums q.k^T over (hd + HD - 1) / HD chunks and
// writes output columns blockIdx.z * HD ..
template <int HD, typename T>
__global__ void __launch_bounds__(FA_THREADS, 1)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
          int hd, int causal, float scale) {
  constexpr int BQ = F32_BQ, BK = F32_BK;
  constexpr int QP = HD + 1, PP = BK + 1;           // padded row strides
  constexpr int RI = BQ / 16, CJ = BK / 16, DJ = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // BQ x QP: the query tile
  float* kv = qs + BQ * QP;      // BK x QP: the K tile, then the V tile
  float* ps = kv + BK * QP;      // BQ x PP: the tile's softmax weights
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nc = (hd + HD - 1) / HD, c_out = blockIdx.z * HD;
  const T* qb = q + (int64_t)bh * sq * hd;
  const T* kb = k + (int64_t)bh * sk * hd;
  const T* vb = v + (int64_t)bh * sk * hd;

  if (nc == 1) stage_f32<BQ, HD>(qs, qb, q0, sq, 0, hd, tid);
  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DJ; ++d) acc[i][d] = 0.f;
  }
  int nk = (sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) s[i][c] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      __syncthreads();   // the last reads of kv (and of qs) are done
      if (nc > 1) stage_f32<BQ, HD>(qs, qb, q0, sq, cc * HD, hd, tid);
      stage_f32<BK, HD>(kv, kb, k0, sk, cc * HD, hd, tid);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[RI], b[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = qs[(ty + 16 * i) * QP + d];
#pragma unroll
        for (int c = 0; c < CJ; ++c) b[c] = kv[(tx + 16 * c) * QP + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < CJ; ++c) s[i][c] = fmaf(a[i], b[c], s[i][c]);
      }
    }
    const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int col = k0 + tx + 16 * c;
        float val = s[i][c] * scale;
        if (masked && (col >= sk || (causal && row < col))) val = NEG_INF;
        s[i][c] = val;
        mx = fmaxf(mx, val);
      }
      // the row's 16 threads are 16 neighbouring lanes of one warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float p = expf(s[i][c] - mx);
        ps[(ty + 16 * i) * PP + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float alpha = expf(m[i] - mx);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int d = 0; d < DJ; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();   // K reads done, p written
    stage_f32<BK, HD>(kv, vb, k0, sk, c_out, hd, tid);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int d = 0; d < DJ; ++d) vv[d] = kv[c * QP + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int d = 0; d < DJ; ++d) acc[i][d] = fmaf(p[i], vv[d], acc[i][d]);
    }
  }
  T* ob = o + (int64_t)bh * sq * hd;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < DJ; ++d) {
      const int col = c_out + tx + 16 * d;
      if (row < sq && col < hd)
        store_as(ob + (int64_t)row * hd + col, acc[i][d] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes past src_bytes are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, float) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (ex2.approx, relative error ~2^-22),
// without exp2f's care for denormal results (a p that small adds nothing
// beside the row's largest, which is 1); ex2.approx(-inf) is +0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows r0 .. r0 + ROWS - 1 of a (n_rows, hd) matrix into a ROWS x (HD + 8)
// tile, zero past n_rows and hd: by cp.async when every row starts on 16
// bytes (vec), element by element otherwise
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int n_rows, int hd, bool vec,
                                          int tid) {
  constexpr int LD = HD + 8, CPR = HD / 8;
  if (vec) {
#pragma unroll
    for (int i = tid; i < ROWS * CPR; i += NT) {
      const int r = i / CPR, c = i % CPR;
      const bool in = r0 + r < n_rows && c * 8 < hd;
      cp_async16(dst + r * LD + c * 8,
                 in ? src + (int64_t)(r0 + r) * hd + c * 8 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * HD; i += NT) {
      const int r = i / HD, c = i % HD;
      dst[r * LD + c] = (r0 + r < n_rows && c < hd)
                            ? src[(int64_t)(r0 + r) * hd + c]
                            : __float2bfloat16(0.f);
    }
  }
}

template <int HD>
constexpr int mma_smem_bytes() {
  return (MMA_BQ + 4 * MMA_BK) * (HD + 8) * 2;
}

// two blocks an SM up to HD 128 (the accumulators then fit 128 registers)
template <int HD>
__global__ void __launch_bounds__(MMA_WARPS * 32, HD <= 128 ? 2 : 1)
fa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int sq,
              int sk, int hd, int causal, int vec, float scale) {
  constexpr int NT = MMA_WARPS * 32, BQ = MMA_BQ, BK = MMA_BK;
  constexpr int LD = HD + 8;          // padded row: 16 bytes a row apart
  constexpr int KS = HD / 16;         // k-steps of q.k^T
  constexpr int NS = BK / 8;          // score n-tiles a warp
  constexpr int ND = HD / 8;          // output n-tiles a warp
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fa_smem);   // BQ x LD
  bf16* ks = qs + BQ * LD;                        // 2 stages of BK x LD
  bf16* vs = ks + 2 * BK * LD;                    // 2 stages of BK x LD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;         // fragment row, column
  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const bf16* qb = q + (int64_t)bh * sq * hd;
  const bf16* kb = k + (int64_t)bh * sk * hd;
  const bf16* vb = v + (int64_t)bh * sk * hd;
  int nk = (sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  load_tile<BQ, HD, NT>(qs, qb, q0, sq, hd, vec, tid);
  if (nk > 0) {
    load_tile<BK, HD, NT>(ks, kb, 0, sk, hd, vec, tid);
    load_tile<BK, HD, NT>(vs, vb, 0, sk, hd, vec, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // ldmatrix row addresses: A (Q) and B (K) non-transposed, V transposed
  const bf16* qa = qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                   + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  float oacc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
    oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;
  const int row_a = q0 + warp * 16 + g;           // this thread's rows:
  const int row_b = row_a + 8;                    // row_a and row_a + 8

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1, k0 = j * BK;
    if (j + 1 < nk) {   // the next tile streams in while this one computes
      load_tile<BK, HD, NT>(ks + (st ^ 1) * BK * LD, kb, k0 + BK, sk, hd, vec,
                            tid);
      load_tile<BK, HD, NT>(vs + (st ^ 1) * BK * LD, vb, k0 + BK, sk, hd, vec,
                            tid);
    }
    cp_async_commit();
    // a warp whose rows all lie left of the tile's first key skips it
    if (causal && k0 > q0 + warp * 16 + 15) {
      cp_async_wait_all();
      __syncthreads();
      continue;
    }
    const bf16* kt = ks + st * BK * LD + k_off;
    const bf16* vt = vs + st * BK * LD + v_off;

    // s = q . k^T for the warp's 16 rows and the tile's BK keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qa + kk * 16);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kt + np * 16 * LD + kk * 16);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    // the diagonal (and Sk's ragged) tile is masked element by element
    if (k0 + BK > sk || (causal && k0 + BK - 1 > q0 + warp * 16)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + tg * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= sk || (causal && col > row)) s[n][e] = -INFINITY;
        }
    }
    // online softmax: row maxima over the quad sharing each row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i] * sl2;
      const float alpha = fast_exp2(m[i] * sl2 - base[i]);   // 0 at first
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        oacc[d][2 * i] *= alpha;
        oacc[d][2 * i + 1] *= alpha;
      }
    }
    // p = exp(s - m) in float, summed unrounded, rounded to bf16 as the
    // A fragments of p.v
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p0 = fast_exp2(s[n][0] * sl2 - base[0]);
      const float p1 = fast_exp2(s[n][1] * sl2 - base[0]);
      const float p2 = fast_exp2(s[n][2] * sl2 - base[1]);
      const float p3 = fast_exp2(s[n][3] * sl2 - base[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    // o += p . v
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vt + kk * 16 * LD + dp * 16);
        mma_bf16(oacc[2 * dp], pa[kk], b[0], b[1]);
        mma_bf16(oacc[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    cp_async_wait_all();
    __syncthreads();   // tile j + 1 landed; every warp is done with tile j
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  bf16* ob = o + (int64_t)bh * sq * hd;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = d * 8 + tg * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? row_b : row_a;
      if (row >= sq || col >= hd) continue;
      const float x0 = oacc[d][2 * i] * inv[i];
      const float x1 = oacc[d][2 * i + 1] * inv[i];
      bf16* dst = ob + (int64_t)row * hd + col;
      if ((hd & 1) == 0) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
      } else {
        dst[0] = __float2bfloat16(x0);
        if (col + 1 < hd) dst[1] = __float2bfloat16(x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers: the kernel's width HD is the next one built at or above hd

// the CUDA-core kernel: float32 at every hd, bf16 above 256 (HD 256,
// (hd + 255) / 256 output chunks on the grid's z axis)
template <int HD, typename T = float>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
               int sq, int sk, int hd, int causal, float scale,
               void* stream) {
  constexpr int bytes = f32_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + F32_BQ - 1) / F32_BQ, (hd + HD - 1) / HD);
  fa_kernel<HD, T><<<grid, FA_THREADS, bytes, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, hd, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int sk, int hd, int causal, int vec, float scale,
                void* stream) {
  constexpr int bytes = mma_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      fa_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + MMA_BQ - 1) / MMA_BQ);
  fa_mma_kernel<HD><<<grid, MMA_WARPS * 32, bytes, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, hd, causal,
      vec, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o (bh, sq, hd); k, v (bh, sk, hd), all contiguous in one storage
// type, any hd >= 1 (above 256 the chunked CUDA-core kernel); any sq and
// sk (the kernel masks its ragged edges).  vec: hd % 8 == 0 and every
// pointer on 16 bytes (bf16 up to hd 256 only).
int fa_forward_f32(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int sk, int hd, int causal, int vec,
                   float scale, void* stream) {
  (void)vec;
  if (hd < 1) return (int)cudaErrorInvalidValue;
  if (hd <= 32)
    return launch_f32<32>(q, k, v, o, bh, sq, sk, hd, causal, scale, stream);
  if (hd <= 64)
    return launch_f32<64>(q, k, v, o, bh, sq, sk, hd, causal, scale, stream);
  if (hd <= 128)
    return launch_f32<128>(q, k, v, o, bh, sq, sk, hd, causal, scale, stream);
  return launch_f32<256>(q, k, v, o, bh, sq, sk, hd, causal, scale, stream);
}

int fa_forward_bf16(const void* q, const void* k, const void* v, void* o,
                    int bh, int sq, int sk, int hd, int causal, int vec,
                    float scale, void* stream) {
  if (hd < 1) return (int)cudaErrorInvalidValue;
  if (hd <= 32)
    return launch_bf16<32>(q, k, v, o, bh, sq, sk, hd, causal, vec, scale,
                           stream);
  if (hd <= 64)
    return launch_bf16<64>(q, k, v, o, bh, sq, sk, hd, causal, vec, scale,
                           stream);
  if (hd <= 96)
    return launch_bf16<96>(q, k, v, o, bh, sq, sk, hd, causal, vec, scale,
                           stream);
  if (hd <= 128)
    return launch_bf16<128>(q, k, v, o, bh, sq, sk, hd, causal, vec, scale,
                            stream);
  if (hd <= 192)
    return launch_bf16<192>(q, k, v, o, bh, sq, sk, hd, causal, vec, scale,
                            stream);
  if (hd <= 256)
    return launch_bf16<256>(q, k, v, o, bh, sq, sk, hd, causal, vec, scale,
                            stream);
  return launch_f32<256, bf16>(q, k, v, o, bh, sq, sk, hd, causal, scale,
                               stream);
}

}  // extern "C"
