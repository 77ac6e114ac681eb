// K12, attention with an online softmax (flash attention), causal or not,
// for sm_90a.  Built by repro_torch/_build.py and bound with ctypes by
// repro_torch/kernels/flash_attention/kernel.py; each launcher returns
// cudaGetLastError() of its launch.
//
// It replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (_fa_kernel).  The Pallas kernel ran one program per (batch-head, query
// tile), in order on one TPU core, holding the whole (Sk, hd) K and V of
// its batch-head in VMEM.  Here one block serves one (batch-head, query
// tile of block_q rows), all of them in parallel; K and V pass through
// shared memory one tile of block_k keys at a time.  Per key tile:
//   1. stage K (as float) and form the scores s = (q . k) * hd^-0.5 of the
//      (block_q x block_k) tile, 16 x 16 threads, each a (block_q / 16) x
//      (block_k / 16) tile of scores in registers; causal masking sets s to
//      NEG_INF = -1e30 where row < column, aligned at the top left;
//   2. the online softmax in float, as the reference's: m' = max(m,
//      rowmax s), p = exp(s - m'), l = l exp(m - m') + rowsum p, acc =
//      acc exp(m - m') + p V, with the row's 16 threads reducing over
//      warp shuffles; p goes to shared memory;
//   3. stage V over K's buffer and add p V into the (block_q / 16) x
//      (hd / 16) accumulators each thread keeps in registers.
// Then o = acc / max(l, 1e-30), cast to the input's type.  With causal
// masking, key tiles wholly right of the query tile's last row are
// skipped: every score in them is NEG_INF, so p = exp(NEG_INF - m) is 0
// exactly and the skip leaves the function as it was (each row's first key
// tile holds its column 0, so m is finite by then).
//
// Types: float and bf16 inputs (bf16 widened to float on staging, so the
// products are exact in float, as the reference's preferred_element_type
// float32); widths hd in {16, 32, 64, 128} and tiles block_q, block_k in
// {64, 128}, one instantiation each.
//
// What bounds it: at S = 4096, hd = 128, causal, bf16 (the timed shape)
// the operations, 68.7 GFLOP, take 0.069 ms at the card's bf16 tensor-core
// rate (989 TFLOP/s; bf16 products are exact in float, so that rate
// computes the same function); the 16.8 MB of q, k, v and o take 0.005 ms.
// This first kernel runs its products on the CUDA cores in float, two
// shared-memory loads for every few multiply-adds, with one block a SM at
// block_q = block_k = hd = 128 (198 KB of shared memory): far from that
// bound.  bf16 mma / wgmma and TMA-staged K/V are later work (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int FA_THREADS = 256;   // a 16 x 16 thread grid over each tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int BQ, int BK, int HD>
constexpr int smem_bytes() {
  return (BQ * (HD + 1) + BK * (HD + 1) + BQ * (BK + 1)) * 4;
}

template <typename T, int BQ, int BK, int HD>
__global__ void __launch_bounds__(FA_THREADS, 1)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
          int causal, float scale) {
  constexpr int QP = HD + 1, PP = BK + 1;           // padded row strides
  constexpr int RI = BQ / 16, CJ = BK / 16, DJ = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // BQ x QP: the query tile
  float* kv = qs + BQ * QP;      // BK x QP: the K tile, then the V tile
  float* ps = kv + BK * QP;      // BQ x PP: the tile's softmax weights
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = sq / BQ;
  const int bh = blockIdx.x / nq, q0 = (blockIdx.x % nq) * BQ;
  const T* qb = q + ((int64_t)bh * sq + q0) * HD;
  const T* kb = k + (int64_t)bh * sk * HD;
  const T* vb = v + (int64_t)bh * sk * HD;

  for (int e = tid; e < BQ * HD; e += FA_THREADS)
    qs[(e / HD) * QP + e % HD] = widen(qb[e]);
  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DJ; ++d) acc[i][d] = 0.f;
  }
  int nk = sk / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // the last tile's V reads are done (q is staged)
    for (int e = tid; e < BK * HD; e += FA_THREADS)
      kv[(e / HD) * QP + e % HD] = widen(kb[(int64_t)k0 * HD + e]);
    __syncthreads();
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) s[i][c] = 0.f;
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
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        float val = s[i][c] * scale;
        if (causal && row < k0 + tx + 16 * c) val = NEG_INF;
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
    for (int e = tid; e < BK * HD; e += FA_THREADS)
      kv[(e / HD) * QP + e % HD] = widen(vb[(int64_t)k0 * HD + e]);
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
  T* ob = o + ((int64_t)bh * sq + q0) * HD;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < DJ; ++d)
      narrow(ob + (ty + 16 * i) * HD + tx + 16 * d, acc[i][d] / den);
  }
}

template <typename T, int BQ, int BK, int HD>
int launch_one(const void* q, const void* k, const void* v, void* o, int bh,
               int sq, int sk, int causal, float scale, void* stream) {
  constexpr int bytes = smem_bytes<BQ, BK, HD>();
  cudaFuncSetAttribute(fa_kernel<T, BQ, BK, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const int blocks = bh * (sq / BQ);
  fa_kernel<T, BQ, BK, HD><<<blocks, FA_THREADS, bytes,
                             (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int BQ, int BK>
int launch_hd(const void* q, const void* k, const void* v, void* o, int bh,
              int sq, int sk, int hd, int causal, float scale,
              void* stream) {
  switch (hd) {
    case 16:
      return launch_one<T, BQ, BK, 16>(q, k, v, o, bh, sq, sk, causal, scale,
                                       stream);
    case 32:
      return launch_one<T, BQ, BK, 32>(q, k, v, o, bh, sq, sk, causal, scale,
                                       stream);
    case 64:
      return launch_one<T, BQ, BK, 64>(q, k, v, o, bh, sq, sk, causal, scale,
                                       stream);
    case 128:
      return launch_one<T, BQ, BK, 128>(q, k, v, o, bh, sq, sk, causal,
                                        scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int hd, int block_q, int block_k, int causal,
           float scale, void* stream) {
  if (block_q == 64 && block_k == 64)
    return launch_hd<T, 64, 64>(q, k, v, o, bh, sq, sk, hd, causal, scale,
                                stream);
  if (block_q == 64 && block_k == 128)
    return launch_hd<T, 64, 128>(q, k, v, o, bh, sq, sk, hd, causal, scale,
                                 stream);
  if (block_q == 128 && block_k == 64)
    return launch_hd<T, 128, 64>(q, k, v, o, bh, sq, sk, hd, causal, scale,
                                 stream);
  if (block_q == 128 && block_k == 128)
    return launch_hd<T, 128, 128>(q, k, v, o, bh, sq, sk, hd, causal, scale,
                                  stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o (bh, sq, hd); k, v (bh, sk, hd), all contiguous in one storage
// type; sq % block_q == 0 and sk % block_k == 0 (the caller pads).
int fa_forward_f32(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int sk, int hd, int block_q, int block_k,
                   int causal, float scale, void* stream) {
  return launch<float>(q, k, v, o, bh, sq, sk, hd, block_q, block_k, causal,
                       scale, stream);
}

int fa_forward_bf16(const void* q, const void* k, const void* v, void* o,
                    int bh, int sq, int sk, int hd, int block_q, int block_k,
                    int causal, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, hd, block_q, block_k,
                               causal, scale, stream);
}

}  // extern "C"
