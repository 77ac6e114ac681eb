// Storage-type helpers and the warp reductions of the paged decode kernels
// (K10 GQA and K11 MLA, paged_attention.cu).  The pools, the queries, the
// new cells and the output share one storage type, float or bf16;
// everything inside the kernels is float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define PA_THREADS 256      // K10: blockDim, eight warps a block
#define PA_GROUP 4          // K10: query heads a block serves at most
#define PA_SPLIT_POS 32     // K10: positions a split walks (whole pages, at
                            //      least one: max(1, 32 / ps) pages)
#define PA_MAX_HD 256       // the wrappers refuse wider heads

#define MLA_WARPS 8         // K11 fp32: query heads a block serves, a warp
                            //           each
#define MLA_CHUNK 32        // K11 fp32: positions staged at once, a score a
                            //           lane
#define MLA_MAX_LAT 512     // K11: latent width (fp32: 16 accumulators a
                            //      lane; bf16: two blocks of 256 columns)
#define MLA_MAX_ROPE 64     // K11: RoPE width, 2 query values a lane (fp32)

#define MLA_MMA_WARPS 8     // K11 bf16: 4 head groups x 2 column halves
#define MLA_HT 64           // K11 bf16: heads a block (4 m16 tiles)
#define MLA_CB 256          // K11 bf16: latent columns a block (2 x 128)
#define MLA_CH 16           // K11 bf16: positions a chunk (one k16 of p.c)
#define MLA_STAGES 4        // K11 bf16: chunks in the cp.async ring
#define MLA_BLOCKS 128      // K11 bf16: blocks the split aims at (132 SMs)
#define MLA_MAX_SPLIT 32    // K11 bf16: splits at most (the merge's weights)

template <typename T>
__device__ __forceinline__ float pa_to_float(T x);

template <>
__device__ __forceinline__ float pa_to_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float pa_to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T pa_from_float(float x);

template <>
__device__ __forceinline__ float pa_from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 pa_from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// Sum of v over the 32 lanes of a warp; every lane gets the sum.
__device__ __forceinline__ float pa_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Largest of v over the 32 lanes of a warp; every lane gets it.
__device__ __forceinline__ float pa_warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
