// The paged decode kernels of the serving tier, one token per slot against
// the paged block pool: K10 (GQA) and K11 (weight-absorbed MLA, below).
// Built for sm_90a by repro_torch/_build.py and bound with ctypes by
// repro_torch/kernels/paged_attention/kernel.py; each launcher returns
// cudaGetLastError() of its launch.
//
// K10 replaces src/repro/kernels/paged_attention/kernel.py::paged_gqa_call
// (_gqa_kernel, _online_softmax_walk).  The Pallas kernel ran one program
// per slot, in order on one TPU core, with the page-table rows
// scalar-prefetched and the pools resident in VMEM.  Here one block serves
// one (slot, KV head) pair, bs x Hkv blocks in parallel, and the block
// loads its own page-table row.  Per block:
//   1. write the new K/V cell (page_rows[t, pos / ps], pos % ps) of its KV
//      head, then __syncthreads(), so the walk reads position pos back like
//      every earlier one (the pool pointers are plain loads, not the
//      read-only path, so the block sees its own write);
//   2. walk pages page_rows[t, 0 .. pos / ps] in order, staging the valid
//      rows of one page (K and V, ps x hd, as float) in shared memory.
//      Positions after pos in the last page are never loaded: a reused
//      page's stale tail cannot reach the result, even when non-finite.
//      No other page (the tail of the row, another slot's) is read;
//   3. scores q . k * hd^-0.5 for its n_rep = H / Hkv query heads, one warp
//      per (head, position) with a warp reduction over hd;
//   4. an online softmax in float (running max, normaliser and the
//      accumulator, rescaled by exp(m_old - m_new) each page), as the
//      reference's walk does;
//   5. o = acc / l, written in q's storage type.
// Blocks touch disjoint memory: distinct slots own disjoint pages
// (admission proves it) and a block reads and writes only its KV head's
// slice of them.  A position outside the row (pos < 0 or pos >= max_pages
// * ps), or a page id outside the pool among page_rows[t, 0 .. pos / ps]
// (all checked before the cell write), makes the block write NaN to its
// output and touch nothing else: the kernel cannot raise, and a NaN trips
// the service's finiteness guard, which on the card raises.
//
// What bounds it: bytes.  Per launch it must read the valid K and V rows of
// every walked page once (2 x positions x Hkv x hd x the storage size) and
// q, and write o and the cell; its operations (4 per element of those
// rows per query head) are far below the card's rate at n_rep = 2.  The
// design reads each row once per KV head into shared memory and uses it
// for all n_rep query heads.  It is a first, simple kernel: one launch per
// layer, no TMA, no split over pages: a block walks its slot's pages one
// after another with four block barriers per page and one thread per query
// head running the softmax update serially, on bs x Hkv blocks (64 at 8
// slots) for 132 SMs.  That design, not the bytes, sets its time.

#include <cmath>
#include <cstdint>

#include "paged_attention.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                  const T* __restrict__ v_new, T* k_pool, T* v_pool,
                  const int* __restrict__ page_rows,
                  const int* __restrict__ pos, T* __restrict__ o, int n_kv,
                  int n_rep, int hd, int ps, int max_pages, int n_pages,
                  float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // ps x hd: the page's K rows
  float* vs = ks + ps * hd;         // ps x hd: its V rows
  float* qs = vs + ps * hd;         // n_rep x hd: the block's query heads
  float* ss = qs + n_rep * hd;      // n_rep x ps: scores, then weights
  float* ms = ss + n_rep * ps;      // n_rep: running max
  float* ls = ms + n_rep;           // n_rep: running normaliser
  float* cs = ls + n_rep;           // n_rep: this page's correction

  const int kvh = blockIdx.x, t = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n_items = n_rep * hd;
  const int64_t cell = (int64_t)n_kv * hd;      // one position of a page
  const int64_t page = (int64_t)ps * cell;
  const int* row = page_rows + (int64_t)t * max_pages;
  const int64_t qo = ((int64_t)t * n_kv + kvh) * n_rep * hd;  // q and o
  const int64_t kvo = ((int64_t)t * n_kv + kvh) * hd;         // new cells

  const int p_t = pos[t];
  const bool pos_ok = p_t >= 0 && p_t < max_pages * ps;
  const int last = pos_ok ? p_t / ps : -1;
  // 0. every page id the walk will read lies in the pool, or nothing is
  // written: all threads check a share of row[0 .. last] and agree
  bool mine = pos_ok;
  for (int p = tid; p <= last; p += blockDim.x)
    mine = mine && row[p] >= 0 && row[p] < n_pages;
  const bool ok = __syncthreads_and(mine);

  // 1. the new cell first
  if (ok) {
    const int pg = row[last];
    T* kc = k_pool + pg * page + (int64_t)(p_t % ps) * cell + kvh * hd;
    T* vc = v_pool + pg * page + (int64_t)(p_t % ps) * cell + kvh * hd;
    for (int d = tid; d < hd; d += blockDim.x) {
      kc[d] = k_new[kvo + d];
      vc[d] = v_new[kvo + d];
    }
  }
  for (int i = tid; i < n_items; i += blockDim.x)
    qs[i] = pa_to_float(q[qo + i]);
  if (tid < n_rep) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.0f;
  }
  __syncthreads();   // the cell is visible to the block before the walk

  float acc[PA_ITEMS];
#pragma unroll
  for (int k = 0; k < PA_ITEMS; ++k) acc[k] = 0.0f;

  for (int p = 0; ok && p <= last; ++p) {
    const int pg = row[p];
    const int nv = min(ps, p_t - p * ps + 1);   // positions <= pos
    const T* kp = k_pool + pg * page + kvh * hd;
    const T* vp = v_pool + pg * page + kvh * hd;
    // 2. stage the valid rows only
    for (int i = tid; i < nv * hd; i += blockDim.x) {
      const int j = i / hd, d = i - j * hd;
      ks[i] = pa_to_float(kp[j * cell + d]);
      vs[i] = pa_to_float(vp[j * cell + d]);
    }
    __syncthreads();
    // 3. scores, one warp per (head, position)
    for (int w = warp; w < n_rep * nv; w += nwarps) {
      const int r = w / nv, j = w - r * nv;
      float a = 0.0f;
      for (int d = lane; d < hd; d += 32) a += qs[r * hd + d] * ks[j * hd + d];
      a = pa_warp_sum(a);
      if (lane == 0) ss[r * ps + j] = a * scale;
    }
    __syncthreads();
    // 4. the softmax state, one thread per query head
    if (tid < n_rep) {
      float* s = ss + tid * ps;
      const float m_old = ms[tid];
      float m_new = m_old;
      for (int j = 0; j < nv; ++j) m_new = fmaxf(m_new, s[j]);
      float sum = 0.0f;
      for (int j = 0; j < nv; ++j) {
        const float w = expf(s[j] - m_new);
        s[j] = w;
        sum += w;
      }
      const float corr = expf(m_old - m_new);   // 0 on the first page
      ls[tid] = ls[tid] * corr + sum;
      ms[tid] = m_new;
      cs[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PA_ITEMS; ++k) {
      const int i = tid + k * blockDim.x;
      if (i < n_items) {
        const int r = i / hd, d = i - r * hd;
        float a = acc[k] * cs[r];
        for (int j = 0; j < nv; ++j) a += ss[r * ps + j] * vs[j * hd + d];
        acc[k] = a;
      }
    }
    __syncthreads();   // the next page overwrites ks, vs and ss
  }

  // 5. the output
#pragma unroll
  for (int k = 0; k < PA_ITEMS; ++k) {
    const int i = tid + k * blockDim.x;
    if (i < n_items)
      o[qo + i] = pa_from_float<T>(ok ? acc[k] / ls[i / hd] : NAN);
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, const int* page_rows, const int* pos, void* o,
           int bs, int n_kv, int n_rep, int hd, int ps, int max_pages,
           int n_pages, float scale, void* stream) {
  const size_t smem =
      sizeof(float) * (2 * ps * hd + n_rep * hd + n_rep * ps + 3 * n_rep);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gqa_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_kv, bs);
  gqa_decode_kernel<T><<<grid, PA_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)k_pool, (T*)v_pool,
      page_rows, pos, (T*)o, n_kv, n_rep, hd, ps, max_pages, n_pages, scale);
  return (int)cudaGetLastError();
}


// K11: weight-absorbed MLA decode against the compressed latent pool.
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_mla_call
// (_mla_kernel, _online_softmax_walk): one Pallas program per slot, in order
// on one TPU core, all H query heads at once with the pools resident in
// VMEM.  For slot t it writes the latent c_new[t] and RoPE key r_new[t] into
// cell (page_rows[t, pos / ps], pos % ps) of the two pools, then takes an
// online softmax over positions 0 .. pos of the slot's listed pages with
// scores (q_eff . c + q_rope . r) * scale, and writes ctx = sum w c / l
// (bs, H, lat) in q_eff's storage type.
//
// All 128 heads of one slot do not fit one block (their queries alone are
// 128 x 576 floats, 295 KB, over the 227 KB a block can have), so a block
// serves MLA_WARPS heads of one slot, a warp each: a grid of H / hg x bs
// blocks (128 at 8 slots, for 132 SMs).  Per block:
//   0. every page id of page_rows[t, 0 .. pos / ps] is checked against the
//      pool and pos against the row; if one fails the block writes NaN to
//      its heads' output and touches nothing else (the kernel cannot raise;
//      a NaN trips the service's finiteness guard, which on the card
//      raises), as K10 does;
//   1. the latent is shared by every head, so the blocks of one slot would
//      race on the new cell: exactly one block of the slot (blockIdx.x ==
//      0) writes it, and every block takes position pos from c_new / r_new
//      directly and reads only positions < pos from the pools.  No block
//      reads what another block of the launch writes;
//   2. the walk stages MLA_CHUNK positions at a time (latent and RoPE key
//      as float, a row per warp at a time, lanes on consecutive elements).
//      Positions after pos are never loaded, so a reused page's stale
//      tail, even non-finite, cannot reach the result; no page but the
//      listed ones is read;
//   3. each warp keeps its head's query in registers (lat / 32 + rope / 32
//      values a lane) and takes each staged position's score with a warp
//      reduction; lane j keeps position j's score;
//   4. the online softmax state (max, normaliser) is updated across the
//      warp with two reductions per chunk, not by one thread serially;
//   5. each lane accumulates lat / 32 elements of its head's context.
//
// What bounds it: bytes.  Every head meets every position of the slot's
// latent row (lat + rope values) twice, once for the score and once for the
// context: bs x H x positions x (lat + rope + lat) x 2 operations, about
// 0.64 GFLOP at 8 slots x 37 pages, 0.00065 ms at the H100's 989 TFLOP/s
// for bf16 operands on the tensor cores (bf16 products are exact in float,
// so that rate computes the same function), against 4.9 MB of bytes (the
// latent rows once, 2.7 MB, the queries and the output), 0.00147 ms at
// 3.35 TB/s.  The design reads each staged row once per block into shared
// memory for its 8 heads (16 blocks of a slot read the same rows, mostly
// from L2) and does the arithmetic in float on the CUDA cores, where the
// operations alone take 0.0096 ms at 67 TFLOP/s.  It is a first, simple
// kernel: one launch per layer, no tensor cores, no TMA, two block
// barriers per chunk of 32 positions.  On an H100 it takes ~175x its
// bound: each SM holds one block of 8 warps, and each warp issues a
// shared-memory load for every multiply-add, so issue and latency, not the
// multiply-adds, set its time.  Loading a warp's rows all at once and one
// reduce-scatter per chunk in place of 32 warp reductions were tried and
// were slower (more registers, same issue count).  The two products of a
// chunk (scores, context) are the work for tensor cores.

template <typename T>
__global__ void __launch_bounds__(MLA_WARPS * 32)
mla_decode_kernel(const T* __restrict__ q_eff, const T* __restrict__ q_rope,
                  const T* __restrict__ c_new, const T* __restrict__ r_new,
                  T* c_pool, T* r_pool, const int* __restrict__ page_rows,
                  const int* __restrict__ pos, T* __restrict__ ctx,
                  int n_heads, int lat, int rope, int ps, int max_pages,
                  int n_pages, float scale) {
  constexpr int LAT_ITEMS = MLA_MAX_LAT / 32;
  constexpr int ROPE_ITEMS = MLA_MAX_ROPE / 32;
  extern __shared__ float cs[];     // MLA_CHUNK x (lat + rope): staged rows

  const int width = lat + rope;
  const int hg = blockDim.x >> 5;
  const int t = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x * hg + warp;     // this warp's head
  const int* row = page_rows + (int64_t)t * max_pages;
  T* out = ctx + ((int64_t)t * n_heads + h) * lat;

  const int p_t = pos[t];
  const bool pos_ok = p_t >= 0 && p_t < max_pages * ps;
  const int last = pos_ok ? p_t / ps : -1;
  // 0. every page id the walk will read lies in the pool, or nothing is
  // written: all threads check a share of row[0 .. last] and agree
  bool mine = pos_ok;
  for (int p = tid; p <= last; p += blockDim.x)
    mine = mine && row[p] >= 0 && row[p] < n_pages;
  if (!__syncthreads_and(mine)) {
    for (int d = lane; d < lat; d += 32) out[d] = pa_from_float<T>(NAN);
    return;                       // every thread of the block returns here
  }

  const T* cn = c_new + (int64_t)t * lat;
  const T* rn = r_new + (int64_t)t * rope;
  // 1. the new cell, by one block of the slot
  if (blockIdx.x == 0) {
    const int64_t cell = (int64_t)row[last] * ps + p_t % ps;
    for (int d = tid; d < lat; d += blockDim.x) c_pool[cell * lat + d] = cn[d];
    for (int d = tid; d < rope; d += blockDim.x)
      r_pool[cell * rope + d] = rn[d];
  }

  // the warp's query in registers: element lane + 32 i
  float qe[LAT_ITEMS], qr[ROPE_ITEMS], acc[LAT_ITEMS];
  const T* qe_h = q_eff + ((int64_t)t * n_heads + h) * lat;
  const T* qr_h = q_rope + ((int64_t)t * n_heads + h) * rope;
#pragma unroll
  for (int i = 0; i < LAT_ITEMS; ++i) {
    const int d = lane + 32 * i;
    qe[i] = d < lat ? pa_to_float(qe_h[d]) : 0.0f;
    acc[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < ROPE_ITEMS; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < rope ? pa_to_float(qr_h[d]) : 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  for (int base = 0; base <= p_t; base += MLA_CHUNK) {
    const int nv = min(MLA_CHUNK, p_t - base + 1);   // positions <= pos
    // 2. stage positions base .. base + nv - 1, a row per warp at a time;
    // position pos from c_new / r_new, the others from the listed pages
    for (int j = warp; j < nv; j += hg) {
      const int pj = base + j;
      const T* src_c = cn;
      const T* src_r = rn;
      if (pj != p_t) {
        const int64_t cell = (int64_t)row[pj / ps] * ps + pj % ps;
        src_c = c_pool + cell * lat;
        src_r = r_pool + cell * rope;
      }
      float* dst = cs + j * width;
      for (int d = lane; d < lat; d += 32) dst[d] = pa_to_float(src_c[d]);
      for (int d = lane; d < rope; d += 32)
        dst[lat + d] = pa_to_float(src_r[d]);
    }
    __syncthreads();
    // 3. scores: lane j keeps position base + j's
    float s = -INFINITY;
    for (int j = 0; j < nv; ++j) {
      const float* cj = cs + j * width;
      float a = 0.0f;
#pragma unroll
      for (int i = 0; i < LAT_ITEMS; ++i) {
        const int d = lane + 32 * i;
        if (d < lat) a += qe[i] * cj[d];
      }
#pragma unroll
      for (int i = 0; i < ROPE_ITEMS; ++i) {
        const int d = lane + 32 * i;
        if (d < rope) a += qr[i] * cj[lat + d];
      }
      a = pa_warp_sum(a);
      if (lane == j) s = a * scale;
    }
    // 4. the softmax state, across the warp
    const float m_new = fmaxf(m, pa_warp_max(s));
    const float w = lane < nv ? expf(s - m_new) : 0.0f;
    const float corr = expf(m - m_new);            // 0 on the first chunk
    l = l * corr + pa_warp_sum(w);
    m = m_new;
    // 5. the context
#pragma unroll
    for (int i = 0; i < LAT_ITEMS; ++i) acc[i] *= corr;
    for (int j = 0; j < nv; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float* cj = cs + j * width;
#pragma unroll
      for (int i = 0; i < LAT_ITEMS; ++i) {
        const int d = lane + 32 * i;
        if (d < lat) acc[i] += wj * cj[d];
      }
    }
    __syncthreads();   // the next chunk overwrites cs
  }

#pragma unroll
  for (int i = 0; i < LAT_ITEMS; ++i) {
    const int d = lane + 32 * i;
    if (d < lat) out[d] = pa_from_float<T>(acc[i] / l);
  }
}

template <typename T>
int launch_mla(const void* q_eff, const void* q_rope, const void* c_new,
               const void* r_new, void* c_pool, void* r_pool,
               const int* page_rows, const int* pos, void* ctx, int bs,
               int n_heads, int lat, int rope, int ps, int max_pages,
               int n_pages, float scale, void* stream) {
  if (lat < 1 || lat > MLA_MAX_LAT || rope < 1 || rope > MLA_MAX_ROPE)
    return (int)cudaErrorInvalidValue;
  int hg = MLA_WARPS;
  while (n_heads % hg) hg >>= 1;     // heads a block serves
  const size_t smem = sizeof(float) * MLA_CHUNK * (lat + rope);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_heads / hg, bs);
  mla_decode_kernel<T><<<grid, 32 * hg, smem, (cudaStream_t)stream>>>(
      (const T*)q_eff, (const T*)q_rope, (const T*)c_new, (const T*)r_new,
      (T*)c_pool, (T*)r_pool, page_rows, pos, (T*)ctx, n_heads, lat, rope,
      ps, max_pages, n_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o (bs, n_kv * n_rep, hd); k_new, v_new (bs, n_kv, hd); pools
// (n_pages, ps, n_kv, hd), all contiguous in one storage type; page_rows
// (bs, max_pages) and pos (bs) int32.  The pools are updated in place.
int pa_gqa_decode_f32(const void* q, const void* k_new, const void* v_new,
                      void* k_pool, void* v_pool, const int* page_rows,
                      const int* pos, void* o, int bs, int n_kv, int n_rep,
                      int hd, int ps, int max_pages, int n_pages, float scale,
                      void* stream) {
  return launch<float>(q, k_new, v_new, k_pool, v_pool, page_rows, pos, o,
                       bs, n_kv, n_rep, hd, ps, max_pages, n_pages, scale,
                       stream);
}

int pa_gqa_decode_bf16(const void* q, const void* k_new, const void* v_new,
                       void* k_pool, void* v_pool, const int* page_rows,
                       const int* pos, void* o, int bs, int n_kv, int n_rep,
                       int hd, int ps, int max_pages, int n_pages,
                       float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_new, v_new, k_pool, v_pool, page_rows,
                               pos, o, bs, n_kv, n_rep, hd, ps, max_pages,
                               n_pages, scale, stream);
}

}  // extern "C"

extern "C" {

// q_eff, ctx (bs, n_heads, lat); q_rope (bs, n_heads, rope); c_new (bs,
// lat); r_new (bs, rope); pools (n_pages, ps, lat) and (n_pages, ps, rope),
// all contiguous in one storage type; page_rows (bs, max_pages) and pos
// (bs) int32.  The pools are updated in place.
int pa_mla_decode_f32(const void* q_eff, const void* q_rope,
                      const void* c_new, const void* r_new, void* c_pool,
                      void* r_pool, const int* page_rows, const int* pos,
                      void* ctx, int bs, int n_heads, int lat, int rope,
                      int ps, int max_pages, int n_pages, float scale,
                      void* stream) {
  return launch_mla<float>(q_eff, q_rope, c_new, r_new, c_pool, r_pool,
                           page_rows, pos, ctx, bs, n_heads, lat, rope, ps,
                           max_pages, n_pages, scale, stream);
}

int pa_mla_decode_bf16(const void* q_eff, const void* q_rope,
                       const void* c_new, const void* r_new, void* c_pool,
                       void* r_pool, const int* page_rows, const int* pos,
                       void* ctx, int bs, int n_heads, int lat, int rope,
                       int ps, int max_pages, int n_pages, float scale,
                       void* stream) {
  return launch_mla<__nv_bfloat16>(q_eff, q_rope, c_new, r_new, c_pool,
                                   r_pool, page_rows, pos, ctx, bs, n_heads,
                                   lat, rope, ps, max_pages, n_pages, scale,
                                   stream);
}

}  // extern "C"
