// The paged decode kernels of the serving tier, one token per slot against
// the paged block pool: K10 (GQA) and K11 (weight-absorbed MLA, below).
// Built for sm_90a by repro_torch/_build.py and bound with ctypes by
// repro_torch/kernels/paged_attention/kernel.py; each launcher returns
// cudaGetLastError() of its launch.
//
// K10 replaces src/repro/kernels/paged_attention/kernel.py::paged_gqa_call
// (_gqa_kernel, _online_softmax_walk).  The Pallas kernel ran one program
// per slot, in order on one TPU core, with the page-table rows
// scalar-prefetched and the pools resident in VMEM, walking the slot's
// pages with an online softmax and repeating the KV heads to any H.  Here
// the walk is split (flash-decoding): the grid is (KV head x head group,
// slot, split), and split s walks the slot's listed pages s * pps ..
// s * pps + pps - 1, pps = max(1, PA_SPLIT_POS / ps) (4 pages at page 8,
// 32 positions), so 8 slots x 37 pages give several hundred blocks for 132
// SMs.  The wrapper sizes the grid from page_rows.shape[1], never from pos
// (no host sync); a split past the slot's position exits at once.  A block
// serves up to PA_GROUP (4) query heads of its KV head, the KV head's
// n_rep heads cut into ceil(n_rep / 4) groups as even as they can be (any
// n_rep: more heads take more groups, so shared memory does not grow with
// n_rep; each group re-reads the split's rows, from L2 after the first).
// Splits of 32 positions, 256 threads and groups of 4 were the fastest
// forms tried on an H100: splits of 16 or 64 positions, 128 threads, and
// groups of 8 or 16 heads were each slower at 8 slots x 37 pages, groups
// of 16 most of all at starcoder2-7b's 36 / 4 heads.  Per block:
//   0. every page id of page_rows[t, 0 .. pos / ps] is checked against the
//      pool and pos against the row (at most a few dozen ints); if one
//      fails, the slot's output is NaN (written by split 0) and nothing is
//      written to the pools: the kernel cannot raise, and a NaN trips the
//      service's finiteness guard, which on the card raises;
//   1. while the ids are checked, the split's valid positions (<= pos) of
//      K and V are staged as float in shared memory, 16-byte loads on
//      neighbouring lanes, each row loaded once (only if its own page id
//      lies in the pool) and used for all the block's query heads.
//      Positions after pos are never loaded, so a reused page's stale,
//      even non-finite, tail cannot reach o; no unlisted page is read;
//   2. after the check, exactly one block, the split holding page pos / ps
//      of head group 0, writes the new K/V cell of its KV head; every block
//      whose split covers position pos takes it from k_new / v_new
//      directly, so no block reads what another block of the launch
//      writes;
//   3. scores q . k * hd^-0.5, a thread per (head, position);
//   4. the split's softmax (max m, normaliser l) across a warp per head
//      (shuffles), the weights kept in shared memory;
//   5. acc = sum p v, a thread per (head, element).  A slot walked by one
//      split writes o = acc / l at once; otherwise each split writes its
//      partial (m, l, acc) to the wrapper's scratch, and the last split of
//      each (slot, KV head, group) to arrive, chosen by an integer ticket
//      that it then resets for the next launch, merges the partials in
//      fixed split order, o = sum_s acc_s e^(m_s - M) / sum_s l_s
//      e^(m_s - M), M = max_s m_s, in q's storage type.  No float atomics:
//      two runs are bitwise equal.  One CUDA launch a layer.
// Blocks of different slots touch disjoint memory: distinct slots own
// disjoint pages (admission proves it).
//
// What bounds it: bytes.  Per launch it must read the valid K and V rows of
// every walked page once (2 x positions x Hkv x hd x the storage size) and
// q, and write o and the cell; its operations (4 per element of those rows
// per query head) are far below the card's rate.  The split grid puts the
// reads of one layer on every SM at once; the partials (float, n_rep x hd a
// split) stay in L2.

#include <cmath>
#include <cstdint>

#include "paged_attention.cuh"

namespace {

// 16 bytes of T at src (aligned) as floats at dst
__device__ __forceinline__ void pa_load16(float* dst, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

__device__ __forceinline__ void pa_load16(float* dst,
                                          const __nv_bfloat16* src) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                  const T* __restrict__ v_new, T* k_pool, T* v_pool,
                  const int* __restrict__ page_rows,
                  const int* __restrict__ pos, T* __restrict__ o,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int* __restrict__ tickets, int n_kv, int n_rep, int hd,
                  int ps, int max_pages, int n_pages, int pps, int vec,
                  float scale) {
  // ceil(n_rep / PA_GROUP) groups of as even a size as they can have
  const int n_groups = (n_rep + PA_GROUP - 1) / PA_GROUP;
  const int g_size = (n_rep + n_groups - 1) / n_groups;
  const int kvh = blockIdx.x / n_groups, grp = blockIdx.x - kvh * n_groups;
  const int t = blockIdx.y, split = blockIdx.z, n_split = gridDim.z;
  const int r0 = grp * g_size;                   // first head of the group
  const int nr = min(g_size, n_rep - r0);        // heads of this block
  const int npos = pps * ps;                     // positions a split
  const int hp = hd + 1;                         // padded staged row
  extern __shared__ float smem[];
  float* ks = smem;                   // npos x hp: the split's K rows
  float* vs = ks + npos * hp;         // npos x hp: its V rows
  float* qs = vs + npos * hp;         // PA_GROUP x hd: the block's queries
  float* ss = qs + PA_GROUP * hd;     // PA_GROUP x npos: scores, weights
  float* ms = ss + PA_GROUP * npos;   // PA_GROUP: the split's max
  float* ls = ms + PA_GROUP;          // PA_GROUP: its normaliser
  __shared__ int merge;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t cell = (int64_t)n_kv * hd;      // one position of a page
  const int64_t page = (int64_t)ps * cell;
  const int* row = page_rows + (int64_t)t * max_pages;
  const int64_t qo = ((int64_t)t * n_kv * n_rep + kvh * n_rep + r0) * hd;
  const int64_t kvo = ((int64_t)t * n_kv + kvh) * hd;   // new cells

  const int p_t = pos[t];
  const bool pos_ok = p_t >= 0 && p_t < max_pages * ps;
  const int last = pos_ok ? p_t / ps : -1;
  const int n_need = pos_ok ? last / pps + 1 : 0;   // splits holding a
  const int p0 = split * npos;                        // position
  const int nv = min(npos, p_t - p0 + 1);       // positions <= pos
  // 0. every page id the walk will read lies in the pool, or nothing is
  // written: all threads check a share of row[0 .. last] and agree.
  bool mine = pos_ok;
  for (int p = tid; p <= last; p += PA_THREADS)
    mine = mine && row[p] >= 0 && row[p] < n_pages;
  // 1. meanwhile, stage the queries and the split's valid rows (position
  // pos from k_new / v_new, the others from the listed pages), each row
  // only if its own page id lies in the pool
  if (split < n_need) {
    for (int i = tid; i < nr * hd; i += PA_THREADS)
      qs[i] = pa_to_float(q[qo + i]);
    constexpr int VEC = 16 / sizeof(T);
    const int cpr = vec ? hd / VEC : hd;        // loads a row
    for (int i = tid; i < nv * cpr; i += PA_THREADS) {
      const int j = i / cpr, c = i - j * cpr;
      const int p = p0 + j;
      const T* kr = k_new + kvo;
      const T* vr = v_new + kvo;
      if (p != p_t) {
        const int id = row[p / ps];
        if (id < 0 || id >= n_pages) continue;  // the vote below fails
        const int64_t at = id * page + (p % ps) * cell + kvh * hd;
        kr = k_pool + at;
        vr = v_pool + at;
      }
      if (vec) {
        pa_load16(ks + j * hp + c * VEC, kr + c * VEC);
        pa_load16(vs + j * hp + c * VEC, vr + c * VEC);
      } else {
        ks[j * hp + c] = pa_to_float(kr[c]);
        vs[j * hp + c] = pa_to_float(vr[c]);
      }
    }
  }
  if (!__syncthreads_and(mine)) {
    if (split == 0)
      for (int i = tid; i < nr * hd; i += PA_THREADS)
        o[qo + i] = pa_from_float<T>(NAN);
    return;                       // every block of the slot returns here
  }
  if (split >= n_need) return;
  // 2. the new cell, once every listed id has passed, by the one block
  // whose split holds it (no block reads it from the pool: position pos
  // comes from k_new / v_new)
  if (split == n_need - 1 && grp == 0) {
    const int64_t at = row[last] * page + (p_t % ps) * cell + kvh * hd;
    for (int d = tid; d < hd; d += PA_THREADS) {
      k_pool[at + d] = k_new[kvo + d];
      v_pool[at + d] = v_new[kvo + d];
    }
  }
  // 3. scores, a thread per (head, position), four partial sums
  for (int i = tid; i < nr * nv; i += PA_THREADS) {
    const int r = i / nv, j = i - r * nv;
    const float* qr = qs + r * hd;
    const float* kr = ks + j * hp;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int d = 0;
    for (; d + 4 <= hd; d += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = fmaf(qr[d + u], kr[d + u], a[u]);
    for (; d < hd; ++d) a[0] = fmaf(qr[d], kr[d], a[0]);
    ss[r * npos + j] = ((a[0] + a[1]) + (a[2] + a[3])) * scale;
  }
  __syncthreads();
  // 4. the split's softmax, a warp per head
  for (int r = warp; r < nr; r += PA_THREADS / 32) {
    float* s = ss + r * npos;
    float m = -INFINITY;
    for (int j = lane; j < nv; j += 32) m = fmaxf(m, s[j]);
    m = pa_warp_max(m);
    float l = 0.0f;
    for (int j = lane; j < nv; j += 32) {
      const float w = expf(s[j] - m);
      s[j] = w;
      l += w;
    }
    l = pa_warp_sum(l);
    if (lane == 0) {
      ms[r] = m;
      ls[r] = l;
    }
  }
  __syncthreads();
  // 5. acc = sum p v, a thread per (head, element)
  const bool single = n_need == 1;
  const int64_t part = ((int64_t)t * n_kv + kvh) * n_rep + r0;  // (r, s)
  for (int i = tid; i < nr * hd; i += PA_THREADS) {
    const int r = i / hd, d = i - r * hd;
    const float* w = ss + r * npos;
    float a2[2] = {0.0f, 0.0f};
    int j = 0;
    for (; j + 2 <= nv; j += 2) {
      a2[0] = fmaf(w[j], vs[j * hp + d], a2[0]);
      a2[1] = fmaf(w[j + 1], vs[(j + 1) * hp + d], a2[1]);
    }
    if (j < nv) a2[0] = fmaf(w[j], vs[j * hp + d], a2[0]);
    const float a = a2[0] + a2[1];
    if (single)
      o[qo + i] = pa_from_float<T>(a / ls[r]);
    else
      part_acc[((part + r) * n_split + split) * hd + d] = a;
  }
  if (single) return;
  if (tid < nr) {
    part_ml[((part + tid) * n_split + split) * 2] = ms[tid];
    part_ml[((part + tid) * n_split + split) * 2 + 1] = ls[tid];
  }
  __threadfence();                // the partial is visible before the ticket
  __syncthreads();
  if (tid == 0) {
    int* ticket = tickets + (int64_t)t * gridDim.x + blockIdx.x;
    merge = atomicAdd(ticket, 1) == n_need - 1;
    if (merge) *ticket = 0;       // every split of the group has arrived
  }
  __syncthreads();
  if (!merge) return;
  __threadfence();
  // the merge, in split order
  for (int i = tid; i < nr * hd; i += PA_THREADS) {
    const int r = i / hd, d = i - r * hd;
    const float* ml = part_ml + (part + r) * n_split * 2;
    const float* acc = part_acc + (part + r) * n_split * hd + d;
    float m = -INFINITY;
    for (int s = 0; s < n_need; ++s) m = fmaxf(m, __ldcg(ml + 2 * s));
    float l = 0.0f, a = 0.0f;
    for (int s = 0; s < n_need; ++s) {
      const float c = expf(__ldcg(ml + 2 * s) - m);
      l += __ldcg(ml + 2 * s + 1) * c;
      a += __ldcg(acc + s * hd) * c;
    }
    o[qo + i] = pa_from_float<T>(a / l);
  }
}

// dynamic shared memory of one K10 block (kernel.py::smem_bytes repeats it)
inline size_t gqa_smem_bytes(int hd, int ps, int pps) {
  const size_t npos = (size_t)pps * ps;
  return sizeof(float) * (2 * npos * (hd + 1) + PA_GROUP * hd
                          + PA_GROUP * npos + 2 * PA_GROUP);
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, const int* page_rows, const int* pos, void* o,
           float* part_ml, float* part_acc, int* tickets, int bs, int n_kv,
           int n_rep, int hd, int ps, int max_pages, int n_pages, int vec,
           float scale, void* stream) {
  if (hd < 1 || hd > PA_MAX_HD || ps < 1 || n_rep < 1)
    return (int)cudaErrorInvalidValue;
  const int pps = ps < PA_SPLIT_POS ? PA_SPLIT_POS / ps : 1;
  const size_t smem = gqa_smem_bytes(hd, ps, pps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gqa_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_groups = (n_rep + PA_GROUP - 1) / PA_GROUP;
  const dim3 grid(n_kv * n_groups, bs, (max_pages + pps - 1) / pps);
  gqa_decode_kernel<T><<<grid, PA_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)k_pool, (T*)v_pool,
      page_rows, pos, (T*)o, part_ml, part_acc, tickets, n_kv, n_rep, hd, ps,
      max_pages, n_pages, pps, vec, scale);
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
// Scratch from the wrapper: part_ml (bs, n_kv, n_rep, n_split, 2) and
// part_acc (bs, n_kv, n_rep, n_split, hd) float, n_split = ceil(max_pages
// / max(1, PA_SPLIT_POS / ps)); tickets (bs, n_kv * ceil(n_rep /
// PA_GROUP)) int32, zero before the launch and left zero.  vec: hd is a
// multiple of 16 bytes' elements and every operand starts on 16 bytes.
int pa_gqa_decode_f32(const void* q, const void* k_new, const void* v_new,
                      void* k_pool, void* v_pool, const int* page_rows,
                      const int* pos, void* o, float* part_ml,
                      float* part_acc, int* tickets, int bs, int n_kv,
                      int n_rep, int hd, int ps, int max_pages, int n_pages,
                      int vec, float scale, void* stream) {
  return launch<float>(q, k_new, v_new, k_pool, v_pool, page_rows, pos, o,
                       part_ml, part_acc, tickets, bs, n_kv, n_rep, hd, ps,
                       max_pages, n_pages, vec, scale, stream);
}

int pa_gqa_decode_bf16(const void* q, const void* k_new, const void* v_new,
                       void* k_pool, void* v_pool, const int* page_rows,
                       const int* pos, void* o, float* part_ml,
                       float* part_acc, int* tickets, int bs, int n_kv,
                       int n_rep, int hd, int ps, int max_pages, int n_pages,
                       int vec, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_new, v_new, k_pool, v_pool, page_rows,
                               pos, o, part_ml, part_acc, tickets, bs, n_kv,
                               n_rep, hd, ps, max_pages, n_pages, vec, scale,
                               stream);
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
