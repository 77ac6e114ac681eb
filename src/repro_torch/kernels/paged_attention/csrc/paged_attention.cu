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

// K11: weight-absorbed MLA decode against the compressed latent pool, in
// two kernels: mla_mma_kernel for bf16 (the serving path; the design
// note below it), mla_decode_kernel for float32 (the token-for-token
// stream check: float32 has no tensor-core form while TF32 stays off).
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
// float32 (mla_decode_kernel, the first form, kept as it was): all 128
// heads of one slot do not fit one block (their queries alone are
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
// 3.35 TB/s.  The float32 form reads each staged row once per block into
// shared memory for its 8 heads (16 blocks of a slot read the same rows,
// mostly from L2) and does the arithmetic in float on the CUDA cores,
// where the operations alone take 0.0096 ms at 67 TFLOP/s: one launch per
// layer, no tensor cores, two block barriers per chunk of 32 positions.
// In bf16 it took ~175x its bound on an H100 (each warp issues a
// shared-memory load for every multiply-add), which is why bf16 now runs
// mla_mma_kernel.

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

// ---------------------------------------------------------------------------
// K11, bf16: the two products on the tensor cores (mla_mma_kernel).
//
// The work of a slot is two products, S = Q [c r]^T, (H x (lat + rope)) .
// ((lat + rope) x positions), and O = P c, (H x positions) . (positions x
// lat): at 8 slots x 37 pages and the published widths 0.644 GFLOP against
// 4.9 MB, so it belongs on the tensor cores and, beside them, is bound by
// bytes.  The design:
//   * products: bf16 mma.sync m16n8k16 with float accumulation, heads the
//     M dimension.  A block holds MLA_HT (64) heads x MLA_CB (256) latent
//     columns of one slot and one split of its positions, in 8 warps: head
//     group (16 heads, one m16 tile) x column half (128 columns, 16 n8
//     tiles of O in registers, 64 floats a lane; O for 64 heads x 512
//     columns would be 32K floats, so the columns split across warps and
//     blocks, as FlashMLA splits them across warpgroups).  The scores of a
//     chunk of MLA_CH (16) positions: the two warps of a head group each
//     sum half of the 576-deep k-steps (the warp's k-steps go round four
//     accumulators, their fragments loaded four steps at a time, so eight
//     mma chains are in flight), then add the two halves through shared
//     memory (a + b is b + a, so both warps hold the same bits).  p . c
//     loads four column pairs' fragments before their mma, hi products
//     before lo ones;
//   * softmax: online, in float, per head row (the fragment's rows g and
//     g + 8, reduced over the four lanes sharing a row), as K12's;
//   * P for the second product: p is split into a bf16 high part and a
//     bf16 low part (p - hi), two mma on the same c fragments, so P c
//     keeps about 16 bits of each weight: rounding p to bf16 alone would
//     move the output by up to 2^-9 of its largest terms, past one output
//     ulp on the elements that cancel;
//   * staging: Q (64 heads x [q_eff | q_rope]) once a block, and the
//     chunk's latent and RoPE rows ([c | r], one row a position) by
//     cp.async into a ring of MLA_STAGES (4) chunks in shared memory,
//     three chunks ahead of the one computing (a ring one chunk ahead
//     left chunks waiting on their loads), once a block for all its heads
//     (the first
//     form staged each row in all 16 blocks of a slot); rows padded by 16
//     bytes so ldmatrix meets no bank conflict;
//   * split-KV: the grid is (head tiles x column blocks, slot, split);
//     split s walks the slot's listed pages s * pps .. s * pps + pps - 1,
//     pps chosen by the wrapper (kernel.py::mla_pages_per_split: about
//     MLA_BLOCKS blocks, a split
//     at least MLA_SPLIT_CHUNKS chunks of the longest walk the rows hold,
//     at most MLA_MAX_SPLIT splits; sized from page_rows.shape[1], never
//     from pos).  Each split writes its (m, l, O) to scratch from
//     torch.empty and takes an integer ticket; the last of the slot's
//     splits to arrive merges them in split order and resets the ticket,
//     as K10 does: two launches are bitwise equal and the launch can be
//     captured in a CUDA graph.  The merge keeps 8 groups of four columns
//     a thread and issues their loads for two splits at once.  A slot
//     walked by one split writes O / l at once.
// What bounds it now: latency, not bytes or the tensor cores.  On an H100,
// cutting the kernel short at each stage showed the chunk loop (8 warps an
// SM, since one 157 KB block fills an SM's shared memory, so few mma
// chains hide each other's latency), the queries' staging (each of a
// slot's blocks reads its 74 KB of Q) and the partials' round trip
// through global memory before the ticket as the three large parts.  A
// second launch for the merge, and a merge inside a thread-block cluster
// through distributed shared memory, were tried in place of the ticket
// and were no faster; fewer splits lengthen the walk by more than they
// save.  Each part is work for a later form (Q in fewer bytes or shared
// by a cluster, wgmma with more of the block's warps on the products).
// Every rule of the float32 form holds: every listed page id is checked
// (0. above) and a failure gives NaN (written by split 0) and nothing
// else; exactly one block of the slot (head tile 0, column block 0, the
// split holding page pos / ps) writes the new latent and RoPE cell, and
// every block takes position pos from c_new / r_new; positions after pos
// are never loaded (a chunk's rows past them are zero, so 0 x stale NaN
// cannot reach O); only listed pages are read.  Heads past H and columns
// past lat are masked (zero queries, no store), so the reduced widths
// (H 4, lat 32, rope 16; lat 16, rope 8) run too.

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t mla_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously
__device__ __forceinline__ void mla_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   mla_smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mla_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void mla_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mla_ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(mla_smem_addr(p)));
}

__device__ __forceinline__ void mla_ldsm_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(mla_smem_addr(p)));
}

// c (16 x 8, float) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mla_mma(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t mla_pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;                             // the lower column in the low half
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// p as hi + lo, both bf16: lo = bf16(p - hi) carries the bits hi drops
__device__ __forceinline__ void mla_split(float p, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(p);
  lo = __float2bfloat16_rn(p - __bfloat162float(hi));
}

// One row [a (na) | b (nb) | 0 .. kp) of bf16 into dst (a zero row
// unless on), in 8-element units u0, u0 + tpr, ... of it: the row's tpr
// threads find its sources once and share its units.  cp.async where vec
// (na, nb multiples of 8, every source on 16 bytes), element by element
// otherwise.
__device__ __forceinline__ void mla_stage_row(bf16* dst, const bf16* a,
                                              const bf16* b, bool on, int u0,
                                              int tpr, int na, int nb,
                                              int kp, bool vec) {
  for (int col = u0 * 8; col < kp; col += tpr * 8) {
    bf16* d = dst + col;
    if (!on) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      if (col < na)
        mla_cp_async16(d, a + col);
      else if (col < na + nb)
        mla_cp_async16(d, b + (col - na));
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = col + e;
        d[e] = c < na ? a[c]
                      : (c < na + nb ? b[c - na] : __float2bfloat16(0.0f));
      }
    }
  }
}

// the fragments of k-step kk of the scores: A (Q) and B (the chunk's
// rows, positions 0 .. 7 in b[0..1], 8 .. 15 in b[2..3])
__device__ __forceinline__ void mla_score_frags(uint32_t (&a)[4],
                                                uint32_t (&b)[4],
                                                const bf16* qa,
                                                const bf16* kt, int kk) {
  mla_ldsm_x4(a, qa + kk * 16);
  mla_ldsm_x4(b, kt + kk * 16);
}

// acc[n] (positions n * 8 .. n * 8 + 7 of the chunk) += a . b
__device__ __forceinline__ void mla_score_mma(float (&acc)[2][4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[4]) {
  mla_mma(acc[0], a, b[0], b[1]);
  mla_mma(acc[1], a, b[2], b[3]);
}

// shared memory of one block (kernel.py::mla_smem_bytes repeats it): the
// block's queries, a ring of MLA_STAGES chunks, the score exchange
inline size_t mla_mma_smem_bytes(int lat, int rope) {
  const size_t ld = ((lat + rope + 15) / 16) * 16 + 8;
  return sizeof(bf16) * (MLA_HT + MLA_STAGES * MLA_CH) * ld
         + sizeof(float) * MLA_MMA_WARPS * 32 * 8;
}

__global__ void __launch_bounds__(MLA_MMA_WARPS * 32, 1)
mla_mma_kernel(const bf16* __restrict__ q_eff, const bf16* __restrict__ q_rope,
               const bf16* __restrict__ c_new, const bf16* __restrict__ r_new,
               bf16* c_pool, bf16* r_pool, const int* __restrict__ page_rows,
               const int* __restrict__ pos, bf16* __restrict__ ctx,
               float* __restrict__ part_ml, float* __restrict__ part_o,
               int* __restrict__ tickets, int n_heads, int lat, int rope,
               int ps, int max_pages, int n_pages, int pps, int n_cb,
               int vec, float scale) {
  extern __shared__ __align__(16) unsigned char mla_smem[];
  const int kp = (lat + rope + 15) / 16 * 16;   // k of the scores, padded
  const int ld = kp + 8;                        // 16 bytes a row apart
  bf16* qs = reinterpret_cast<bf16*>(mla_smem);         // MLA_HT x ld
  bf16* cs = qs + MLA_HT * ld;          // MLA_STAGES x MLA_CH x ld: the ring
  float* xs = reinterpret_cast<float*>(cs + MLA_STAGES * MLA_CH * ld);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hg = warp & 3, half = warp >> 2;    // head group, column half
  const int g = lane >> 2, tg = lane & 3;       // fragment row, column
  const int ht = blockIdx.x / n_cb, cb = blockIdx.x - ht * n_cb;
  const int t = blockIdx.y, split = blockIdx.z, n_split = gridDim.z;
  const int h0 = ht * MLA_HT;
  const int col0 = cb * MLA_CB + half * 128;    // the warp's first column
  const int* row = page_rows + (int64_t)t * max_pages;

  const int p_t = pos[t];
  const bool pos_ok = p_t >= 0 && p_t < max_pages * ps;
  const int last = pos_ok ? p_t / ps : -1;
  const int n_need = pos_ok ? last / pps + 1 : 0;   // splits holding a
  //                                                   position
  // 0. every page id the walk will read lies in the pool, or nothing is
  // written: all threads check a share of row[0 .. last] and agree
  bool mine = pos_ok;
  for (int p = tid; p <= last; p += blockDim.x)
    mine = mine && row[p] >= 0 && row[p] < n_pages;
  if (!__syncthreads_and(mine)) {
    if (split == 0)
      for (int i = tid; i < MLA_HT * MLA_CB; i += blockDim.x) {
        const int h = h0 + i / MLA_CB, c = cb * MLA_CB + i % MLA_CB;
        if (h < n_heads && c < lat)
          ctx[((int64_t)t * n_heads + h) * lat + c] = __float2bfloat16(NAN);
      }
    return;                       // every block of the slot returns here
  }
  if (split >= n_need) return;
  const bf16* cn = c_new + (int64_t)t * lat;
  const bf16* rn = r_new + (int64_t)t * rope;
  // 1. the new cell, by one block of the slot
  if (split == n_need - 1 && blockIdx.x == 0) {
    const int64_t cell = (int64_t)row[last] * ps + p_t % ps;
    for (int d = tid; d < lat; d += blockDim.x) c_pool[cell * lat + d] = cn[d];
    for (int d = tid; d < rope; d += blockDim.x)
      r_pool[cell * rope + d] = rn[d];
  }
  const int npos = pps * ps, p0 = split * npos;
  const int nv = min(npos, p_t - p0 + 1);      // the split's positions <= pos
  const int n_chunks = (nv + MLA_CH - 1) / MLA_CH;

  // 2. stage the block's queries (4 threads a head) and chunks 0 ..
  // MLA_STAGES - 2 (16 threads a position), one cp.async group each (the
  // queries with chunk 0); chunk c + MLA_STAGES - 1 is issued while chunk
  // c computes.  A thread stages one row of a chunk, so it loads one page
  // id a chunk, one chunk ahead of its issue.
  constexpr int NT = MLA_MMA_WARPS * 32;
  {
    const int r = tid / (NT / MLA_HT), h = h0 + r;
    const int64_t q = ((int64_t)t * n_heads + h) * lat;
    mla_stage_row(qs + r * ld, q_eff + q, q_rope + q / lat * rope,
                  h < n_heads, tid % (NT / MLA_HT), NT / MLA_HT, lat, rope,
                  kp, vec);
  }
  const int rc = tid / (NT / MLA_CH), uc = tid % (NT / MLA_CH);
  auto page_of = [&](int c) {             // this thread's row's page id
    const int j = c * MLA_CH + rc;
    return j < nv ? row[(p0 + j) / ps] : 0;
  };
  auto stage_chunk = [&](int c, int id) {
    const int j = c * MLA_CH + rc, p = p0 + j;   // after pos: a zero row
    const int64_t cell = (int64_t)id * ps + p % ps;
    const bool own = p == p_t;            // position pos: c_new, r_new
    mla_stage_row(cs + ((c % MLA_STAGES) * MLA_CH + rc) * ld,
                  own ? cn : c_pool + cell * lat,
                  own ? rn : r_pool + cell * rope, j < nv, uc, NT / MLA_CH,
                  lat, rope, kp, vec);
  };
  int issued = 0, id = page_of(0);      // id: chunk `issued`'s page
  auto issue = [&]() {                  // the next chunk, if any, as a
    if (issued < n_chunks) {            // group (an empty one past the end)
      stage_chunk(issued, id);
      if (++issued < n_chunks) id = page_of(issued);
    }
    mla_cp_commit();
  };
#pragma unroll
  for (int k = 0; k < MLA_STAGES - 1; ++k) issue();

  // ldmatrix row addresses: A (Q) and B (c for the scores) non-transposed,
  // c for the context transposed
  const bf16* qa = qs + (hg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
                   + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  const int ksteps = kp / 16;
  const bool heads = h0 + hg * 16 < n_heads;    // warp-uniform
  const int ncols = lat - col0;                 // the warp's columns (<= 0:
  //                                               none)
  float o[16][4];
#pragma unroll
  for (int d = 0; d < 16; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int c = 0; c < n_chunks; ++c) {
    mla_cp_wait<MLA_STAGES - 2>();
    __syncthreads();   // chunk c landed; every warp is done with chunk c - 1
    issue();           // into chunk c - 1's slot
    const bf16* ct = cs + (c % MLA_STAGES) * MLA_CH * ld;
    // 3. the warp's half of the k-steps (kk = half, half + 2, ...) in
    // four accumulators, step i into acc[i % 4]: every fragment of four
    // steps is loaded before their mma, so eight mma chains are in flight
    float acc[4][2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][n][e] = 0.0f;
    if (heads) {
      const bf16* kt = ct + k_off;
      int kk = half;
      for (; kk + 6 < ksteps; kk += 8) {
        uint32_t a[4][4], b[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mla_score_frags(a[q], b[q], qa, kt, kk + 2 * q);
#pragma unroll
        for (int q = 0; q < 4; ++q) mla_score_mma(acc[q], a[q], b[q]);
      }
#pragma unroll
      for (int q = 0; q < 3; ++q)
        if (kk + 2 * q < ksteps) {
          uint32_t a[4], b[4];
          mla_score_frags(a, b, qa, kt, kk + 2 * q);
          mla_score_mma(acc[q], a, b);
        }
    }
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = (acc[0][n][e] + acc[1][n][e])
                  + (acc[2][n][e] + acc[3][n][e]);
    float4* mine4 = reinterpret_cast<float4*>(xs + (warp * 32 + lane) * 8);
    mine4[0] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
    mine4[1] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
    __syncthreads();
    const float4* other =
        reinterpret_cast<const float4*>(xs + ((warp ^ 4) * 32 + lane) * 8);
    const float4 x0 = other[0], x1 = other[1];
    const float ox[2][4] = {{x0.x, x0.y, x0.z, x0.w}, {x1.x, x1.y, x1.z, x1.w}};
    // the two halves' sum (the same bits in both warps), scaled; positions
    // after pos or past the split are -inf
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = c * MLA_CH + n * 8 + tg * 2 + (e & 1);
        s[n][e] = j < nv ? (s[n][e] + ox[n][e]) * scale : -INFINITY;
      }
    // 4. the online softmax, in float, rows g and g + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float corr = expf(m[i] - mx[i]);     // 0 on the first chunk
      m[i] = mx[i];
      l[i] *= corr;
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        o[d][2 * i] *= corr;
        o[d][2 * i + 1] *= corr;
      }
    }
    // p = exp(s - m), summed in float, then as bf16 hi + lo A fragments
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = expf(s[n][e] - mx[e >> 1]);
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      bf16 hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) mla_split(p[e], hi[e], lo[e]);
      ph[2 * n] = mla_pack(hi[0], hi[1]);
      ph[2 * n + 1] = mla_pack(hi[2], hi[3]);
      pl[2 * n] = mla_pack(lo[0], lo[1]);
      pl[2 * n + 1] = mla_pack(lo[2], lo[3]);
    }
    // 5. o += p . c over the warp's columns, in two halves of 64: every
    // fragment of a half is loaded first, then the hi products, then the
    // lo ones (no mma waits on the one before it)
    if (heads) {
      const bf16* vt = ct + v_off + col0;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t b[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if ((hf * 4 + q) * 16 < ncols)
            mla_ldsm_x4_trans(b[q], vt + (hf * 4 + q) * 16);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if ((hf * 4 + q) * 16 < ncols) {
            mla_mma(o[2 * (hf * 4 + q)], ph, b[q][0], b[q][1]);
            mla_mma(o[2 * (hf * 4 + q) + 1], ph, b[q][2], b[q][3]);
          }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if ((hf * 4 + q) * 16 < ncols) {
            mla_mma(o[2 * (hf * 4 + q)], pl, b[q][0], b[q][1]);
            mla_mma(o[2 * (hf * 4 + q) + 1], pl, b[q][2], b[q][3]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // 6. a slot walked by one split writes o / l; otherwise the partials,
  // and the last split to arrive merges them in split order
  const bool single = n_need == 1;
  if (heads) {
#pragma unroll
    for (int d = 0; d < 16; ++d)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int h = h0 + hg * 16 + g + 8 * i;
        const int col = col0 + d * 8 + tg * 2;
        if (h >= n_heads || col >= lat) continue;
        if (single) {
          bf16* out = ctx + ((int64_t)t * n_heads + h) * lat + col;
          out[0] = __float2bfloat16(o[d][2 * i] / l[i]);
          if (col + 1 < lat) out[1] = __float2bfloat16(o[d][2 * i + 1] / l[i]);
          continue;
        }
        float* out =
            part_o + (((int64_t)t * n_heads + h) * n_split + split) * lat + col;
        if ((lat & 1) == 0)        // col is even: 8 bytes, aligned
          *reinterpret_cast<float2*>(out) =
              make_float2(o[d][2 * i], o[d][2 * i + 1]);
        else {
          out[0] = o[d][2 * i];
          if (col + 1 < lat) out[1] = o[d][2 * i + 1];
        }
      }
    if (!single && half == 0 && tg == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int h = h0 + hg * 16 + g + 8 * i;
        if (h >= n_heads) continue;
        float* ml = part_ml
            + ((((int64_t)t * n_cb + cb) * n_heads + h) * n_split + split) * 2;
        ml[0] = m[i];
        ml[1] = l[i];
      }
  }
  if (single) return;
  __shared__ int merge;
  __syncthreads();                // every thread's partial is written ...
  if (tid == 0) {
    // ... and, by one fence (cumulative over the barrier), visible before
    // the ticket
    __threadfence();
    int* ticket = tickets + (int64_t)t * gridDim.x + blockIdx.x;
    merge = atomicAdd(ticket, 1) == n_need - 1;
    if (merge) *ticket = 0;       // every split of the group has arrived
  }
  __syncthreads();
  if (!merge) return;
  __threadfence();
  // the merge, in split order.  First each head's split weights, w_s =
  // e^(m_s - M) / sum_s' l_s' e^(m_s' - M), M = max_s m_s, into shared
  // memory (free now; MLA_MAX_SPLIT x MLA_HT floats fit the exchange
  // room alone) ...
  float* wsm = reinterpret_cast<float*>(mla_smem);
  for (int i = tid; i < MLA_HT; i += blockDim.x) {
    const int h = h0 + i;
    if (h >= n_heads) continue;
    const float* ml =
        part_ml + (((int64_t)t * n_cb + cb) * n_heads + h) * n_split * 2;
    float mm = -INFINITY;
    for (int sp = 0; sp < n_need; ++sp) mm = fmaxf(mm, __ldcg(ml + 2 * sp));
    float ll = 0.0f;
    for (int sp = 0; sp < n_need; ++sp)
      ll += __ldcg(ml + 2 * sp + 1) * expf(__ldcg(ml + 2 * sp) - mm);
    for (int sp = 0; sp < n_need; ++sp)
      wsm[i * n_need + sp] = expf(__ldcg(ml + 2 * sp) - mm) / ll;
  }
  __syncthreads();
  // ... then o = sum_s o_s w_s, four columns of MLA_G groups a thread in
  // each of two passes: the groups' loads of one split are all in flight
  // at once
  constexpr int G4 = MLA_CB / 4, MLA_G = MLA_HT * G4 / NT / 2;
  const bool v4 = lat % 4 == 0;
  for (int pass = 0; pass < 2; ++pass) {
    float a[MLA_G][4];
#pragma unroll
    for (int k = 0; k < MLA_G; ++k) a[k][0] = a[k][1] = a[k][2] = a[k][3] = 0.0f;
    for (int s0 = 0; s0 < n_need; s0 += 2) {
      float4 x[2][MLA_G];               // every load of two splits first
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < MLA_G; ++k) {
          const int i = tid + (pass * MLA_G + k) * NT, hl = i / G4;
          const int h = h0 + hl, c = cb * MLA_CB + (i - hl * G4) * 4;
          const float* po = part_o
              + (((int64_t)t * n_heads + h) * n_split + s0 + j) * lat + c;
          x[j][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (s0 + j >= n_need || h >= n_heads || c >= lat) continue;
          if (v4) {
            x[j][k] = __ldcg(reinterpret_cast<const float4*>(po));
          } else {
            float* xe = reinterpret_cast<float*>(&x[j][k]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c + e < lat) xe[e] = __ldcg(po + e);
          }
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (s0 + j >= n_need) break;
#pragma unroll
        for (int k = 0; k < MLA_G; ++k) {       // splits in order
          const int hl = (tid + (pass * MLA_G + k) * NT) / G4;
          const float w = wsm[hl * n_need + s0 + j];
          a[k][0] = fmaf(x[j][k].x, w, a[k][0]);
          a[k][1] = fmaf(x[j][k].y, w, a[k][1]);
          a[k][2] = fmaf(x[j][k].z, w, a[k][2]);
          a[k][3] = fmaf(x[j][k].w, w, a[k][3]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MLA_G; ++k) {
      const int i = tid + (pass * MLA_G + k) * NT, hl = i / G4;
      const int h = h0 + hl, c = cb * MLA_CB + (i - hl * G4) * 4;
      if (h >= n_heads) continue;
      bf16* out = ctx + ((int64_t)t * n_heads + h) * lat;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < lat) out[c + e] = __float2bfloat16(a[k][e]);
    }
  }
}

int launch_mla_mma(const void* q_eff, const void* q_rope, const void* c_new,
                   const void* r_new, void* c_pool, void* r_pool,
                   const int* page_rows, const int* pos, void* ctx,
                   float* part_ml, float* part_o, int* tickets, int bs,
                   int n_heads, int lat, int rope, int ps, int max_pages,
                   int n_pages, int pps, int vec, float scale, void* stream) {
  if (lat < 1 || lat > MLA_MAX_LAT || rope < 1 || rope > MLA_MAX_ROPE
      || n_heads < 1 || ps < 1 || pps < 1 || max_pages < 1
      || (max_pages + pps - 1) / pps > MLA_MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mla_mma_smem_bytes(lat, rope);
  const cudaError_t err = cudaFuncSetAttribute(
      mla_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ht = (n_heads + MLA_HT - 1) / MLA_HT;
  const int n_cb = (lat + MLA_CB - 1) / MLA_CB;
  const dim3 grid(n_ht * n_cb, bs, (max_pages + pps - 1) / pps);
  mla_mma_kernel<<<grid, MLA_MMA_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q_eff, (const bf16*)q_rope, (const bf16*)c_new,
      (const bf16*)r_new, (bf16*)c_pool, (bf16*)r_pool, page_rows, pos,
      (bf16*)ctx, part_ml, part_o, tickets, n_heads, lat, rope, ps, max_pages,
      n_pages, pps, n_cb, vec, scale);
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

// bf16 (the tensor-core kernel): scratch from the wrapper, part_ml (bs,
// ceil(lat / MLA_CB), n_heads, n_split, 2) and part_o (bs, n_heads,
// n_split, lat) float, n_split = ceil(max_pages / pps); tickets (bs,
// ceil(n_heads / MLA_HT) * ceil(lat / MLA_CB)) int32, zero before the
// launch and left zero.  vec: lat and rope are multiples of 8 and every
// operand starts on 16 bytes.
int pa_mla_decode_bf16(const void* q_eff, const void* q_rope,
                       const void* c_new, const void* r_new, void* c_pool,
                       void* r_pool, const int* page_rows, const int* pos,
                       void* ctx, float* part_ml, float* part_o,
                       int* tickets, int bs, int n_heads, int lat, int rope,
                       int ps, int max_pages, int n_pages, int pps, int vec,
                       float scale, void* stream) {
  return launch_mla_mma(q_eff, q_rope, c_new, r_new, c_pool, r_pool,
                        page_rows, pos, ctx, part_ml, part_o, tickets, bs,
                        n_heads, lat, rope, ps, max_pages, n_pages, pps, vec,
                        scale, stream);
}

}  // extern "C"
