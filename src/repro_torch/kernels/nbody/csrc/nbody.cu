// Hand-written Hopper kernels of the Barnes-Hut tree code (paper §4.2):
// K6 acc_pair, K7 acc_self and K8 the task-table walk bh_walk, over the
// shared interaction math of nbody.cuh.  Built for sm_90a by
// repro_torch/_build.py and bound with ctypes by
// repro_torch/kernels/nbody/kernel.py; every launcher returns
// cudaGetLastError() of its launch.
//
// K6 / K7 replace src/repro/kernels/nbody/kernel.py::acc_pair and
// ::acc_self.  The Pallas kernels padded both sets to 128 lanes (ops.py)
// and held the whole source set in VMEM; here the ragged edge is masked,
// so nothing is padded.  What bounds them on this card: on the path's
// shapes (about 30 targets against 30 or 460 sources) a call is a few
// thousand interactions, far below both the fp32 rate and the memory
// rate, so they are latency-bound: the floor is the launch itself.  The
// first form gave each target one thread that walked every source in turn
// (one warp's worth of lanes at work, a dependent chain of rsqrt and FMAs
// as long as the source set).  Now a block covers targets x source
// slices: lane = target and warp = one contiguous slice of each staged
// chunk for ni <= 32 (8 slices, and up to 32 where nj is large, about
// NB_PAIR_SLICE sources a slice), 64 targets and 4 or more slices for
// ni <= 64, 128 targets and 2 or more slices above, with a grid over
// target groups.  A chunk of NB_PAIR_CHUNK sources is staged once for the
// whole block with coalesced loads from the strided views; each thread
// keeps two sources in flight in two accumulators; the slices' partial
// sums of a target are then added in slice order 0, 1, ... by one thread
// through shared memory, so a result repeats bit for bit and does not
// depend on scheduling (no atomics).  One launch a call.  Operands may be
// strided views (a cell's slice of the (3, N) positions, a gather of COM
// rows), so the launchers take the strides and nothing is copied.
//
// K8 replaces src/repro/engine/megakernel.py::_bh_kernel, walked by
// _grid_walk (its pallas_call) from bh_round_fn.  The Pallas walk ran one
// table row after another on one TPU core.  Here the host cuts the table
// into launch groups (repro_torch/engine/descriptors.py::launch_groups):
// runs of whole rounds in which no row's write key is read or written by
// a row of another write key, bucketed by write key in table order.  One
// launch walks one group (6 at the paper's 1M particles, where one launch
// per write-colored phase would take 2,148,304) with one warp per bucket;
// the warp walks its bucket's rows in table order and keeps the
// destination leaf's accelerations in registers across them (a lane per
// target, 32 apart).  So rows that write the same state run in table
// order, and a row never runs before the rows whose writes it reads (they
// sit in earlier launches on the same stream).  What bounds it: pair
// interactions, 19 fp32 operations each, 1.234e9 that the 1M plan's data
// needs, against 67 TFLOP/s: 0.35 ms.  The first form gave a bucket a
// 64-thread block with two barriers a row and walked every source slot of
// the padded (L, 3, P) blocks, 3.674e9 pairs at 1M (3.0x), in one
// dependent chain a thread: 6.4-7.6 ms on an NVIDIA H100 80GB HBM3 at 700
// W.  Now a row walks only its source leaf's real particles (counts, from
// the tree; a pad source has zero mass at a finite position, so it adds
// exactly 0 and skipping it changes no bit of a real target's sum) and
// only the real targets; a warp needs no block barrier (__syncwarp); the
// next step's descriptors and sources (up to NB_BATCH rows, so several
// 8-source PC rows at once) are copied into shared memory by cp.async
// while the current step computes, two rows' pulls in flight in
// independent partial sums that join the running sum in table order.  A
// group's buckets go longest first (the host's bucket_order), so the four
// warps of a block end together.  Measured on an NVIDIA H100 80GB HBM3 at
// 700 W: the 1M plan's 6 launches take 2.35 ms alone (chip_smoke.py,
// tools/compare_walks.py), where the first form's take 4.45 ms on the
// same card; the round function, its table checks, bucket order and
// uploads with them, 6.9 ms.

#include <cstdint>

#include "nbody.cuh"

namespace {

// targets one K6/K7 block covers (a power of two); the block's other
// threads are source slices: 8 of them up to 32 targets, 4 up to 64, 2
// above ...
inline int nb_pair_targets(int ni) {
  return ni <= 32 ? 32 : (ni <= 64 ? 64 : 128);
}

// ... and twice as many, up to NB_PAIR_MAX_THREADS threads, while a slice
// would walk more than NB_PAIR_SLICE sources: the block's threads
inline int nb_pair_threads(int ti, int nj) {
  int slices = NB_PAIR_THREADS / ti;
  while (slices * ti < NB_PAIR_MAX_THREADS && slices * NB_PAIR_SLICE < nj)
    slices *= 2;
  return slices * ti;
}

// one source j of the staged planes s on the target (px, py, pz), into
// (ax, ay, az); the source `skip` (the target itself in a self set)
// weighs zero
__device__ __forceinline__ void nb_pull(const float (*s)[NB_PAIR_CHUNK],
                                        int j, int skip, float px, float py,
                                        float pz, float eps2, float& ax,
                                        float& ay, float& az) {
  const float dx = s[0][j] - px;
  const float dy = s[1][j] - py;
  const float dz = s[2][j] - pz;
  const float r2 = dx * dx + dy * dy + dz * dz + eps2;
  float w = rsqrtf(r2);
  w = w * w * w * s[3][j];
  if (j == skip) w = 0.0f;
  ax += dx * w;
  ay += dy * w;
  az += dz * w;
}

// K6 (SELF = false) and K7 (SELF = true): out (3, ni) contiguous gets the
// pull of the sources (xj, mj) on the targets xi; x operands are (3, n)
// with strides (sd, sn), masses (n) with stride sm.  K7 takes xj = xi.
// ti = nb_pair_targets(ni): thread x is target x % ti of the block's
// group and slice x / ti of every staged chunk.
template <bool SELF>
__global__ void __launch_bounds__(NB_PAIR_MAX_THREADS)
acc_kernel(const float* __restrict__ xi, int64_t sdi, int64_t sni, int ni,
           const float* __restrict__ xj, int64_t sdj, int64_t snj,
           const float* __restrict__ mj, int64_t smj, int nj, float eps2,
           float* __restrict__ out, int ti) {
  __shared__ float s[4][NB_PAIR_CHUNK];
  __shared__ float part[3][NB_PAIR_MAX_THREADS];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lg = __ffs(ti) - 1;                  // ti is a power of two
  const int tl = tid & (ti - 1), slice = tid >> lg;
  const int n_slices = nt >> lg;
  const int i = blockIdx.x * ti + tl;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (i < ni) {
    px = xi[i * sni];
    py = xi[sdi + i * sni];
    pz = xi[2 * sdi + i * sni];
  }
  // two accumulators: sources j and j + 1 of the slice are in flight at
  // once
  float ax = 0.0f, ay = 0.0f, az = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
  for (int j0 = 0; j0 < nj; j0 += NB_PAIR_CHUNK) {
    const int n = min(NB_PAIR_CHUNK, nj - j0);
    __syncthreads();  // the previous chunk has been read by every thread
    for (int t = tid; t < n; t += nt) {
      const int64_t j = j0 + t;
      s[0][t] = xj[j * snj];
      s[1][t] = xj[sdj + j * snj];
      s[2][t] = xj[2 * sdj + j * snj];
      s[3][t] = mj[j * smj];
    }
    __syncthreads();
    const int per = (n + n_slices - 1) / n_slices;   // the slice's range
    const int lo = min(n, slice * per), hi = min(n, lo + per);
    const int skip = SELF ? i - j0 : -1;
    if (i < ni) {
      int j = lo;
#pragma unroll 2
      for (; j + 1 < hi; j += 2) {
        nb_pull(s, j, skip, px, py, pz, eps2, ax, ay, az);
        nb_pull(s, j + 1, skip, px, py, pz, eps2, bx, by, bz);
      }
      if (j < hi) nb_pull(s, j, skip, px, py, pz, eps2, ax, ay, az);
    }
  }
  part[0][tid] = ax + bx;
  part[1][tid] = ay + by;
  part[2][tid] = az + bz;
  __syncthreads();
  if (slice == 0 && i < ni) {        // slices 0, 1, ... in order
    float sx = part[0][tl], sy = part[1][tl], sz = part[2][tl];
    for (int k = 1; k < n_slices; ++k) {
      sx += part[0][k * ti + tl];
      sy += part[1][k * ti + tl];
      sz += part[2][k * ti + tl];
    }
    out[i] = sx;
    out[ni + i] = sy;
    out[2 * ni + i] = sz;
  }
}

// sources a staging slot of the walk holds: a PC row stages 8 COM
// sources even when the leaf blocks hold fewer particles
__host__ __device__ inline int nb_plane(int P) {
  return P > NB_MAX_CHILDREN ? P : NB_MAX_CHILDREN;
}

// rows of a bucket the walk stages in one step (at most NB_BATCH), and
// warps (buckets) a block: a warp's two steps take at most 8 KB
__host__ __device__ inline int nb_batch(int P) {
  const int plane = nb_plane(P);
  return plane <= 64 ? NB_BATCH : (plane <= 128 ? 2 : 1);
}
inline int nb_warps(int P) { return nb_plane(P) > 256 ? 1 : 4; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// one source s = (x, y, z, m) on the target (px, py, pz), into (ax, ay,
// az): nb_pull's arithmetic on a packed source; skip weighs it zero
__device__ __forceinline__ void nb_pull4(float4 s, bool skip, float px,
                                         float py, float pz, float eps2,
                                         float& ax, float& ay, float& az) {
  const float dx = s.x - px;
  const float dy = s.y - py;
  const float dz = s.z - pz;
  const float r2 = dx * dx + dy * dy + dz * dz + eps2;
  float w = rsqrtf(r2);
  w = w * w * w * s.w;
  if (skip) w = 0.0f;
  ax += dx * w;
  ay += dy * w;
  az += dz * w;
}

// The rows of one step of an acc bucket (rows q .. q + nr - 1, nr <= rb)
// into a warp's staging slots dst[r * plane ..] as (x, y, z, m): a PC
// row's real COM sources (its cells up to the last that is not the pad
// cell), a PP or SELF row's whole source block (cp.async, 4 bytes each,
// nothing waited for).  n[r] gets each row's real source count (the
// source leaf's count from counts, loaded here and read a step later) and
// self bit r whether row r is a SELF row; other types get n 0.
__device__ __forceinline__ void bh_stage(const int* __restrict__ desc,
                                         int width, int q, int nr,
                                         const float* __restrict__ xs,
                                         const float* __restrict__ ms,
                                         const int* __restrict__ counts,
                                         const float* com, const float* cmass,
                                         int P, int plane, int pad_cell,
                                         int cnt, float4* dst,
                                         int (&n)[NB_BATCH], int& self) {
  const int lane = threadIdx.x & 31;
  self = 0;
#pragma unroll
  for (int r = 0; r < NB_BATCH; ++r) {
    n[r] = 0;
    if (r >= nr) continue;
    const int* row = desc + (int64_t)(q + r) * width;
    const int et = __ldg(row);
    float* d = reinterpret_cast<float*>(dst + r * plane);
    if (et == BH_PC) {           // [leaf, s0..s7]: up to 8 COM sources
      const int c = lane < NB_MAX_CHILDREN ? __ldg(row + 2 + lane) : pad_cell;
      const unsigned real = __ballot_sync(0xffffffffu, c != pad_cell);
      n[r] = real ? 32 - __clz(real) : 0;
      if (lane < n[r]) {
        cp_async4(d + 4 * lane, com + 3 * (int64_t)c);
        cp_async4(d + 4 * lane + 1, com + 3 * (int64_t)c + 1);
        cp_async4(d + 4 * lane + 2, com + 3 * (int64_t)c + 2);
        cp_async4(d + 4 * lane + 3, cmass + c);
      }
    } else if (et == BH_PP || et == BH_SELF) {   // [leaf(, leaf_j)]
      const int64_t src = __ldg(row + (et == BH_PP ? 2 : 1));
      n[r] = et == BH_SELF ? cnt : __ldg(counts + src);
      if (et == BH_SELF) self |= 1 << r;
      for (int t = lane; t < P; t += 32) {
        const int64_t o = src * 3 * P + t;
        cp_async4(d + 4 * t, xs + o);
        cp_async4(d + 4 * t + 1, xs + o + P);
        cp_async4(d + 4 * t + 2, xs + o + 2 * P);
        cp_async4(d + 4 * t + 3, ms + src * P + t);
      }
    }
  }
}

// K8: the buckets bucket_order[b0 .. b1 - 1] of the bucket CSR
// (bucket_ptr) over the bucket-ordered rows of desc (width int32 columns
// each), one warp a bucket, blockDim / 32 buckets a block (the host orders
// a group's buckets longest first, so a block's warps end together).  State: xs (L, 3, P) and ms (L,
// P) zero-mass-padded leaf blocks and counts (L) their real sizes (read
// only), acc (L, 3, P), com (ncells + 1, 3), cmass (ncells + 1, 1),
// updated in place; pad_cell = ncells, the zero-mass pad of COM_INNER and
// PC rows.  A bucket's rows share their write key (launch_groups), so it
// holds COM rows of one cell or acc rows of one leaf.  Lane l owns target
// particles l, l + 32, ... below the leaf's count (T a lane at most); the
// pad targets' acc is never read or written.  rb rows are staged a step,
// two steps' slots a warp (dynamic shared memory).
template <int T>
__global__ void __launch_bounds__(128)
bh_walk_kernel(const int* __restrict__ desc, int width,
               const int* __restrict__ bucket_ptr,
               const int* __restrict__ bucket_order, int b0, int b1,
               const float* __restrict__ xs, const float* __restrict__ ms,
               const int* __restrict__ counts, float* acc, float* com,
               float* cmass, int P, int pad_cell, float eps2) {
  extern __shared__ float4 nb_slots[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = b0 + blockIdx.x * (blockDim.x >> 5) + warp;
  if (pos >= b1) return;
  const int b = bucket_order[pos];
  const int q0 = bucket_ptr[b], q1 = bucket_ptr[b + 1];
  if (q0 >= q1) return;
  const int et0 = __ldg(desc + (int64_t)q0 * width);
  if (et0 == BH_COM_LEAF || et0 == BH_COM_INNER) {
    if (lane != 0) return;
    for (int q = q0; q < q1; ++q) {
      const int* row = desc + (int64_t)q * width;
      const int et = row[0], w = row[1];
      float tot = 0.0f, cx = 0.0f, cy = 0.0f, cz = 0.0f;
      if (et == BH_COM_LEAF) {           // [cell, leaf]: its real particles
        const int64_t s = row[2];        // (a pad adds exactly 0)
        const float* x = xs + s * 3 * P;
        const float* m = ms + s * P;
        const int n = counts[s];
        for (int t = 0; t < n; ++t) {
          tot += m[t];
          cx += x[t] * m[t];
          cy += x[P + t] * m[t];
          cz += x[2 * P + t] * m[t];
        }
      } else if (et == BH_COM_INNER) {   // [cell, c0..c7]
        for (int k = 0; k < NB_MAX_CHILDREN; ++k) {
          const int64_t c = row[2 + k];
          const float m = cmass[c];
          tot += m;
          cx += com[3 * c] * m;
          cy += com[3 * c + 1] * m;
          cz += com[3 * c + 2] * m;
        }
      } else {
        continue;                        // BH_NOOP and anything out of range
      }
      const float d = fmaxf(tot, 1e-30f);
      com[3 * (int64_t)w] = cx / d;
      com[3 * (int64_t)w + 1] = cy / d;
      com[3 * (int64_t)w + 2] = cz / d;
      cmass[w] = tot;
    }
    return;
  }
  if (et0 < BH_SELF || et0 > BH_PC) return;   // no-op rows only
  const int leaf = __ldg(desc + (int64_t)q0 * width + 1);
  const int cnt = __ldg(counts + leaf);
  const int groups = (cnt + 31) / 32;   // target groups with a real target
  const int plane = nb_plane(P), rb = nb_batch(P);
  float4* slots = nb_slots + (size_t)warp * 2 * rb * plane;
  float px[T], py[T], pz[T], ax[T], ay[T], az[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = lane + 32 * t;
    px[t] = py[t] = pz[t] = ax[t] = ay[t] = az[t] = 0.0f;
    if (i < cnt) {
      const int64_t o = (int64_t)leaf * 3 * P + i;
      ax[t] = acc[o];
      ay[t] = acc[o + P];
      az[t] = acc[o + 2 * P];
      px[t] = xs[o];
      py[t] = xs[o + P];
      pz[t] = xs[o + 2 * P];
    }
  }
  // a two-step pipeline: step k + 1's sources are copied (and its counts
  // loaded) while step k computes, step k + 2's rows prefetched into L1
  int n_cur[NB_BATCH] = {}, n_nxt[NB_BATCH] = {}, self_cur = 0, self_nxt = 0;
  const int nsteps = (q1 - q0 + rb - 1) / rb;
  bh_stage(desc, width, q0, min(rb, q1 - q0), xs, ms, counts, com, cmass, P,
           plane, pad_cell, cnt, slots, n_cur, self_cur);
  cp_async_commit();
  for (int k = 0; k < nsteps; ++k) {
    const int q = q0 + k * rb, nr = min(rb, q1 - q);
    if (k + 1 < nsteps)
      bh_stage(desc, width, q + rb, min(rb, q1 - q - rb), xs, ms, counts,
               com, cmass, P, plane, pad_cell, cnt,
               slots + ((k + 1) & 1) * rb * plane, n_nxt, self_nxt);
    cp_async_commit();
    if (lane < rb && q + 2 * rb + lane < q1)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(
          desc + (int64_t)(q + 2 * rb + lane) * width));
    cp_async_wait1();
    __syncwarp();
    const float4* st = slots + (k & 1) * rb * plane;
    // rows r and r + 1 in flight at once, each into its own partial sums
    // (one a target group of 32), a source read once for every group; the
    // partials join the running sum in table order, as the plain walk
    // adds each row's pull
#pragma unroll
    for (int r = 0; r < NB_BATCH; r += 2) {
      if (r >= nr) break;
      const float4* s0 = st + r * plane;
      const float4* s1 = s0 + plane;
      const int n0 = n_cur[r], n1 = r + 1 < nr ? n_cur[r + 1] : 0;
      const int nmin = min(n0, n1);
      // the source index a target skips in a SELF row (its own), else -1
      const int k0 = (self_cur >> r) & 1 ? lane : -1 - 32 * T;
      const int k1 = (self_cur >> (r + 1)) & 1 ? lane : -1 - 32 * T;
      float a0[T][3], a1[T][3];
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int c = 0; c < 3; ++c) a0[t][c] = a1[t][c] = 0.0f;
      int j = 0;
#pragma unroll 2
      for (; j < nmin; ++j) {
        const float4 u0 = s0[j], u1 = s1[j];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          if (t >= groups) break;
          nb_pull4(u0, j == k0 + 32 * t, px[t], py[t], pz[t], eps2, a0[t][0],
                   a0[t][1], a0[t][2]);
          nb_pull4(u1, j == k1 + 32 * t, px[t], py[t], pz[t], eps2, a1[t][0],
                   a1[t][1], a1[t][2]);
        }
      }
      for (int jj = j; jj < n0; ++jj) {
        const float4 u0 = s0[jj];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          if (t >= groups) break;
          nb_pull4(u0, jj == k0 + 32 * t, px[t], py[t], pz[t], eps2,
                   a0[t][0], a0[t][1], a0[t][2]);
        }
      }
      for (int jj = j; jj < n1; ++jj) {
        const float4 u1 = s1[jj];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          if (t >= groups) break;
          nb_pull4(u1, jj == k1 + 32 * t, px[t], py[t], pz[t], eps2,
                   a1[t][0], a1[t][1], a1[t][2]);
        }
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        ax[t] += a0[t][0];
        ay[t] += a0[t][1];
        az[t] += a0[t][2];
        ax[t] += a1[t][0];
        ay[t] += a1[t][1];
        az[t] += a1[t][2];
      }
    }
    __syncwarp();                // every lane is done with this step's slots
#pragma unroll
    for (int r = 0; r < NB_BATCH; ++r) n_cur[r] = n_nxt[r];
    self_cur = self_nxt;
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = lane + 32 * t;
    if (i < cnt) {
      const int64_t o = (int64_t)leaf * 3 * P + i;
      acc[o] = ax[t];
      acc[o + P] = ay[t];
      acc[o + 2 * P] = az[t];
    }
  }
}

template <int T>
int bh_launch(const int* desc, int width, const int* bucket_ptr,
              const int* bucket_order, int b0, int nb, const float* xs,
              const float* ms, const int* counts,
              float* acc, float* com, float* cmass, int P, int pad_cell,
              float eps2, cudaStream_t stream) {
  const int warps = nb_warps(P);
  const size_t smem = sizeof(float4) * warps * 2 * nb_batch(P) * nb_plane(P);
  bh_walk_kernel<T><<<(nb + warps - 1) / warps, 32 * warps, smem, stream>>>(
      desc, width, bucket_ptr, bucket_order, b0, b0 + nb, xs, ms, counts, acc,
      com, cmass, P, pad_cell, eps2);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes by repro_torch/kernels/nbody/kernel.py.
extern "C" {

// K6 and K7: one launch of ceil(ni / nb_pair_targets(ni)) blocks of
// nb_pair_threads threads; nj may be 0 (the output is then zero).
int nb_acc_pair(const float* xi, int64_t sdi, int64_t sni, int ni,
                const float* xj, int64_t sdj, int64_t snj, const float* mj,
                int64_t smj, int nj, float eps2, float* out, void* stream) {
  const int ti = nb_pair_targets(ni);
  acc_kernel<false><<<(ni + ti - 1) / ti, nb_pair_threads(ti, nj), 0,
                      (cudaStream_t)stream>>>(xi, sdi, sni, ni, xj, sdj, snj,
                                              mj, smj, nj, eps2, out, ti);
  return (int)cudaGetLastError();
}

int nb_acc_self(const float* x, int64_t sd, int64_t sn, const float* m,
                int64_t sm, int n, float eps2, float* out, void* stream) {
  const int ti = nb_pair_targets(n);
  acc_kernel<true><<<(n + ti - 1) / ti, nb_pair_threads(ti, n), 0,
                     (cudaStream_t)stream>>>(x, sd, sn, n, x, sd, sn, m, sm,
                                             n, eps2, out, ti);
  return (int)cudaGetLastError();
}

// One launch walks buckets bucket_order[b0 .. b0 + nb - 1]: one warp a
// bucket, nb_warps(P)
// a block, T = ceil(P / 32) targets a lane at most (rounded up to a power
// of two; P <= NB_MAX_P).
int bh_walk(const int* desc, int width, const int* bucket_ptr,
            const int* bucket_order, int b0, int nb, const float* xs,
            const float* ms, const int* counts,
            float* acc, float* com, float* cmass, int P, int pad_cell,
            float eps2, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define NB_WALK(T)                                                         \
  return bh_launch<T>(desc, width, bucket_ptr, bucket_order, b0, nb, xs,   \
                      ms, counts, acc, com, cmass, P, pad_cell, eps2, st)
  if (P <= 32) NB_WALK(1);
  if (P <= 64) NB_WALK(2);
  if (P <= 128) NB_WALK(4);
  if (P <= 256) NB_WALK(8);
  if (P <= 512) NB_WALK(16);
  NB_WALK(32);
#undef NB_WALK
}

}  // extern "C"
