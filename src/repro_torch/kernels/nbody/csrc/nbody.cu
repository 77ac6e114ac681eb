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
// launch walks one group with one block per bucket; the block walks its
// bucket's rows in table order and keeps the destination leaf's
// accelerations in registers across them (one thread per particle).  So
// rows that write the same state run in table order, and a row never runs
// before the rows whose writes it reads (they sit in earlier launches on
// the same stream); 40 launches at most at the paper's 1M particles where
// one launch per write-colored phase would take 2,148,304.  What bounds
// it: pair interactions, 19 fp32 operations each (3.7e9 of them in the
// padded 1M walk, 1.2e9 that the data needs), against 67 TFLOP/s: a bound
// of 0.35 ms; the source block of a row is read once into shared memory
// and used by every target thread.  Measured by chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700 W: 7.1-7.6 ms for the 1M plan (6 launches), so
// the walk is latency-bound (one 64-thread block per bucket, two barriers
// per row); K6/K7 (first form) took 2.2-2.7 us on the device at 30 x 30
// and 12 us at 30 x 460 against a 17-28 us launch from Python.

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

// floats in each shared-memory plane of the walk: a PC row stages 8 COM
// sources even when the leaf blocks hold fewer particles
__host__ __device__ inline int nb_plane(int P) {
  return P > NB_MAX_CHILDREN ? P : NB_MAX_CHILDREN;
}

// K8: blocks b0 .. b0 + gridDim.x - 1 of the bucket CSR (bucket_ptr) over
// the bucket-ordered rows of desc (width int32 columns each).  State:
// xs (L, 3, P) and ms (L, P) zero-mass-padded leaf blocks (read only),
// acc (L, 3, P), com (ncells + 1, 3), cmass (ncells + 1, 1), updated in
// place.  Shared memory: one source block (P particles, or a PC row's 8
// COMs) as four planes of nb_plane(P) floats.
__global__ void bh_walk_kernel(const int* __restrict__ desc, int width,
                               const int* __restrict__ bucket_ptr, int b0,
                               const float* __restrict__ xs,
                               const float* __restrict__ ms, float* acc,
                               float* com, float* cmass, int P, float eps2) {
  extern __shared__ float smem[];
  const int plane = nb_plane(P);
  float* sx = smem;
  float* sy = smem + plane;
  float* sz = smem + 2 * plane;
  float* sm = smem + 3 * plane;
  const int b = b0 + blockIdx.x;
  const int q0 = bucket_ptr[b], q1 = bucket_ptr[b + 1];
  const int i = threadIdx.x;
  const bool own = i < P;        // this thread owns target particle i
  int leaf = -1;                 // the bucket's leaf, once an acc row came
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int q = q0; q < q1; ++q) {
    const int* row = desc + (int64_t)q * width;
    const int et = row[0], w = row[1];
    if (et == BH_SELF || et == BH_PP || et == BH_PC) {
      if (leaf < 0) {            // first acc row: load the running sums
        leaf = w;
        if (own) {
          const int64_t o = (int64_t)leaf * 3 * P + i;
          ax = acc[o];
          ay = acc[o + P];
          az = acc[o + 2 * P];
          px = xs[o];
          py = xs[o + P];
          pz = xs[o + 2 * P];
        }
      }
      int n = P, skip = -1;
      __syncthreads();           // the previous row's sources are consumed
      if (et == BH_PC) {         // [leaf, s0..s7]: up to 8 COM sources
        n = NB_MAX_CHILDREN;
        if (i < NB_MAX_CHILDREN) {
          const int64_t c = row[2 + i];
          sx[i] = com[3 * c];
          sy[i] = com[3 * c + 1];
          sz[i] = com[3 * c + 2];
          sm[i] = cmass[c];
        }
      } else {                   // SELF [leaf] or PP [leaf_i, leaf_j]
        const int64_t src = et == BH_PP ? row[2] : w;
        if (et == BH_SELF) skip = i;
        for (int t = i; t < P; t += blockDim.x) {
          const int64_t o = src * 3 * P + t;
          sx[t] = xs[o];
          sy[t] = xs[o + P];
          sz[t] = xs[o + 2 * P];
          sm[t] = ms[src * P + t];
        }
      }
      __syncthreads();
      if (own) {                 // acc[leaf] += this row's pull, as the
        float rx = 0.0f, ry = 0.0f, rz = 0.0f;   // plain walk adds it
        nb_accumulate(sx, sy, sz, sm, n, skip, px, py, pz, eps2, rx, ry, rz);
        ax += rx;
        ay += ry;
        az += rz;
      }
    } else if (et == BH_COM_LEAF && i == 0) {   // [cell, leaf]
      const int64_t s = row[2];
      const float* x = xs + s * 3 * P;
      const float* m = ms + s * P;
      float tot = 0.0f, cx = 0.0f, cy = 0.0f, cz = 0.0f;
      for (int t = 0; t < P; ++t) {
        tot += m[t];
        cx += x[t] * m[t];
        cy += x[P + t] * m[t];
        cz += x[2 * P + t] * m[t];
      }
      const float d = fmaxf(tot, 1e-30f);
      com[3 * (int64_t)w] = cx / d;
      com[3 * (int64_t)w + 1] = cy / d;
      com[3 * (int64_t)w + 2] = cz / d;
      cmass[w] = tot;
    } else if (et == BH_COM_INNER && i == 0) {  // [cell, c0..c7]
      float tot = 0.0f, cx = 0.0f, cy = 0.0f, cz = 0.0f;
      for (int k = 0; k < NB_MAX_CHILDREN; ++k) {
        const int64_t c = row[2 + k];
        const float m = cmass[c];
        tot += m;
        cx += com[3 * c] * m;
        cy += com[3 * c + 1] * m;
        cz += com[3 * c + 2] * m;
      }
      const float d = fmaxf(tot, 1e-30f);
      com[3 * (int64_t)w] = cx / d;
      com[3 * (int64_t)w + 1] = cy / d;
      com[3 * (int64_t)w + 2] = cz / d;
      cmass[w] = tot;
    }
    // BH_NOOP and any type out of range: no-op
  }
  if (leaf >= 0 && own) {
    const int64_t o = (int64_t)leaf * 3 * P + i;
    acc[o] = ax;
    acc[o + P] = ay;
    acc[o + 2 * P] = az;
  }
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

// One launch walks buckets [b0, b0 + nb): blockDim is P rounded up to a
// whole warp (P <= NB_MAX_P), shared memory four planes of nb_plane(P).
int bh_walk(const int* desc, int width, const int* bucket_ptr, int b0,
            int nb, const float* xs, const float* ms, float* acc, float* com,
            float* cmass, int P, float eps2, void* stream) {
  const int threads = ((P + 31) / 32) * 32;
  bh_walk_kernel<<<nb, threads, 4 * nb_plane(P) * sizeof(float),
                   (cudaStream_t)stream>>>(desc, width, bucket_ptr, b0, xs,
                                           ms, acc, com, cmass, P, eps2);
  return (int)cudaGetLastError();
}

}  // extern "C"
