// Tiled-QR kernels for Hopper (sm_90a): the four tile ops as batched
// per-op kernels, and the task-table walk as one persistent launch.
//
// Replaces the TPU kernels
//   src/repro/kernels/qr_tile/kernel.py::geqrf, tsqrf, apply_qt, apply_tsqt
//     (one pallas_call per tile op; here blockIdx.x indexes a batch of
//     tiles, so one launch serves both run_one and the batched rounds mode)
//   src/repro/engine/megakernel.py::qr_round_fn -> _grid_walk + _qr_kernel
//     (the ragged walk over [etype, s0, s1, s2] rows, one dispatch a plan;
//     here qr_walk is one cooperative launch a plan: its blocks stride
//     over the rows of each write-colored phase and meet at a grid-wide
//     barrier between phases.  The TPU relied on its grid running in
//     order; CUDA blocks run concurrently, so the barrier is what
//     serialises phases.)
//
// What bounds it on an H100: the walk's time is the sum over its phases
// of the slowest row (125 phases a 2048^2 plan, 93 of them holding a panel
// factorization), so it is bound by the latency of one tile body and of
// the barrier, not by bytes (0.22 ms for the whole plan's operations at
// the fp32 rate) or by flops.  What the design does about it: the tile
// bodies (qr_tile.cuh) keep each chain short — panels with one block
// barrier a column and T built after the loop, products register-blocked
// 4 x 4 a thread from float4 shared-memory reads — and the walk is one
// launch, so no phase waits on a host launch.  Two blocks fit an SM at b
// <= 64 (six 18 KB tile slots), one past it (the wide bodies' registers);
// the grid is every resident block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, for the shared
// memory the body that runs takes), capped at the longest phase, and a
// phase with more rows than the grid takes them in turns.  A tile a row
// reads may have been written by another SM in an earlier phase, and L1
// is not coherent across SMs: every tile and T load bypasses L1 (__ldcg);
// the grid barrier orders the writes.
//
// Tiles wider than QR_MAX_B run the blocked bodies of qr_tile.cuh on the
// tiles in global memory, in place, through their own shared-memory
// layout (qr_wide_floats): every kernel and the walk choose the body by
// b, so at any b the four modes run one body per op.  The per-op kernels
// copy their inputs into their outputs and run the body there, as the
// walk runs it on the tile stack.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "qr_tile.cuh"

namespace cg = cooperative_groups;

namespace {

struct Slots {
  float* t[QR_TILES];
  float *vbuf, *taus;
};

__device__ __forceinline__ Slots qr_slots(int b) {
  Slots s;
  const int ts = qr_slot_floats(b);
  for (int k = 0; k < QR_TILES; ++k) s.t[k] = qr_smem + k * ts;
  s.vbuf = qr_smem + QR_TILES * ts;      // 2 x QR_MAX_B
  s.taus = s.vbuf + 2 * QR_MAX_B;        // QR_MAX_B
  return s;
}

// global (b,b) row-major -> shared tile, every load in flight at once and
// past L1 (another SM may have written the tile since this one read it)
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int b) {
  const int ld = qr_ld(b);
  float x[QR_MAX_B * QR_MAX_B / QR_THREADS];
#pragma unroll
  for (int k = 0; k < QR_MAX_B * QR_MAX_B / QR_THREADS; ++k) {
    const int e = threadIdx.x + k * QR_THREADS, i = e >> 6, c = e & 63;
    x[k] = i < b && c < b ? __ldcg(src + i * b + c) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < QR_MAX_B * QR_MAX_B / QR_THREADS; ++k) {
    const int e = threadIdx.x + k * QR_THREADS, i = e >> 6, c = e & 63;
    if (i < b && c < b) dst[i * ld + c] = x[k];
  }
}

__device__ __forceinline__ void store_tile(float* dst, const float* src,
                                           int b) {
  const int ld = qr_ld(b);
#pragma unroll
  for (int k = 0; k < QR_MAX_B * QR_MAX_B / QR_THREADS; ++k) {
    const int e = threadIdx.x + k * QR_THREADS, i = e >> 6, c = e & 63;
    if (i < b && c < b) dst[i * b + c] = src[i * ld + c];
  }
}

__device__ __forceinline__ void store_vec(float* dst, const float* src,
                                          int b) {
  for (int i = threadIdx.x; i < b; i += QR_THREADS) dst[i] = src[i];
}

// b > QR_MAX_B: a (b,b) tile global -> global, ahead of a wide body that
// works on dst in place (the caller syncs); 16 loads in flight a thread
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int b) {
  const int n = b * b;
  for (int e0 = threadIdx.x; e0 < n; e0 += 16 * QR_THREADS) {
    float x[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int e = e0 + k * QR_THREADS;
      x[k] = e < n ? __ldcg(src + e) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int e = e0 + k * QR_THREADS;
      if (e < n) __stcg(dst + e, x[k]);
    }
  }
}

__global__ void __launch_bounds__(QR_THREADS, 2)
geqrf_kernel(const float* a, float* rv, float* tau, float* t, int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  Slots s = qr_slots(b);
  load_tile(s.t[0], a + off, b);
  __syncthreads();
  geqrf_tile(s.t[0], s.t[1], s.taus, s.t[2], s.t[3], s.vbuf, b);
  store_tile(rv + off, s.t[0], b);
  store_tile(t + off, s.t[1], b);
  store_vec(tau + (size_t)blockIdx.x * b, s.taus, b);
}

__global__ void __launch_bounds__(QR_THREADS, 2)
tsqrf_kernel(const float* r, const float* a, float* r1, float* v2,
             float* tau, float* t, int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  Slots s = qr_slots(b);
  load_tile(s.t[0], r + off, b);
  load_tile(s.t[1], a + off, b);
  __syncthreads();
  tsqrf_tile(s.t[0], s.t[1], s.t[2], s.taus, s.t[3], s.t[4], s.vbuf, b);
  store_tile(r1 + off, s.t[0], b);
  store_tile(v2 + off, s.t[1], b);
  store_tile(t + off, s.t[2], b);
  store_vec(tau + (size_t)blockIdx.x * b, s.taus, b);
}

__global__ void __launch_bounds__(QR_THREADS, 2)
apply_qt_kernel(const float* rv, const float* t, const float* c, float* out,
                int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  Slots s = qr_slots(b);
  load_tile(s.t[0], rv + off, b);
  load_tile(s.t[1], t + off, b);
  load_tile(s.t[2], c + off, b);
  __syncthreads();
  apply_qt_tile(s.t[0], s.t[1], s.t[2], s.t[3], s.t[4], s.t[5], b);
  store_tile(out + off, s.t[2], b);
}

__global__ void __launch_bounds__(QR_THREADS, 2)
apply_tsqt_kernel(const float* v2, const float* t, const float* c1,
                  const float* c2, float* o1, float* o2, int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  Slots s = qr_slots(b);
  load_tile(s.t[0], v2 + off, b);
  load_tile(s.t[1], t + off, b);
  load_tile(s.t[2], c1 + off, b);
  load_tile(s.t[3], c2 + off, b);
  __syncthreads();
  apply_tsqt_tile(s.t[0], s.t[1], s.t[2], s.t[3], s.t[4], s.t[5], b);
  store_tile(o1 + off, s.t[2], b);
  store_tile(o2 + off, s.t[3], b);
}

// columns chunk * 64 .. + 63 of a (b,b) tile global -> global (the caller
// syncs): an apply's work item past QR_OUTER_MIN_B copies only its chunk
__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           int b, int chunk) {
  const int c0 = chunk * QR_MAX_B, nc = min(QR_MAX_B, b - c0), n = b * 64;
  for (int e0 = threadIdx.x; e0 < n; e0 += 16 * QR_THREADS) {
    float x[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int e = e0 + k * QR_THREADS, i = e >> 6, c = e & 63;
      x[k] = e < n && c < nc ? __ldcg(src + (size_t)i * b + c0 + c) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int e = e0 + k * QR_THREADS, i = e >> 6, c = e & 63;
      if (e < n && c < nc) __stcg(dst + (size_t)i * b + c0 + c, x[k]);
    }
  }
}

// an apply kernel's copy of its operand: the tile, or past QR_OUTER_MIN_B
// the chunk blockIdx.y
__device__ __forceinline__ void copy_item(float* dst, const float* src,
                                          int b) {
  if (qr_apply_chunks(b) > 1)
    copy_chunk(dst, src, b, blockIdx.y);
  else
    copy_tile(dst, src, b);
}

// b > QR_MAX_B: the blocked bodies, in kernels of their own, one block an
// SM (__launch_bounds__(QR_THREADS, 1)): a panel column's 32 rows a thread
// sit in double registers, which at 128 registers a thread spilled to
// local memory inside every column step.  The per-op kernels copy their
// inputs into their outputs and run the body there; the applies' grid is
// (tiles, qr_apply_chunks(b)), a block a tile's 64-column chunk past
// QR_OUTER_MIN_B.
__global__ void __launch_bounds__(QR_THREADS, 1)
geqrf_wide_kernel(const float* a, float* rv, float* tau, float* t, int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  QR_STAMP(9);
  copy_tile(rv + off, a + off, b);
  __syncthreads();
  QR_STAMP(10);
  geqrf_blocked(rv + off, t + off, tau + (size_t)blockIdx.x * b, b);
}

__global__ void __launch_bounds__(QR_THREADS, 1)
tsqrf_wide_kernel(const float* r, const float* a, float* r1, float* v2,
                  float* tau, float* t, int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  QR_STAMP(9);
  copy_tile(r1 + off, r + off, b);
  copy_tile(v2 + off, a + off, b);
  __syncthreads();
  QR_STAMP(10);
  tsqrf_blocked(r1 + off, v2 + off, t + off, tau + (size_t)blockIdx.x * b,
                b);
}

__global__ void __launch_bounds__(QR_THREADS, 1)
apply_qt_wide_kernel(const float* rv, const float* t, const float* c,
                     float* out, int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  QR_STAMP(9);
  copy_item(out + off, c + off, b);
  __syncthreads();
  QR_STAMP(10);
  apply_qt_wide(rv + off, t + off, out + off, b, blockIdx.y);
}

__global__ void __launch_bounds__(QR_THREADS, 1)
apply_tsqt_wide_kernel(const float* v2, const float* t, const float* c1,
                       const float* c2, float* o1, float* o2, int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  QR_STAMP(9);
  copy_item(o1 + off, c1 + off, b);
  copy_item(o2 + off, c2 + off, b);
  __syncthreads();
  QR_STAMP(10);
  apply_tsqt_wide(v2 + off, t + off, o1 + off, o2 + off, b, blockIdx.y);
}

// One row [etype, s0, s1, s2] of the table, by the whole block, b >
// QR_MAX_B: the wide bodies on the tile stack in place; an apply row's
// work item chunk (qr_row_items).
__device__ __forceinline__ void qr_row_wide(const int* row, int chunk,
                                            float* tiles, float* tmat,
                                            int b) {
  const size_t bb = (size_t)b * b;
  const size_t s0 = row[1] * bb, s1 = row[2] * bb, s2 = row[3] * bb;
  switch (row[0]) {
    case 0:  // GEQRF [kk]
      geqrf_blocked(tiles + s0, tmat + s0, nullptr, b);
      break;
    case 1:  // LARFT [kk, kj]
      apply_qt_wide(tiles + s0, tmat + s0, tiles + s1, b, chunk);
      break;
    case 2:  // TSQRF [kk, ik]
      tsqrf_blocked(tiles + s0, tiles + s1, tmat + s1, nullptr, b);
      break;
    case 3:  // SSRFT [ik, kj, ij]
      apply_tsqt_wide(tiles + s0, tmat + s0, tiles + s1, tiles + s2, b,
                      chunk);
      break;
    default:  // QR_NOOP and anything out of range: no-op
      break;
  }
  __syncthreads();
}

// One row [etype, s0, s1, s2] of the table, by the whole block.
__device__ __forceinline__ void qr_row(const int* row, float* tiles,
                                       float* tmat, const Slots& s, int b) {
  const int et = row[0];
  const size_t bb = (size_t)b * b;
  const size_t s0 = row[1] * bb, s1 = row[2] * bb, s2 = row[3] * bb;
  switch (et) {
    case 0:  // GEQRF [kk]: factor the diagonal tile, stash T
      load_tile(s.t[0], tiles + s0, b);
      __syncthreads();
      geqrf_tile(s.t[0], s.t[1], s.taus, s.t[2], s.t[3], s.vbuf, b);
      store_tile(tiles + s0, s.t[0], b);
      store_tile(tmat + s0, s.t[1], b);
      break;
    case 1:  // LARFT [kk, kj]: apply Q^T of the diagonal tile
      load_tile(s.t[0], tiles + s0, b);
      load_tile(s.t[1], tmat + s0, b);
      load_tile(s.t[2], tiles + s1, b);
      __syncthreads();
      apply_qt_tile(s.t[0], s.t[1], s.t[2], s.t[3], s.t[4], s.t[5], b);
      store_tile(tiles + s1, s.t[2], b);
      break;
    case 2:  // TSQRF [kk, ik]: R over the rect tile; kk keeps V below
      load_tile(s.t[0], tiles + s0, b);
      load_tile(s.t[1], tiles + s1, b);
      __syncthreads();
      tsqrf_tile(s.t[0], s.t[1], s.t[2], s.taus, s.t[3], s.t[4], s.vbuf, b);
      store_tile(tiles + s0, s.t[0], b);
      store_tile(tiles + s1, s.t[1], b);
      store_tile(tmat + s1, s.t[2], b);
      break;
    case 3:  // SSRFT [ik, kj, ij]: apply the (I; V2) reflector
      load_tile(s.t[0], tiles + s0, b);
      load_tile(s.t[1], tmat + s0, b);
      load_tile(s.t[2], tiles + s1, b);
      load_tile(s.t[3], tiles + s2, b);
      __syncthreads();
      apply_tsqt_tile(s.t[0], s.t[1], s.t[2], s.t[3], s.t[4], s.t[5], b);
      store_tile(tiles + s1, s.t[2], b);
      store_tile(tiles + s2, s.t[3], b);
      break;
    default:  // QR_NOOP and anything out of range: no-op
      break;
  }
  __syncthreads();   // the stores have read the slots the next row reuses
}

// work items of a row of type et when an apply takes nch (qr_apply_chunks)
__device__ __forceinline__ int qr_row_items(int et, int nch) {
  return et == 1 || et == 3 ? nch : 1;
}

// The whole plan in one cooperative launch: phase p is rows offs[p] ..
// offs[p + 1] - 1 of desc (width ints each: [etype, s0, s1, s2]), each
// row one work item, an apply row past QR_OUTER_MIN_B one a 64-column
// chunk (qr_row_items: the phase's items in table order, a row's chunks
// in order); block x takes items x, x + gridDim.x, ... in turns.  The
// write coloring guarantees the rows of a phase touch disjoint tiles, and
// an apply's chunks touch disjoint columns, so items may run in any order
// and on any block; the grid barrier makes phase p's stores visible
// before phase p + 1 loads.  tiles and tmat are (ntiles, b, b) stacks in
// column-major tile order, updated in place.  WIDE: the blocked bodies
// (qr_walk_wide_kernel, b > QR_MAX_B).
template <bool WIDE>
__device__ __forceinline__ void qr_walk_rows(const int* desc, const int* offs,
                                             int nphases, int width,
                                             float* tiles, float* tmat,
                                             int b) {
  cg::grid_group grid = cg::this_grid();
  const Slots s = qr_slots(b);
  const int nch = WIDE ? qr_apply_chunks(b) : 1;
  for (int p = 0; p < nphases; ++p) {
    const int q0 = offs[p], q1 = offs[p + 1];
    if (nch == 1) {
      for (int q = q0 + blockIdx.x; q < q1; q += gridDim.x) {
        if (WIDE)
          qr_row_wide(desc + (size_t)q * width, 0, tiles, tmat, b);
        else
          qr_row(desc + (size_t)q * width, tiles, tmat, s, b);
      }
    } else {
      int n = 0;
      for (int q = q0; q < q1; ++q)
        n += qr_row_items(desc[(size_t)q * width], nch);
      for (int it = blockIdx.x; it < n; it += gridDim.x) {
        int q = q0, k = it, m;
        while (k >= (m = qr_row_items(desc[(size_t)q * width], nch))) {
          k -= m;
          ++q;
        }
        qr_row_wide(desc + (size_t)q * width, k, tiles, tmat, b);
      }
    }
    if (p + 1 < nphases) grid.sync();
  }
}

__global__ void __launch_bounds__(QR_THREADS, 2)
qr_walk_kernel(const int* __restrict__ desc, const int* __restrict__ offs,
               int nphases, int width, float* tiles, float* tmat, int b) {
  qr_walk_rows<false>(desc, offs, nphases, width, tiles, tmat, b);
}

__global__ void __launch_bounds__(QR_THREADS, 1)
qr_walk_wide_kernel(const int* __restrict__ desc, const int* __restrict__ offs,
                    int nphases, int width, float* tiles, float* tmat,
                    int b) {
  qr_walk_rows<true>(desc, offs, nphases, width, tiles, tmat, b);
}

// the walk kernel of tile size b
const void* walk_fn(int b) {
  return b > QR_MAX_B ? (const void*)qr_walk_wide_kernel
                      : (const void*)qr_walk_kernel;
}

size_t smem_bytes(int b) { return sizeof(float) * qr_smem_floats(b); }

}  // namespace

// C interface, loaded with ctypes by repro_torch/kernels/qr_tile/kernel.py.
// Each launcher returns cudaGetLastError() of its launch (0 = launched).
extern "C" {

// Raise the dynamic shared-memory limit of every kernel to the most any
// tile size it takes needs (over the 48 KB default: b = 64's six slots,
// and the wide bodies' layout, 150 KB at most); call once before any
// launch.
int qr_init(void) {
  size_t most = 0;
  for (int b = 1; b <= QR_WIDE_MAX_B; ++b)
    if (smem_bytes(b) > most) most = smem_bytes(b);
  const int bytes = (int)most;
  const void* fns[] = {(const void*)geqrf_kernel, (const void*)tsqrf_kernel,
                       (const void*)apply_qt_kernel,
                       (const void*)apply_tsqt_kernel,
                       (const void*)qr_walk_kernel,
                       (const void*)geqrf_wide_kernel,
                       (const void*)tsqrf_wide_kernel,
                       (const void*)apply_qt_wide_kernel,
                       (const void*)apply_tsqt_wide_kernel,
                       (const void*)qr_walk_wide_kernel};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

int qr_max_b(void) { return QR_MAX_B; }

// bytes of dynamic shared memory a block of tile size b takes
int qr_smem_bytes(int b) { return (int)smem_bytes(b); }

int qr_threads(void) { return QR_THREADS; }

// work items (blocks of the per-op grid) of an apply at tile size b
int qr_chunks(int b) { return qr_apply_chunks(b); }

// Blocks of qr_walk resident on the current card at tile size b: the
// largest grid a cooperative launch takes (0 when it cannot run at all).
int qr_walk_grid(int b, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, walk_fn(b), QR_THREADS, smem_bytes(b));
  *blocks = per_sm * sms;
  return (int)err;
}

// The per-op launchers: n tiles, one block each (the applies past
// QR_OUTER_MIN_B: one a tile's 64-column chunk, grid (n, qr_apply_chunks)).
int qr_geqrf(const float* a, float* rv, float* tau, float* t, int n, int b,
             void* stream) {
  const auto fn = b > QR_MAX_B ? geqrf_wide_kernel : geqrf_kernel;
  fn<<<n, QR_THREADS, smem_bytes(b), (cudaStream_t)stream>>>(a, rv, tau, t,
                                                             b);
  return (int)cudaGetLastError();
}

int qr_tsqrf(const float* r, const float* a, float* r1, float* v2,
             float* tau, float* t, int n, int b, void* stream) {
  const auto fn = b > QR_MAX_B ? tsqrf_wide_kernel : tsqrf_kernel;
  fn<<<n, QR_THREADS, smem_bytes(b), (cudaStream_t)stream>>>(r, a, r1, v2,
                                                             tau, t, b);
  return (int)cudaGetLastError();
}

int qr_apply_qt(const float* rv, const float* t, const float* c, float* out,
                int n, int b, void* stream) {
  const auto fn = b > QR_MAX_B ? apply_qt_wide_kernel : apply_qt_kernel;
  fn<<<dim3(n, qr_apply_chunks(b)), QR_THREADS, smem_bytes(b),
       (cudaStream_t)stream>>>(rv, t, c, out, b);
  return (int)cudaGetLastError();
}

int qr_apply_tsqt(const float* v2, const float* t, const float* c1,
                  const float* c2, float* o1, float* o2, int n, int b,
                  void* stream) {
  const auto fn = b > QR_MAX_B ? apply_tsqt_wide_kernel : apply_tsqt_kernel;
  fn<<<dim3(n, qr_apply_chunks(b)), QR_THREADS, smem_bytes(b),
       (cudaStream_t)stream>>>(v2, t, c1, c2, o1, o2, b);
  return (int)cudaGetLastError();
}

// The whole plan: nphases phases, offs[0 .. nphases] the device row
// offsets, max_items the most work items in a phase (qr_row_items).  One
// cooperative launch of min(resident blocks, max_items) blocks; a refused
// launch (for example cudaErrorCooperativeLaunchTooLarge) is returned,
// never retried.
int qr_walk(const int* desc, const int* offs, int nphases, int max_items,
            int width, float* tiles, float* tmat, int b, void* stream) {
  int resident = 0;
  const int err = qr_walk_grid(b, &resident);
  if (err != 0) return err;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int blocks = max_items < resident ? (max_items > 0 ? max_items : 1)
                                          : resident;
  void* args[] = {(void*)&desc, (void*)&offs, (void*)&nphases,
                  (void*)&width, (void*)&tiles, (void*)&tmat, (void*)&b};
  const cudaError_t launch = cudaLaunchCooperativeKernel(
      walk_fn(b), dim3(blocks), dim3(QR_THREADS), args,
      smem_bytes(b), (cudaStream_t)stream);
  if (launch != cudaSuccess) return (int)launch;
  return (int)cudaGetLastError();
}

#ifdef QR_STAMPS
// the stamps since the last call (out, tags: 4096 each; n: their count)
int qr_stamps(long long* out, int* tags, int* n) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(n, qr_sn, sizeof(int));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, qr_st, sizeof(long long) * 4096);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(tags, qr_tag, sizeof(int) * 4096);
  const int zero = 0;
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(qr_sn, &zero, sizeof(int));
  return (int)err;
}
#endif

}  // extern "C"
