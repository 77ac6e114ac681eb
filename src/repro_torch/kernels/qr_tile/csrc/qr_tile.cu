// Tiled-QR kernels for Hopper (sm_90a): the four tile ops as batched
// per-op kernels, and the task-table walk.
//
// Replaces the TPU kernels
//   src/repro/kernels/qr_tile/kernel.py::geqrf, tsqrf, apply_qt, apply_tsqt
//     (one pallas_call per tile op; here blockIdx.x indexes a batch of
//     tiles, so one launch serves both run_one and the batched rounds mode)
//   src/repro/engine/megakernel.py::qr_round_fn -> _grid_walk + _qr_kernel
//     (the ragged walk over [etype, s0, s1, s2] rows; here qr_walk runs one
//     write-colored phase per launch, one block per row, and the host
//     launches the phases in order on one stream: CUDA blocks of a launch
//     run concurrently, so the launch boundary is what serialises phases,
//     where the TPU relied on its grid running in order.)
//
// What bounds it on an H100: the apply ops (most tasks) are three b x b
// products, about 6 b^3 flops over 4 (apply_qt) or 6 (apply_tsqt) tiles
// moved; at b = 64 that is 24 and 16 flops per byte, either side of the
// card's fp32 ridge (67 TFLOP/s over 3.35 TB/s, H100 SXM data sheet: 20
// flops per byte; TF32 is off, so no tensor cores).  The panel
// factorizations are b dependent column steps, each a reduction and a
// barrier.  Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py,
// PERF.md), every kernel here takes far longer than either roof: it is
// bound by latency — one block per tile walks a chain of dependent shared-memory
// loads and fmaf — and the walk also waits at each phase boundary (125
// per 2048^2 plan).
// What the design does about it, for now: each tile is staged once into
// shared memory (padded, conflict-free) and every product reads it from
// there, each thread accumulating its outputs with fmaf in registers;
// a phase's rows run as concurrent blocks on the 132 SMs.  Register
// tiling, more independent accumulators and a persistent walk are later
// work (ROADMAP.md).

#include <cuda_runtime.h>

#include "qr_tile.cuh"

extern __shared__ float qr_smem[];

namespace {

struct Slots {
  float* t[QR_TILES];
  float *v, *d, *sc;
};

__device__ __forceinline__ Slots qr_slots(int b) {
  Slots s;
  const int ts = b * (b + 1);
  for (int k = 0; k < QR_TILES; ++k) s.t[k] = qr_smem + k * ts;
  s.v = qr_smem + QR_TILES * ts;
  s.d = s.v + b;
  s.sc = s.d + 2 * b;   // s.d + b .. + 2b holds taus
  return s;
}

__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int b) {
  for (int e = threadIdx.x; e < b * b; e += blockDim.x)
    dst[(e / b) * (b + 1) + e % b] = src[e];
}

__device__ __forceinline__ void store_tile(float* dst, const float* src,
                                           int b) {
  for (int e = threadIdx.x; e < b * b; e += blockDim.x)
    dst[e] = src[(e / b) * (b + 1) + e % b];
}

__device__ __forceinline__ void store_vec(float* dst, const float* src,
                                          int b) {
  for (int i = threadIdx.x; i < b; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(QR_THREADS)
geqrf_kernel(const float* a, float* rv, float* tau, float* t, int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  Slots s = qr_slots(b);
  float* taus = s.d + b;
  load_tile(s.t[0], a + off, b);
  __syncthreads();
  geqrf_tile(s.t[0], s.t[1], taus, s.v, s.d, s.sc, b);
  store_tile(rv + off, s.t[0], b);
  store_tile(t + off, s.t[1], b);
  store_vec(tau + (size_t)blockIdx.x * b, taus, b);
}

__global__ void __launch_bounds__(QR_THREADS)
tsqrf_kernel(const float* r, const float* a, float* r1, float* v2,
             float* tau, float* t, int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  Slots s = qr_slots(b);
  float* taus = s.d + b;
  load_tile(s.t[0], r + off, b);
  load_tile(s.t[1], a + off, b);
  __syncthreads();
  tsqrf_tile(s.t[0], s.t[1], s.t[2], taus, s.v, s.d, s.sc, b);
  store_tile(r1 + off, s.t[0], b);
  store_tile(v2 + off, s.t[1], b);
  store_tile(t + off, s.t[2], b);
  store_vec(tau + (size_t)blockIdx.x * b, taus, b);
}

__global__ void __launch_bounds__(QR_THREADS)
apply_qt_kernel(const float* rv, const float* t, const float* c, float* out,
                int b) {
  const size_t off = (size_t)blockIdx.x * b * b;
  Slots s = qr_slots(b);
  load_tile(s.t[0], rv + off, b);
  load_tile(s.t[1], t + off, b);
  load_tile(s.t[2], c + off, b);
  __syncthreads();
  apply_qt_tile(s.t[0], s.t[1], s.t[2], s.t[3], s.t[4], b);
  store_tile(out + off, s.t[2], b);
}

__global__ void __launch_bounds__(QR_THREADS)
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

// One block per row of one write-colored phase: rows row0 .. row0 +
// gridDim.x - 1 of desc (width ints each: [etype, s0, s1, s2]).  The write
// coloring guarantees the rows of a phase touch disjoint tiles, so the
// blocks may run in any order.  tiles and tmat are (ntiles, b, b) stacks
// in column-major tile order, updated in place.
__global__ void __launch_bounds__(QR_THREADS)
qr_walk_kernel(const int* desc, int row0, int width, float* tiles,
               float* tmat, int b) {
  const int* row = desc + (size_t)(row0 + blockIdx.x) * width;
  const int et = row[0];
  const size_t bb = (size_t)b * b;
  const size_t s0 = row[1] * bb, s1 = row[2] * bb, s2 = row[3] * bb;
  Slots s = qr_slots(b);
  float* taus = s.d + b;
  switch (et) {
    case 0:  // GEQRF [kk]: factor the diagonal tile, stash T
      load_tile(s.t[0], tiles + s0, b);
      __syncthreads();
      geqrf_tile(s.t[0], s.t[1], taus, s.v, s.d, s.sc, b);
      store_tile(tiles + s0, s.t[0], b);
      store_tile(tmat + s0, s.t[1], b);
      break;
    case 1:  // LARFT [kk, kj]: apply Q^T of the diagonal tile
      load_tile(s.t[0], tiles + s0, b);
      load_tile(s.t[1], tmat + s0, b);
      load_tile(s.t[2], tiles + s1, b);
      __syncthreads();
      apply_qt_tile(s.t[0], s.t[1], s.t[2], s.t[3], s.t[4], b);
      store_tile(tiles + s1, s.t[2], b);
      break;
    case 2:  // TSQRF [kk, ik]: R over the rect tile; kk keeps V below
      load_tile(s.t[0], tiles + s0, b);
      load_tile(s.t[1], tiles + s1, b);
      __syncthreads();
      tsqrf_tile(s.t[0], s.t[1], s.t[2], taus, s.v, s.d, s.sc, b);
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
}

size_t smem_bytes(int b) { return sizeof(float) * qr_smem_floats(b); }

}  // namespace

// C interface, loaded with ctypes by repro_torch/kernels/qr_tile/kernel.py.
// Each launcher returns cudaGetLastError() of its launch (0 = launched).
extern "C" {

// Raise the dynamic shared-memory limit of every kernel to what b = 64
// needs (over the 48 KB default); call once before any launch.
int qr_init(void) {
  const int bytes = (int)smem_bytes(QR_MAX_B);
  cudaFuncSetAttribute(geqrf_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncSetAttribute(tsqrf_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncSetAttribute(apply_qt_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncSetAttribute(apply_tsqt_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncSetAttribute(qr_walk_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return (int)cudaGetLastError();
}

int qr_max_b(void) { return QR_MAX_B; }

int qr_threads(void) { return QR_THREADS; }

int qr_geqrf(const float* a, float* rv, float* tau, float* t, int n, int b,
             void* stream) {
  geqrf_kernel<<<n, QR_THREADS, smem_bytes(b), (cudaStream_t)stream>>>(
      a, rv, tau, t, b);
  return (int)cudaGetLastError();
}

int qr_tsqrf(const float* r, const float* a, float* r1, float* v2,
             float* tau, float* t, int n, int b, void* stream) {
  tsqrf_kernel<<<n, QR_THREADS, smem_bytes(b), (cudaStream_t)stream>>>(
      r, a, r1, v2, tau, t, b);
  return (int)cudaGetLastError();
}

int qr_apply_qt(const float* rv, const float* t, const float* c, float* out,
                int n, int b, void* stream) {
  apply_qt_kernel<<<n, QR_THREADS, smem_bytes(b), (cudaStream_t)stream>>>(
      rv, t, c, out, b);
  return (int)cudaGetLastError();
}

int qr_apply_tsqt(const float* v2, const float* t, const float* c1,
                  const float* c2, float* o1, float* o2, int n, int b,
                  void* stream) {
  apply_tsqt_kernel<<<n, QR_THREADS, smem_bytes(b), (cudaStream_t)stream>>>(
      v2, t, c1, c2, o1, o2, b);
  return (int)cudaGetLastError();
}

int qr_walk(const int* desc, int row0, int nrows, int width, float* tiles,
            float* tmat, int b, void* stream) {
  qr_walk_kernel<<<nrows, QR_THREADS, smem_bytes(b), (cudaStream_t)stream>>>(
      desc, row0, width, tiles, tmat, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
