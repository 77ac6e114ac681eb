// K9, the pipeline F/B/U walk of the canonical uniform dense family
// (stage tanh(x W_s + b_s), mean-squared-error loss), for sm_90a.  Built by
// repro_torch/_build.py and bound with ctypes by
// repro_torch/kernels/pipe_walk/kernel.py; the launcher returns
// cudaGetLastError() of its launch.
//
// It replaces src/repro/engine/megakernel.py::_pipe_kernel, walked by
// _grid_walk (its pallas_call) from pipe_round_fn.  The Pallas walk ran the
// rows of a table one after another on one TPU core, each row a whole
// (Bt, D) x (D, D) product in VMEM.  Here the host launches this kernel
// once per write-colored phase, in phase order, on one stream, over state
// updated in place (as the QR walk does): the rows of a phase touch
// pairwise-disjoint state (engine.megakernel.pipe_row_access), and the
// launch boundary is the barrier between phases.  A phase holds at most
// S rows (8 at S = 8), so one block a row would leave most of the 132 SMs
// idle: each row is split into tiles, one block a tile, and the host
// passes the table's tile offsets (a CSR over rows) so a block finds its
// row and its tile by a binary search.  Per row:
//   F  tiles of (32 rows x 64 columns) of h = tanh(in W_s + b_s), in = x[m]
//      on the first stage, else the previous stage's output, each split
//      over the reduction into blocks of 256 (split-K: at D = 2048 a row is
//      256 blocks, not 32 blocks of the whole reduction, which left each
//      phase waiting on 32 long blocks; chip_smoke.py times the walk
//      with one split a tile beside it).  Each block writes its partial
//      product to a scratch buffer; the tile's last block to finish (an
//      integer ticket, no float atomics) sums the partials in split order,
//      adds the bias and applies tanh.  On the last stage it also seeds
//      cot = (2 / numel)(h - y) and sums (h - y)^2 into a per-tile partial,
//      and the row's last tile to finish (a second ticket) sums those in
//      tile order into loss[m].
//   B  (64 x 64) tiles of gW_s += in^T g, g = cot (1 - h^2), the tiles of
//      the first tile row also adding the column sums of g into gb_s; then,
//      unless the row is on the first stage, the split tiles of cot_in =
//      g W_s^T (32 x 64, as F's), each recomputing the g it needs from
//      cots/acts of its own slot (read-only in the phase: another block of
//      the launch may never write what a block reads).
//   U  (64 x 64) tiles of gW_s *= 1/M, the first tile row also gb_s.
// Every element of the state is written by one thread of one block, and
// every sum runs in a fixed order, so two runs are bitwise equal.  Edges
// (Bt or D not a multiple of the tile) are masked; with S = 1 a row is
// both first and last.
//
// The products run in fp32 on the CUDA cores (TF32 is off in the port, as
// the reference computes them in fp32): each block stages chunks of 32 of
// the reduction through shared memory and each thread keeps a small tile
// of outputs in registers.  What bounds the walk: the plan's operations
// (about 0.4 TFLOP at S = 8, M = 64, Bt = 32, D = 2048) at the card's fp32
// rate, 67 TFLOP/s; the bytes the function must move, each state buffer
// read and written once, take far less.  This walk moves much more: every
// row re-reads W_s (16.8 MB at D = 2048) and a B row reads and writes
// gW_s, about 35 GB a plan.  A simple tiled product that is right comes
// first; larger register tiles, wgmma (once the reference's fp32 allows a
// reduced precision) and a persistent walk are later work (ROADMAP.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;   // a 16 x 16 thread grid over each tile
constexpr int TK = 32;         // reduction chunk staged per step
constexpr int ACT_TM = 32;     // (Bt, D) tiles of F and cot_in: rows
constexpr int ACT_TN = 64;     //   and columns
constexpr int KSPLIT = 256;    // reduction length of one F / cot_in block
constexpr int GW_T = 64;       // (D, D) tiles of gW (B) and of U
constexpr int SMEM_FLOATS = 2 * TK * (GW_T + 1);

enum { PIPE_F = 0, PIPE_B = 1, PIPE_U = 2 };

struct Walk {
  const int* desc;        // (rows, width) int32: [etype, s, m, a_in, a_out,
  int width;              //   first, last, ...]
  const int* tile_offs;   // (rows + 1): the CSR of the rows' tiles
  int row0, row1, tile0;  // this launch: rows [row0, row1), tiles from tile0
  const float* w;         // (S, D, D)
  const float* b;         // (S, D)
  const float* x;         // (M, Bt, D)
  const float* y;         // (M, Bt, D)
  float* acts;            // (S M, Bt, D), slot = stage M + micro
  float* cots;            // (S M, Bt, D)
  float* gw;              // (S, D, D)
  float* gb;              // (S, D)
  float* loss;            // (M, 1)
  float* partials;        // (M, F tiles a row): the loss's per-tile sums
  int* counters;          // (M): tiles of a last-stage F row done, zeroed
  float* split;           // (rows a phase, splits, F tiles, ACT_TM ACT_TN):
                          //   the split-K partial products
  int* tickets;           // (rows a phase, F tiles): splits done, zeroed
  int bt, dim;
  float inv_m, inv_numel;
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// acc[i][j] = sum over k_lo <= k < K of A(r0 + ty + 16 i, k) B(k, c0 + tx +
// 16 j), with A(r, k) = 0 for r >= m_lim and B(k, c) = 0 for c >= n_lim.
// Chunks of TK of the reduction are staged in shared memory (padded rows,
// so neither the staging nor the products conflict on banks), the next
// chunk's loads in flight in registers while the block multiplies the
// current one; A_KC / B_KC say whether consecutive k are consecutive in
// memory, so the loads are coalesced either way.  k runs in order: the sum
// is the same bits on every run.
template <int TM, int TN, bool A_KC, bool B_KC, class FA, class FB>
__device__ __forceinline__ void tile_gemm(FA a, FB bm, int r0, int c0,
                                          int m_lim, int n_lim, int k_lo,
                                          int K, float* smem,
                                          float (&acc)[TM / 16][TN / 16]) {
  constexpr int AN = TM * TK / THREADS, BN = TK * TN / THREADS;
  static_assert(AN * THREADS == TM * TK && BN * THREADS == TK * TN,
                "a chunk must split evenly over the threads");
  float* as = smem;                  // TK x (TM + 1)
  float* bs = smem + TK * (TM + 1);  // TK x (TN + 1)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float ra[AN], rb[BN];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < AN; ++u) {
      const int e = tid + u * THREADS;
      const int gr = r0 + (A_KC ? e / TK : e % TM);
      const int gk = k0 + (A_KC ? e % TK : e / TM);
      ra[u] = (gr < m_lim && gk < K) ? a(gr, gk) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BN; ++u) {
      const int e = tid + u * THREADS;
      const int gc = c0 + (B_KC ? e / TK : e % TN);
      const int gk = k0 + (B_KC ? e % TK : e / TN);
      rb[u] = (gc < n_lim && gk < K) ? bm(gk, gc) : 0.f;
    }
  };
#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
#pragma unroll
    for (int j = 0; j < TN / 16; ++j) acc[i][j] = 0.f;
  if (k_lo < K) fetch(k_lo);
  for (int k0 = k_lo; k0 < K; k0 += TK) {
#pragma unroll
    for (int u = 0; u < AN; ++u) {
      const int e = tid + u * THREADS;
      as[(A_KC ? e % TK : e / TM) * (TM + 1) + (A_KC ? e / TK : e % TM)] =
          ra[u];
    }
#pragma unroll
    for (int u = 0; u < BN; ++u) {
      const int e = tid + u * THREADS;
      bs[(B_KC ? e % TK : e / TN) * (TN + 1) + (B_KC ? e / TK : e % TN)] =
          rb[u];
    }
    __syncthreads();
    if (k0 + TK < K) fetch(k0 + TK);
    // past K both operands are 0, and fmaf(0, 0, acc) is acc exactly
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      float av[TM / 16], bv[TN / 16];
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) av[i] = as[k * (TM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN / 16; ++j) bv[j] = bs[k * (TN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM / 16; ++i)
#pragma unroll
        for (int j = 0; j < TN / 16; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The loss of a last-stage F row: the block's sum of (h - y)^2 goes to
// partials[m, t]; the row's last tile to finish adds the partials in tile
// order.  The ticket is an integer atomic; the sums are fixed-order.
__device__ void loss_tile(const Walk& P, int m, int t, int ntiles,
                          float part, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float sum = 0.f;
  for (int i = 0; i < THREADS / 32; ++i) sum += red[i];
  P.partials[(int64_t)m * ntiles + t] = sum;
  __threadfence();
  if (atomicAdd(P.counters + m, 1) != ntiles - 1) return;
  __threadfence();
  const volatile float* pp = P.partials + (int64_t)m * ntiles;
  float tot = 0.f;
  for (int i = 0; i < ntiles; ++i) tot += pp[i];
  P.loss[m] = tot * P.inv_numel;
  P.counters[m] = 0;
}

// One block's share of an F or cot_in output tile o (ACT_TM x ACT_TN):
// the product over k in [sp KSPLIT, (sp + 1) KSPLIT), written to the
// row's split-K scratch.  The last of the tile's splits to finish (an
// integer ticket) sums the partials in split order into acc and returns
// true; the others return false.  slot is the row's place in its phase.
template <bool A_KC, bool B_KC, class FA, class FB>
__device__ bool split_product(const Walk& P, int slot, int o, int sp, FA a,
                              FB bm, int r0, int c0, float* smem,
                              float (&acc)[ACT_TM / 16][ACT_TN / 16]) {
  __shared__ int is_last;
  constexpr int TILE = ACT_TM * ACT_TN;
  const int nks = cdiv(P.dim, KSPLIT);
  const int ntf = cdiv(P.bt, ACT_TM) * cdiv(P.dim, ACT_TN);
  const int k_lo = sp * KSPLIT, k_hi = min(P.dim, k_lo + KSPLIT);
  tile_gemm<ACT_TM, ACT_TN, A_KC, B_KC>(a, bm, r0, c0, P.bt, P.dim, k_lo,
                                        k_hi, smem, acc);
  float* part = P.split + ((int64_t)slot * nks * ntf + o) * TILE;
  const int64_t stride = (int64_t)ntf * TILE;   // from one split to the next
#pragma unroll
  for (int i = 0; i < ACT_TM / 16; ++i)
#pragma unroll
    for (int j = 0; j < ACT_TN / 16; ++j)
      part[sp * stride + (i * (ACT_TN / 16) + j) * THREADS + threadIdx.x] =
          acc[i][j];
  __threadfence();
  __syncthreads();
  int* ticket = P.tickets + (int64_t)slot * ntf + o;
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1) == nks - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < ACT_TM / 16; ++i)
#pragma unroll
    for (int j = 0; j < ACT_TN / 16; ++j) {
      const int e = (i * (ACT_TN / 16) + j) * THREADS + threadIdx.x;
      float sum = 0.f;
      for (int k = 0; k < nks; ++k) sum += __ldcg(part + k * stride + e);
      acc[i][j] = sum;
    }
  if (threadIdx.x == 0) *ticket = 0;
  return true;
}

// F tile t of row [s, m, a_in, a_out, first, last]: split sp of output
// tile o; the tile's last split applies the bias and tanh, and on the last
// stage seeds the cotangent and the loss.
__device__ void f_tile(const Walk& P, const int* row, int slot, int t,
                       float* smem) {
  const int s = row[1], m = row[2], a_in = row[3], a_out = row[4];
  const bool first = row[5] > 0, last = row[6] > 0;
  const int bt = P.bt, dim = P.dim, ntn = cdiv(dim, ACT_TN);
  const int nks = cdiv(dim, KSPLIT), o = t / nks, sp = t % nks;
  const int64_t slab = (int64_t)bt * dim;
  const int r0 = (o / ntn) * ACT_TM, c0 = (o % ntn) * ACT_TN;
  const float* in = first ? P.x + m * slab : P.acts + a_in * slab;
  const float* W = P.w + (int64_t)s * dim * dim;
  float acc[ACT_TM / 16][ACT_TN / 16];
  if (!split_product<true, false>(
          P, slot, o, sp, [=](int r, int k) { return in[(int64_t)r * dim + k]; },
          [=](int k, int c) { return W[(int64_t)k * dim + c]; }, r0, c0, smem,
          acc))
    return;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* bias = P.b + (int64_t)s * dim;
  float* h_out = P.acts + a_out * slab;
  float* cot_out = P.cots + a_out * slab;
  const float* ym = P.y + m * slab;
  const float seed = 2.f * P.inv_numel;
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < ACT_TM / 16; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < ACT_TN / 16; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r >= bt || c >= dim) continue;
      const int64_t e = (int64_t)r * dim + c;
      const float h = tanhf(acc[i][j] + bias[c]);
      h_out[e] = h;
      if (last) {
        const float d = h - ym[e];
        cot_out[e] = seed * d;
        part += d * d;
      }
    }
  }
  if (last) loss_tile(P, m, o, cdiv(bt, ACT_TM) * ntn, part, smem);
}

// B tile t < (F tiles) x (splits) of a row off the first stage: split sp of
// output tile o of cot_in = g W_s^T, g = cot (1 - h^2) recomputed from the
// row's own slot; the tile's last split writes it.
__device__ void cot_tile(const Walk& P, const int* row, int slot, int t,
                         float* smem) {
  const int s = row[1], a_in = row[3], a_out = row[4];
  const int bt = P.bt, dim = P.dim, ntn = cdiv(dim, ACT_TN);
  const int nks = cdiv(dim, KSPLIT), o = t / nks, sp = t % nks;
  const int64_t slab = (int64_t)bt * dim;
  const int r0 = (o / ntn) * ACT_TM, c0 = (o % ntn) * ACT_TN;
  const float* h = P.acts + a_out * slab;
  const float* cot = P.cots + a_out * slab;
  const float* W = P.w + (int64_t)s * dim * dim;
  float acc[ACT_TM / 16][ACT_TN / 16];
  if (!split_product<true, true>(
          P, slot, o, sp,
          [=](int r, int k) {
            const int64_t e = (int64_t)r * dim + k;
            const float hv = h[e];
            return cot[e] * (1.f - hv * hv);
          },
          [=](int k, int c) { return W[(int64_t)c * dim + k]; }, r0, c0, smem,
          acc))
    return;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* out = P.cots + a_in * slab;
#pragma unroll
  for (int i = 0; i < ACT_TM / 16; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < ACT_TN / 16; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < bt && c < dim) out[(int64_t)r * dim + c] = acc[i][j];
    }
  }
}

// B tile t of the (D, D) grid: gW_s += in^T g; the first tile row also
// adds the column sums of g (rows in order) into gb_s.
__device__ void gw_tile(const Walk& P, const int* row, int t, float* smem) {
  const int s = row[1], m = row[2], a_in = row[3], a_out = row[4];
  const bool first = row[5] > 0;
  const int bt = P.bt, dim = P.dim, ntg = cdiv(dim, GW_T);
  const int64_t slab = (int64_t)bt * dim;
  const int ti = t / ntg, i0 = ti * GW_T, j0 = (t % ntg) * GW_T;
  const float* in = first ? P.x + m * slab : P.acts + a_in * slab;
  const float* h = P.acts + a_out * slab;
  const float* cot = P.cots + a_out * slab;
  auto g = [=](int k, int j) {
    const int64_t e = (int64_t)k * dim + j;
    const float hv = h[e];
    return cot[e] * (1.f - hv * hv);
  };
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* gws = P.gw + (int64_t)s * dim * dim;
  // the tile's old gW values are loaded before the product, so their
  // latency overlaps the staging's
  float old[GW_T / 16][GW_T / 16];
#pragma unroll
  for (int i = 0; i < GW_T / 16; ++i)
#pragma unroll
    for (int j = 0; j < GW_T / 16; ++j) {
      const int r = i0 + ty + 16 * i, c = j0 + tx + 16 * j;
      old[i][j] = (r < dim && c < dim) ? gws[(int64_t)r * dim + c] : 0.f;
    }
  float acc[GW_T / 16][GW_T / 16];
  tile_gemm<GW_T, GW_T, false, false>(
      [=](int i, int k) { return in[(int64_t)k * dim + i]; }, g, i0, j0, dim,
      dim, 0, bt, smem, acc);
#pragma unroll
  for (int i = 0; i < GW_T / 16; ++i) {
    const int r = i0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < GW_T / 16; ++j) {
      const int c = j0 + tx + 16 * j;
      if (r < dim && c < dim) gws[(int64_t)r * dim + c] = old[i][j] + acc[i][j];
    }
  }
  if (ti != 0) return;
  // gb_s += the column sums of g: four threads a column, each over every
  // fourth row, their sums added in a fixed order (the block's smem is free
  // after tile_gemm)
  constexpr int QS = THREADS / GW_T;
  const int j = j0 + threadIdx.x % GW_T, q = threadIdx.x / GW_T;
  float sum = 0.f;
  if (j < dim) {
#pragma unroll 4
    for (int k = q; k < bt; k += QS) sum += g(k, j);
  }
  smem[threadIdx.x] = sum;
  __syncthreads();
  if (q == 0 && j < dim) {
    for (int i = 1; i < QS; ++i) sum += smem[i * GW_T + threadIdx.x];
    P.gb[(int64_t)s * dim + j] += sum;
  }
}

// U tile t of the (D, D) grid: gW_s *= 1/M; the first tile row also gb_s.
__device__ void u_tile(const Walk& P, const int* row, int t) {
  const int s = row[1], dim = P.dim, ntg = cdiv(dim, GW_T);
  const int ti = t / ntg, i0 = ti * GW_T, j0 = (t % ntg) * GW_T;
  float* gws = P.gw + (int64_t)s * dim * dim;
  for (int e = threadIdx.x; e < GW_T * GW_T; e += THREADS) {
    const int r = i0 + e / GW_T, c = j0 + e % GW_T;
    if (r < dim && c < dim) gws[(int64_t)r * dim + c] *= P.inv_m;
  }
  if (ti != 0) return;
  for (int j = j0 + threadIdx.x; j < min(j0 + GW_T, dim); j += THREADS)
    P.gb[(int64_t)s * dim + j] *= P.inv_m;
}

__global__ void __launch_bounds__(THREADS) pipe_walk_kernel(Walk P) {
  __shared__ float smem[SMEM_FLOATS];
  const int t = P.tile0 + blockIdx.x;
  // the row q with tile_offs[q] <= t < tile_offs[q + 1]; rows with no
  // tiles (no-op rows) have an empty range and are never found
  int lo = P.row0, hi = P.row1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (P.tile_offs[mid] <= t) lo = mid; else hi = mid;
  }
  const int* row = P.desc + (int64_t)lo * P.width;
  const int lt = t - P.tile_offs[lo], slot = lo - P.row0;
  switch (row[0]) {
    case PIPE_F:
      f_tile(P, row, slot, lt, smem);
      break;
    case PIPE_B: {
      const int ncot = row[5] > 0 ? 0
          : cdiv(P.bt, ACT_TM) * cdiv(P.dim, ACT_TN) * cdiv(P.dim, KSPLIT);
      // the gW tiles come first: the first tile row's column sums then
      // start at once, and the walk ran faster so on the card (PERF.md)
      const int ngw = cdiv(P.dim, GW_T) * cdiv(P.dim, GW_T);
      if (lt < ngw)
        gw_tile(P, row, lt, smem);
      else if (lt - ngw < ncot)
        cot_tile(P, row, slot, lt - ngw, smem);
      break;
    }
    case PIPE_U:
      u_tile(P, row, lt);
      break;
    default:  // PIPE_NOOP and anything out of range: no tiles
      break;
  }
}

}  // namespace

extern "C" {

// The tile shape the host's tile offsets must be computed with:
// {ACT_TM, ACT_TN, KSPLIT, GW_T}.
void pipe_tile_shape(int* out) {
  out[0] = ACT_TM;
  out[1] = ACT_TN;
  out[2] = KSPLIT;
  out[3] = GW_T;
}

// One write-colored phase: rows [row0, row1) of desc, whose tiles are
// tile_offs[row0] = tile0 .. tile0 + ntiles.  All pointers are contiguous
// device buffers of the shapes in Walk (split holds at least row1 - row0
// rows); the state is updated in place.
int pipe_walk(const int* desc, int width, const int* tile_offs, int row0,
              int row1, int tile0, int ntiles, const float* w,
              const float* b, const float* x, const float* y, float* acts,
              float* cots, float* gw, float* gb, float* loss,
              float* partials, int* counters, float* split, int* tickets,
              int bt, int dim, float inv_m, float inv_numel, void* stream) {
  Walk P{desc,     width,    tile_offs, row0,  row1, tile0, w,
         b,        x,        y,         acts,  cots, gw,    gb,
         loss,     partials, counters,  split, tickets, bt, dim,
         inv_m,    inv_numel};
  pipe_walk_kernel<<<ntiles, THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
