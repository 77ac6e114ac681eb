// Softened-gravity interaction math of the Barnes-Hut tree code (paper
// §4.2) as device functions for the task-table walk (K8 bh_walk) in
// nbody.cu, and the constants of the per-op kernels (K6 acc_pair, K7
// acc_self), which take the same pair arithmetic (nbody.cu::nb_pull) over
// slices of the sources.
//
// Replaces the value-level body the TPU kernels share,
// src/repro/kernels/nbody/kernel.py::acc_block:
//     a_i += sum_j m_j (x_j - x_i) * rsqrt(|x_j - x_i|^2 + eps^2)^3
// Each target sums its sources in a fixed order, j = 0, 1, ..., so a result
// never depends on scheduling and repeats bit for bit.
//
// rsqrtf: the reference's kernel takes rsqrt too (its oracle takes
// r2 ** -1.5).  rsqrtf is within 2 ulp of 1/sqrt, so rsqrt(r2)^3 * m is
// within about 8 ulp (5e-7 relative) of the exact weight, far inside the
// reference's kernel-vs-oracle tolerance (rtol 2e-4, atol 1e-5,
// tests/test_kernels_nbody.py).  eps^2 > 0 keeps r2 away from 0, so
// coincident particles give a finite weight times a zero displacement.
#pragma once

#include <cuda_runtime.h>

#define NB_PAIR_THREADS 256 // K6/K7: least blockDim, targets x source slices
#define NB_PAIR_MAX_THREADS 1024   // K6/K7: most blockDim
#define NB_PAIR_SLICE 32    // K6/K7: sources a slice walks before slices double
#define NB_PAIR_CHUNK 512   // K6/K7: sources staged in shared memory at once
#define NB_MAX_P 1024       // K8: one thread per particle of a leaf block
#define NB_MAX_CHILDREN 8   // K8: COM slots of a COM_INNER or PC row

// Engine types of a BH table row [etype, write, a0..a7]; equal to
// BH_COM_LEAF .. BH_NOOP in repro_torch/engine/megakernel.py.
#define BH_COM_LEAF 0
#define BH_COM_INNER 1
#define BH_SELF 2
#define BH_PP 3
#define BH_PC 4

// (ax, ay, az) += the pull of the n sources held as four planes
// (sx, sy, sz, sm) on the target at (xi, yi, zi), in the order j = 0..n-1;
// source `skip` (the target itself in a self set, else -1) weighs zero.
__device__ __forceinline__ void nb_accumulate(
    const float* sx, const float* sy, const float* sz, const float* sm,
    int n, int skip, float xi, float yi, float zi, float eps2, float& ax,
    float& ay, float& az) {
  for (int j = 0; j < n; ++j) {
    const float dx = sx[j] - xi;
    const float dy = sy[j] - yi;
    const float dz = sz[j] - zi;
    const float r2 = dx * dx + dy * dy + dz * dz + eps2;
    float w = rsqrtf(r2);
    w = w * w * w * sm[j];
    if (j == skip) w = 0.0f;
    ax += dx * w;
    ay += dy * w;
    az += dz * w;
  }
}
