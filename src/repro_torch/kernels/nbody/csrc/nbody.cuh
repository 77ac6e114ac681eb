// Constants of the Barnes-Hut tree code's kernels (paper §4.2) in
// nbody.cu: the per-op kernels (K6 acc_pair, K7 acc_self, nbody.cu::nb_pull)
// and the task-table walk (K8 bh_walk, nbody.cu::nb_pull4), which take the
// same pair arithmetic.
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
#define NB_MAX_P 1024       // K8: leaf blocks of at most 32 x 32 targets
#define NB_BATCH 4          // K8: rows of a bucket staged in one step, at most
#define NB_MAX_CHILDREN 8   // K8: COM slots of a COM_INNER or PC row

// Engine types of a BH table row [etype, write, a0..a7]; equal to
// BH_COM_LEAF .. BH_NOOP in repro_torch/engine/megakernel.py.
#define BH_COM_LEAF 0
#define BH_COM_INNER 1
#define BH_SELF 2
#define BH_PP 3
#define BH_PC 4
