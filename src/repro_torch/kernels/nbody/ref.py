"""Plain PyTorch versions of the N-body interaction kernels (paper §4.2):
the port of ``repro/kernels/nbody/ref.py``.

Plummer-softened gravity, G = 1:
    a_i += m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}

Layout is (3, N), as in the reference: coordinates first, particles
along the last axis.  On the CPU these are what the ops wrappers run; on
the card ``chip_smoke.py`` holds the CUDA kernels against them.
"""

from __future__ import annotations

import torch

DEFAULT_EPS = 1e-4


def acc_pair_ref(xi: torch.Tensor, xj: torch.Tensor, mj: torch.Tensor,
                 eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Accelerations on particles ``xi`` (3,Ni) due to sources ``xj``
    (3,Nj) with masses ``mj`` (Nj,).  No self-exclusion (disjoint sets)."""
    dx = xj[:, None, :] - xi[:, :, None]          # (3, Ni, Nj)
    r2 = (dx * dx).sum(0) + eps * eps             # (Ni, Nj)
    w = r2 ** -1.5 * mj[None, :]                  # (Ni, Nj)
    return torch.einsum("dij,ij->di", dx, w)      # (3, Ni)


def acc_self_ref(x: torch.Tensor, m: torch.Tensor,
                 eps: float = DEFAULT_EPS) -> torch.Tensor:
    """All-pairs accelerations within one set, self-pairs excluded."""
    n = x.shape[1]
    dx = x[:, None, :] - x[:, :, None]            # (3, N, N)
    r2 = (dx * dx).sum(0) + eps * eps
    mask = 1.0 - torch.eye(n, dtype=x.dtype, device=x.device)
    w = r2 ** -1.5 * m[None, :] * mask
    return torch.einsum("dij,ij->di", dx, w)


def acc_direct_ref(x: torch.Tensor, m: torch.Tensor,
                   eps: float = DEFAULT_EPS) -> torch.Tensor:
    """O(N^2) direct sum over the whole particle set — the ground truth the
    Barnes-Hut approximation is measured against."""
    return acc_self_ref(x, m, eps)
