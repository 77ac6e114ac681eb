"""Plain PyTorch versions of the N-body interaction kernels (paper §4.2):
the port of ``repro/kernels/nbody/ref.py``.

Plummer-softened gravity, G = 1:
    a_i += m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}

Layout is (3, N), as in the reference: coordinates first, particles
along the last axis.  On the CPU these are what the ops wrappers run; on
the card ``chip_smoke.py`` holds the CUDA kernels against them.

Every term is made of correctly rounded operations (``m / (r2 sqrt(r2))``,
not a power) and a target sums its sources in source order (the last
entry of a cumulative sum), so on the CPU a target's result does not
depend on where its sources sit in memory, and sources of zero mass after
the real ones add exactly nothing: a walk that stops at a leaf's real
particles gives these bits (``tests/test_torch_bh.py``).
"""

from __future__ import annotations

import torch

DEFAULT_EPS = 1e-4


def _source_sum(terms: torch.Tensor) -> torch.Tensor:
    """(3, Ni, Nj) -> (3, Ni): each target's terms summed over j in order."""
    if terms.shape[-1] == 0:
        return terms.sum(-1)
    return torch.cumsum(terms, -1)[..., -1]


def acc_pair_ref(xi: torch.Tensor, xj: torch.Tensor, mj: torch.Tensor,
                 eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Accelerations on particles ``xi`` (3,Ni) due to sources ``xj``
    (3,Nj) with masses ``mj`` (Nj,).  No self-exclusion (disjoint sets)."""
    dx = xj[:, None, :] - xi[:, :, None]          # (3, Ni, Nj)
    r2 = (dx * dx).sum(0) + eps * eps             # (Ni, Nj)
    w = mj[None, :] / (r2 * r2.sqrt())            # (Ni, Nj)
    return _source_sum(dx * w)                    # (3, Ni)


def acc_self_ref(x: torch.Tensor, m: torch.Tensor,
                 eps: float = DEFAULT_EPS) -> torch.Tensor:
    """All-pairs accelerations within one set, self-pairs excluded."""
    n = x.shape[1]
    dx = x[:, None, :] - x[:, :, None]            # (3, N, N)
    r2 = (dx * dx).sum(0) + eps * eps
    mask = 1.0 - torch.eye(n, dtype=x.dtype, device=x.device)
    w = m[None, :] * mask / (r2 * r2.sqrt())
    return _source_sum(dx * w)


def acc_direct_ref(x: torch.Tensor, m: torch.Tensor,
                   eps: float = DEFAULT_EPS) -> torch.Tensor:
    """O(N^2) direct sum over the whole particle set — the ground truth the
    Barnes-Hut approximation is measured against (the reference's
    expression: one product over all sources, self-pairs excluded)."""
    n = x.shape[1]
    dx = x[:, None, :] - x[:, :, None]
    r2 = (dx * dx).sum(0) + eps * eps
    mask = 1.0 - torch.eye(n, dtype=x.dtype, device=x.device)
    w = r2 ** -1.5 * m[None, :] * mask
    return torch.einsum("dij,ij->di", dx, w)
