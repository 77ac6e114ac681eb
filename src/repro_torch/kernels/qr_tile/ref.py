"""Plain PyTorch versions of the four tiled-QR tile ops (Buttari et al.
2009, paper §4.1): the port of ``repro/kernels/qr_tile/ref.py``.

Straightforward column-by-column Householder loops on one (b,b) float32
tile.  On the CPU they are what the ops wrappers run; on the card
``chip_smoke.py`` holds the CUDA kernels against them.  Each function
works on a clone of its input and updates that clone in place, where the
reference rebuilt immutable arrays.

Conventions (LAPACK compact-WY, as in the reference):
  * ``geqrf``:  A (b,b) -> RV (R in upper triangle incl. diag, Householder
    vectors V in strict lower triangle, unit diagonal implicit), tau (b,),
    T (b,b upper triangular) with  Q = I - V @ T @ V.T.
  * ``apply_qt``: C <- Q^T C = C - V @ T.T @ (V.T @ C).
  * ``tsqrf``: QR of the stacked (2b,b) [R; A] with R upper triangular.
    Householder vectors are [e_j; v2_j]: the top block is the identity, so
    only the dense bottom block V2 (b,b) is stored.  Returns (R', V2, tau,
    T).
  * ``apply_tsqt``: [C1; C2] <- Q^T [C1; C2]:
        W  = T.T @ (C1 + V2.T @ C2)
        C1 <- C1 - W ;  C2 <- C2 - V2 @ W.
"""

from __future__ import annotations

import torch


def _householder(alpha: torch.Tensor, sigma2: torch.Tensor):
    """Scalar Householder quantities for pivot ``alpha`` and below-pivot
    squared norm ``sigma2`` (0-d tensors, kept on the device).  Returns
    (beta, tau, inv_denom) with the LAPACK convention H = I - tau v v^T,
    v[pivot] = 1; ``sigma2 == 0`` gives tau = 0 and inv = 0."""
    zero = sigma2 == 0.0
    one = torch.ones_like(alpha)
    nil = torch.zeros_like(alpha)
    sign = torch.where(alpha >= 0.0, one, -one)
    beta = torch.where(zero, alpha, -sign * torch.sqrt(alpha * alpha + sigma2))
    tau = torch.where(zero, nil, (beta - alpha) / torch.where(zero, one, beta))
    denom = alpha - beta
    inv = torch.where(zero, nil,
                      1.0 / torch.where(denom == 0.0, one, denom))
    return beta, tau, inv


def geqrf_ref(a: torch.Tensor):
    """Householder QR of one (b,b) tile -> (RV, tau (b,), T)."""
    b = a.shape[0]
    assert a.shape == (b, b)
    a = a.clone()
    idx = torch.arange(b, device=a.device)
    taus = []
    for j in range(b):
        x = a[:, j].clone()
        below = idx > j
        sigma2 = torch.sum(torch.where(below, x, 0.0) ** 2)
        beta, tau, inv = _householder(x[j], sigma2)
        v = torch.where(below, x * inv, 0.0)
        v[j] = 1.0
        # only trailing columns are updated; earlier columns hold stored V
        w = torch.where(idx > j, tau * (v @ a), 0.0)
        a -= torch.outer(v, w)
        # store R entry and V below the diagonal (LAPACK layout)
        a[j, j] = beta
        a[:, j] = torch.where(below, v, a[:, j])
        taus.append(tau)
    tau = torch.stack(taus)
    t = _build_t(torch.tril(a, -1) + torch.eye(b, dtype=a.dtype,
                                                 device=a.device), tau)
    return a, tau, t


def _build_t(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Compact-WY T factor:  T[:j,j] = -tau_j * T[:j,:j] @ (V[:, :j]^T v_j),
    T[j,j] = tau_j."""
    b = v.shape[1]
    idx = torch.arange(b, device=v.device)
    t = torch.zeros((b, b), dtype=v.dtype, device=v.device)
    for j in range(b):
        u = torch.where(idx < j, v.T @ v[:, j], 0.0)
        col = -tau[j] * (t @ u)
        col[j] = tau[j]
        t[:, j] = col
    return t


def apply_qt_ref(rv: torch.Tensor, t: torch.Tensor, c: torch.Tensor):
    """C <- Q^T C with Q = I - V T V^T from ``geqrf_ref``."""
    b = rv.shape[0]
    v = torch.tril(rv, -1) + torch.eye(b, dtype=rv.dtype, device=rv.device)
    return c - v @ (t.T @ (v.T @ c))


def tsqrf_ref(r: torch.Tensor, a: torch.Tensor):
    """QR of [R; A] (triangle-on-top-of-square) -> (R', V2, tau, T)."""
    b = r.shape[0]
    assert a.shape == (b, b)
    r = r.clone()
    a = a.clone()
    v2 = torch.zeros((b, b), dtype=a.dtype, device=a.device)
    taus = []
    for j in range(b):
        x = a[:, j]
        beta, tau, inv = _householder(r[j, j].clone(), torch.sum(x * x))
        v = x * inv                      # bottom block of the reflector
        # w_m = R[j,m] + v^T A[:,m]  for every column m
        w = r[j, :] + v @ a
        r[j, :] -= tau * w
        a -= tau * torch.outer(v, w)
        r[j, j] = beta
        a[:, j] = 0.0
        v2[:, j] = v
        taus.append(tau)
    tau = torch.stack(taus)
    t = _build_t(v2, tau)  # top identity blocks contribute nothing
    return r, v2, tau, t


def apply_tsqt_ref(v2: torch.Tensor, t: torch.Tensor, c1: torch.Tensor,
                   c2: torch.Tensor):
    """[C1; C2] <- Q^T [C1; C2] for the TS reflectors of ``tsqrf_ref``."""
    w = t.T @ (c1 + v2.T @ c2)
    return c1 - w, c2 - v2 @ w
