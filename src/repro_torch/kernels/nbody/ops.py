"""Public ops for the N-body interaction kernels: the counterpart of
``repro/kernels/nbody/ops.py``, whose ``backend`` switch is replaced by
the tensor's device.

* On CPU tensors an op runs its plain version (``ref``).
* On CUDA tensors it launches the hand-written kernel (``kernel``) after
  checking device, dtype and shapes, and raises if the kernel cannot build
  or launch.  It never falls back to the plain version.

The kernels take ragged sizes and strided views (a cell's slice of the
(3, N) positions, a gather of COM rows), so nothing is padded or copied;
outputs are new (3, Ni) tensors.  ``LAUNCHES`` counts kernel launches per
op and ``PLAIN_CALLS`` the plain-version calls taken for CPU tensors.
"""

from __future__ import annotations

import torch

from . import kernel, ref
from .kernel import LAUNCHES, PLAIN_CALLS, reset_counts
from .ref import DEFAULT_EPS

__all__ = ["acc_pair", "acc_self", "DEFAULT_EPS", "LAUNCHES",
           "PLAIN_CALLS", "reset_counts", "check_operands"]


def check_operands(xi: torch.Tensor, xj: torch.Tensor,
                   mj: torch.Tensor) -> None:
    """Validate targets (3,Ni), sources (3,Nj) and source masses (Nj,) for
    a launch: float32 CUDA tensors on one device (any strides)."""
    for t in (xi, xj, mj):
        if t.device.type != "cuda" or t.device != xi.device:
            raise ValueError(f"kernel operands must be CUDA tensors on one "
                             f"device, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"kernel operands must be float32, got "
                             f"{t.dtype}")
    if (xi.dim() != 2 or xi.shape[0] != 3 or xj.dim() != 2
            or xj.shape[0] != 3 or mj.shape != (xj.shape[1],)):
        raise ValueError(f"operands must be positions (3, n) and masses "
                         f"(n,), got {tuple(xi.shape)}, {tuple(xj.shape)}, "
                         f"{tuple(mj.shape)}")


def _on_cpu(*xs: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the plain path); operands
    anywhere else go to ``check_operands``, which accepts only CUDA."""
    return all(x.device.type == "cpu" for x in xs)


def acc_pair(xi: torch.Tensor, xj: torch.Tensor, mj: torch.Tensor,
             eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Accelerations (3,Ni) on ``xi`` (3,Ni) from sources ``xj`` (3,Nj)
    with masses ``mj`` (Nj,); disjoint sets."""
    if _on_cpu(xi, xj, mj):
        kernel.count(PLAIN_CALLS, "acc_pair")
        return ref.acc_pair_ref(xi, xj, mj, eps)
    check_operands(xi, xj, mj)
    out = torch.empty((3, xi.shape[1]), dtype=xi.dtype, device=xi.device)
    if xi.shape[1]:
        kernel.acc_pair(xi, xj, mj, eps * eps, out)
    return out


def acc_self(x: torch.Tensor, m: torch.Tensor,
             eps: float = DEFAULT_EPS) -> torch.Tensor:
    """All-pairs accelerations (3,N) within one set, i == j excluded."""
    if _on_cpu(x, m):
        kernel.count(PLAIN_CALLS, "acc_self")
        return ref.acc_self_ref(x, m, eps)
    check_operands(x, x, m)
    out = torch.empty((3, x.shape[1]), dtype=x.dtype, device=x.device)
    if x.shape[1]:
        kernel.acc_self(x, m, eps * eps, out)
    return out
