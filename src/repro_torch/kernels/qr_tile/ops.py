"""Public ops for the tiled-QR tile kernels.

Each op takes one (b,b) tile or a stack of n tiles (n,b,b), float32:

* on a CPU tensor it runs the plain version (``ref``), tile by tile — a
  stack loops the single-tile function, so a batched call is bitwise equal
  to the calls it stands for — after ``kernel.check_shape``, so that the
  tile sizes taken do not depend on the device;
* on a CUDA tensor it launches the hand-written kernel (``kernel``), one
  block per tile, after checking device, dtype, shape (1 <= b <=
  ``kernel.WIDE_MAX_B``) and contiguity, and raises if the kernel cannot
  build or launch.  It never
  falls back to the plain version.

Outputs are new tensors (``torch.empty``).  ``LAUNCHES`` counts kernel
launches per op and ``PLAIN_CALLS`` the plain-version calls taken for CPU
tensors.  The counterpart of ``repro/kernels/qr_tile/ops.py``, whose
``backend`` switch is replaced by the tensor's device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from . import kernel, ref
from .kernel import LAUNCHES, PLAIN_CALLS, reset_counts

__all__ = ["geqrf", "tsqrf", "apply_qt", "apply_tsqt", "LAUNCHES",
           "PLAIN_CALLS", "reset_counts", "check_tiles"]


def check_tiles(*xs: torch.Tensor) -> int:
    """Validate tiles for a kernel launch; returns b."""
    b = xs[0].shape[-1]
    for x in xs:
        if x.device.type != "cuda":
            raise ValueError(f"kernel operands must be CUDA tensors, got "
                             f"{x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"kernel operands must be float32, got "
                             f"{x.dtype}")
        if x.shape != xs[0].shape or x.shape[-2:] != (b, b):
            raise ValueError(f"operands must be matching (b,b) tiles, got "
                             f"{[tuple(y.shape) for y in xs]}")
        if not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    kernel.check_shape(b)
    return b


def _on_cpu(*xs: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the plain path); operands
    anywhere else go to ``check_tiles``, which accepts only CUDA."""
    return all(x.device.type == "cpu" for x in xs)


def _plain(name: str, fn: Callable, *xs: torch.Tensor) -> Tuple:
    kernel.check_shape(xs[0].shape[-1])
    kernel.count(PLAIN_CALLS, name)
    if xs[0].dim() == 2:
        return fn(*xs)
    outs = [fn(*one) for one in zip(*xs)]
    return tuple(torch.stack(o) for o in zip(*outs))


def _stacked(xs):
    """(batched?, n-stacked views) of 2-D or 3-D operands."""
    batched = xs[0].dim() == 3
    return batched, [x if batched else x.unsqueeze(0) for x in xs]


def _unstack(batched: bool, outs):
    return tuple(outs) if batched else tuple(o[0] for o in outs)


def geqrf(a: torch.Tensor):
    """Householder QR of each tile -> (RV, tau, T)."""
    if _on_cpu(a):
        return _plain("geqrf", ref.geqrf_ref, a)
    check_tiles(a)
    batched, (a3,) = _stacked([a])
    rv, t = torch.empty_like(a3), torch.empty_like(a3)
    tau = torch.empty(a3.shape[:2], dtype=a3.dtype, device=a3.device)
    kernel.geqrf(a3, rv, tau, t)
    return _unstack(batched, (rv, tau, t))


def tsqrf(r: torch.Tensor, a: torch.Tensor):
    """QR of each [R; A] pair -> (R', V2, tau, T)."""
    if _on_cpu(r, a):
        return _plain("tsqrf", ref.tsqrf_ref, r, a)
    check_tiles(r, a)
    batched, (r3, a3) = _stacked([r, a])
    r1, v2, t = (torch.empty_like(a3) for _ in range(3))
    tau = torch.empty(a3.shape[:2], dtype=a3.dtype, device=a3.device)
    kernel.tsqrf(r3, a3, r1, v2, tau, t)
    return _unstack(batched, (r1, v2, tau, t))


def apply_qt(rv: torch.Tensor, t: torch.Tensor, c: torch.Tensor):
    """C <- Q^T C for each tile triple."""
    if _on_cpu(rv, t, c):
        return _plain("apply_qt", lambda *x: (ref.apply_qt_ref(*x),),
                      rv, t, c)[0]
    check_tiles(rv, t, c)
    batched, (rv3, t3, c3) = _stacked([rv, t, c])
    out = torch.empty_like(c3)
    kernel.apply_qt(rv3, t3, c3, out)
    return _unstack(batched, (out,))[0]


def apply_tsqt(v2: torch.Tensor, t: torch.Tensor, c1: torch.Tensor,
               c2: torch.Tensor):
    """[C1; C2] <- Q^T [C1; C2] for each tile quadruple -> (C1', C2')."""
    if _on_cpu(v2, t, c1, c2):
        return _plain("apply_tsqt", ref.apply_tsqt_ref, v2, t, c1, c2)
    check_tiles(v2, t, c1, c2)
    batched, (v3, t3, c13, c23) = _stacked([v2, t, c1, c2])
    o1, o2 = torch.empty_like(c13), torch.empty_like(c23)
    kernel.apply_tsqt(v3, t3, c13, c23, o1, o2)
    return _unstack(batched, (o1, o2))
