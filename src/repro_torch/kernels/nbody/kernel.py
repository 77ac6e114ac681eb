"""ctypes binding of the hand-written Barnes-Hut CUDA kernels (``csrc/``).

``csrc/nbody.cuh`` holds the softened-gravity sum as a ``__device__``
function; ``csrc/nbody.cu`` holds the per-op kernels ``acc_pair`` (K6) and
``acc_self`` (K7), one template whose blocks cover targets x source slices
(the slices' partial sums added in slice order, so a call repeats bit for
bit), and the task-table walk ``bh_walk`` (K8), one block per bucket of a
launch group, and exports a plain C launcher for each.  They replace the
Pallas kernels ``repro/kernels/nbody/kernel.py::acc_pair``, ``acc_self`` and the walk
``repro/engine/megakernel.py::bh_round_fn``.

The library is built from those sources by ``repro_torch._build`` at the
first launch, never at import, so this module imports on a machine with
no ``nvcc`` and no card.  Every launcher takes float32 CUDA tensors whose
checks the caller (``ops``, ``engine.megakernel``) has made, launches on
PyTorch's current stream, raises if the launch was refused, and adds one
to its entry of ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict

from repro_torch.kernels import _binding
from repro_torch.kernels._binding import count

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "nbody.cu"     # includes csrc/nbody.cuh

MAX_P = 1024       # NB_MAX_P in csrc/nbody.cuh: one walk thread a particle

# kernel launches by wrapper, and plain-version calls taken by a wrapper
# because its tensor lay on the CPU; chip_smoke.py zeroes both before the
# main path and reads them after it
LAUNCHES: Dict[str, int] = dict.fromkeys(("acc_pair", "acc_self",
                                          "bh_walk"), 0)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_LOAD_LOCK = threading.Lock()
_LIB = None

_P, _I, _L, _F = _binding.P, _binding.I, _binding.I64, _binding.F
_SIGNATURES = {
    "nb_acc_pair": (_P, _L, _L, _I, _P, _L, _L, _P, _L, _I, _F, _P, _P),
    "nb_acc_self": (_P, _L, _L, _P, _L, _I, _F, _P, _P),
    "bh_walk": (_P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I, _F, _P),
}


def reset_counts() -> None:
    _binding.reset(LAUNCHES, PLAIN_CALLS)


_check, _ptr, _stream = _binding.check, _binding.ptr, _binding.stream


def lib() -> ctypes.CDLL:
    """The built kernel library (built and loaded at the first call)."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
            if _LIB is None:
                _LIB = _binding.load(SOURCE, _SIGNATURES)
    return _LIB


def acc_pair(xi, xj, mj, eps2: float, out) -> None:
    """out (3,Ni) <- the pull of (xj (3,Nj), mj (Nj,)) on xi (3,Ni); the
    inputs may be strided views.  Ni >= 1; Nj may be 0 (out is then
    zero)."""
    _check(lib().nb_acc_pair(_ptr(xi), *xi.stride(), xi.shape[1], _ptr(xj),
                             *xj.stride(), _ptr(mj), mj.stride(0),
                             xj.shape[1], eps2, _ptr(out), _stream()),
           "acc_pair")
    count(LAUNCHES, "acc_pair")


def acc_self(x, m, eps2: float, out) -> None:
    """out (3,N) <- all pairs within (x (3,N), m (N,)), i == j excluded."""
    _check(lib().nb_acc_self(_ptr(x), *x.stride(), _ptr(m), m.stride(0),
                             x.shape[1], eps2, _ptr(out), _stream()),
           "acc_self")
    count(LAUNCHES, "acc_self")


def bh_walk(desc, bucket_ptr, b0: int, b1: int, xs, ms, acc, com, cmass,
            eps2: float) -> None:
    """Walk buckets ``[b0, b1)`` of one launch group: ``desc`` holds the
    rows in bucket order, ``bucket_ptr`` the bucket CSR (int32, on the
    card); the state buffers are updated in place."""
    _check(lib().bh_walk(_ptr(desc), desc.shape[1], _ptr(bucket_ptr), b0,
                         b1 - b0, _ptr(xs), _ptr(ms), _ptr(acc), _ptr(com),
                         _ptr(cmass), xs.shape[2], eps2, _stream()),
           "bh_walk")
    count(LAUNCHES, "bh_walk")
