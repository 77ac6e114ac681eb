"""ctypes binding of the hand-written tiled-QR CUDA kernels (``csrc/``).

``csrc/qr_tile.cuh`` holds the four tile ops as ``__device__`` functions;
``csrc/qr_tile.cu`` wraps them in batched per-op kernels (one block per
tile) and in the task-table walk ``qr_walk`` (one block per row of one
write-colored phase), and exports a plain C launcher for each.  They
replace the Pallas kernels ``repro/kernels/qr_tile/kernel.py::geqrf``,
``tsqrf``, ``apply_qt``, ``apply_tsqt`` and the walk
``repro/engine/megakernel.py::qr_round_fn``.

The library is built from those sources by ``repro_torch._build`` at the
first launch, never at import, so this module imports on a machine with
no ``nvcc`` and no card.  Every launcher takes contiguous float32 CUDA
tensors whose checks the caller (``ops``, ``engine.megakernel``) has
made, launches on PyTorch's current stream, raises if the launch was
refused, and adds one to its entry of ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "qr_tile.cu",)
HEADERS = (CSRC / "qr_tile.cuh",)

MAX_B = 64         # QR_MAX_B in csrc/qr_tile.cuh: six padded tiles in smem

# kernel launches by wrapper, and plain-version calls taken by a wrapper
# because its tensor lay on the CPU; chip_smoke.py zeroes both before the
# main path and reads them after it
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("geqrf", "tsqrf", "apply_qt", "apply_tsqt", "qr_walk"), 0)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_COUNT_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "qr_init": (),
    "qr_geqrf": (_P, _P, _P, _P, _I, _I, _P),
    "qr_tsqrf": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    "qr_apply_qt": (_P, _P, _P, _P, _I, _I, _P),
    "qr_apply_tsqt": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    "qr_walk": (_P, _I, _I, _I, _P, _P, _I, _P),
}


def count(table: Dict[str, int], name: str) -> None:
    with _COUNT_LOCK:          # threaded-backend workers count concurrently
        table[name] += 1


def reset_counts() -> None:
    with _COUNT_LOCK:
        for table in (LAUNCHES, PLAIN_CALLS):
            for k in table:
                table[k] = 0


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} was not launched: "
                           f"cudaError {err}")


def lib() -> ctypes.CDLL:
    """The built kernel library (built and loaded at the first call)."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
            if _LIB is None:
                from repro_torch import _build
                path = _build.build(SOURCES, HEADERS)["qr_tile"]
                handle = ctypes.CDLL(str(path))
                for name, args in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = list(args)
                    fn.restype = ctypes.c_int
                _check(handle.qr_init(), "qr_init")
                _LIB = handle
    return _LIB


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def geqrf(a, rv, tau, t) -> None:
    """(n,b,b) tiles -> rv, t (n,b,b) and tau (n,b); one block per tile."""
    n, b = a.shape[0], a.shape[-1]
    _check(lib().qr_geqrf(_ptr(a), _ptr(rv), _ptr(tau), _ptr(t), n, b,
                          _stream()), "geqrf")
    count(LAUNCHES, "geqrf")


def tsqrf(r, a, r1, v2, tau, t) -> None:
    n, b = a.shape[0], a.shape[-1]
    _check(lib().qr_tsqrf(_ptr(r), _ptr(a), _ptr(r1), _ptr(v2), _ptr(tau),
                          _ptr(t), n, b, _stream()), "tsqrf")
    count(LAUNCHES, "tsqrf")


def apply_qt(rv, t, c, out) -> None:
    n, b = c.shape[0], c.shape[-1]
    _check(lib().qr_apply_qt(_ptr(rv), _ptr(t), _ptr(c), _ptr(out), n, b,
                             _stream()), "apply_qt")
    count(LAUNCHES, "apply_qt")


def apply_tsqt(v2, t, c1, c2, o1, o2) -> None:
    n, b = c1.shape[0], c1.shape[-1]
    _check(lib().qr_apply_tsqt(_ptr(v2), _ptr(t), _ptr(c1), _ptr(c2),
                               _ptr(o1), _ptr(o2), n, b, _stream()),
           "apply_tsqt")
    count(LAUNCHES, "apply_tsqt")


def qr_walk(desc, row0: int, row1: int, tiles, tmat) -> None:
    """Walk rows ``[row0, row1)`` of the device ``desc`` (one write-colored
    phase) over the (ntiles,b,b) ``tiles``/``tmat`` stacks, in place."""
    _check(lib().qr_walk(_ptr(desc), row0, row1 - row0, desc.shape[1],
                         _ptr(tiles), _ptr(tmat), tiles.shape[-1],
                         _stream()), "qr_walk")
    count(LAUNCHES, "qr_walk")
