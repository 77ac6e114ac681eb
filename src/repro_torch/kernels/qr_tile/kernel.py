"""ctypes binding of the hand-written tiled-QR CUDA kernels (``csrc/``).

``csrc/qr_tile.cuh`` holds the four tile ops as ``__device__`` functions
(shared-memory bodies for b <= ``SHARED_MAX_B``, global-memory bodies with
``scratch_floats(b)`` floats of scratch a block above it);
``csrc/qr_tile.cu`` wraps them in batched per-op kernels (one block per
tile) and in the task-table walk ``qr_walk`` (one cooperative launch a
plan: every resident block strides over the rows of each write-colored
phase, with a grid-wide barrier between phases), and exports a plain C
launcher for each.  They
replace the Pallas kernels ``repro/kernels/qr_tile/kernel.py::geqrf``,
``tsqrf``, ``apply_qt``, ``apply_tsqt`` and the walk
``repro/engine/megakernel.py::qr_round_fn``.

The library is built from those sources by ``repro_torch._build`` at the
first launch, never at import, so this module imports on a machine with
no ``nvcc`` and no card.  Every launcher takes contiguous float32 CUDA
tensors whose checks the caller (``ops``, ``engine.megakernel``) has
made, launches on PyTorch's current stream, raises if the launch was
refused, and adds one to its entry of ``LAUNCHES``.  Above
``SHARED_MAX_B`` each launcher allocates the wide bodies' scratch with
``torch.empty``.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import _binding
from repro_torch.kernels._binding import count

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "qr_tile.cu"     # includes csrc/qr_tile.cuh

SHARED_MAX_B = 64  # QR_MAX_B in csrc/qr_tile.cuh: the widest tile of the
#                    shared-memory bodies (a panel holds 4 threads x 16 rows
#                    of a column in registers); wider tiles run the
#                    global-memory bodies

# kernel launches by wrapper, and plain-version calls taken by a wrapper
# because its tensor lay on the CPU; chip_smoke.py zeroes both before the
# main path and reads them after it
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("geqrf", "tsqrf", "apply_qt", "apply_tsqt", "qr_walk"), 0)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_LOAD_LOCK = threading.Lock()
_LIB = None

_P, _I = _binding.P, _binding.I
_SIGNATURES = {
    "qr_init": (),
    "qr_geqrf": (_P, _P, _P, _P, _P, _I, _I, _P),
    "qr_tsqrf": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "qr_apply_qt": (_P, _P, _P, _P, _P, _I, _I, _P),
    "qr_apply_tsqt": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "qr_walk": (_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P),
    "qr_walk_grid": (_I, _P),
}


def reset_counts() -> None:
    _binding.reset(LAUNCHES, PLAIN_CALLS)


_check, _ptr, _stream = _binding.check, _binding.ptr, _binding.stream


def check_shape(b: int) -> None:
    """Raise ValueError unless the kernels take (b,b) tiles: any b >= 1
    (shared-memory bodies up to ``SHARED_MAX_B``, global-memory bodies
    above).  Needs no card."""
    if b < 1:
        raise ValueError(f"tile size {b} not supported: the CUDA kernels "
                         f"take b >= 1")


def scratch_floats(b: int) -> int:
    """Floats of global scratch one block takes at tile size b
    (``qr_wide_floats`` in ``csrc/qr_tile.cuh``): a b x b tile, a b-vector
    and the b taus above ``SHARED_MAX_B``, none at or below it."""
    return b * b + 2 * b if b > SHARED_MAX_B else 0


def _scratch(like: torch.Tensor, blocks: int, b: int
             ) -> Optional[torch.Tensor]:
    """The wide bodies' scratch for ``blocks`` blocks, or None."""
    n = scratch_floats(b)
    return (torch.empty(blocks * n, dtype=torch.float32, device=like.device)
            if n else None)


def _ptr_or_null(x: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if x is None else _ptr(x)


def lib() -> ctypes.CDLL:
    """The built kernel library (built and loaded at the first call)."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
            if _LIB is None:
                handle = _binding.load(SOURCE, _SIGNATURES)
                _check(handle.qr_init(), "qr_init")
                _LIB = handle
    return _LIB


def geqrf(a, rv, tau, t) -> None:
    """(n,b,b) tiles -> rv, t (n,b,b) and tau (n,b); one block per tile."""
    n, b = a.shape[0], a.shape[-1]
    ws = _scratch(a, n, b)
    _check(lib().qr_geqrf(_ptr(a), _ptr(rv), _ptr(tau), _ptr(t),
                          _ptr_or_null(ws), n, b, _stream()), "geqrf")
    count(LAUNCHES, "geqrf")


def tsqrf(r, a, r1, v2, tau, t) -> None:
    n, b = a.shape[0], a.shape[-1]
    ws = _scratch(a, n, b)
    _check(lib().qr_tsqrf(_ptr(r), _ptr(a), _ptr(r1), _ptr(v2), _ptr(tau),
                          _ptr(t), _ptr_or_null(ws), n, b, _stream()),
           "tsqrf")
    count(LAUNCHES, "tsqrf")


def apply_qt(rv, t, c, out) -> None:
    n, b = c.shape[0], c.shape[-1]
    ws = _scratch(c, n, b)
    _check(lib().qr_apply_qt(_ptr(rv), _ptr(t), _ptr(c), _ptr(out),
                             _ptr_or_null(ws), n, b, _stream()), "apply_qt")
    count(LAUNCHES, "apply_qt")


def apply_tsqt(v2, t, c1, c2, o1, o2) -> None:
    n, b = c1.shape[0], c1.shape[-1]
    ws = _scratch(c1, n, b)
    _check(lib().qr_apply_tsqt(_ptr(v2), _ptr(t), _ptr(c1), _ptr(c2),
                               _ptr(o1), _ptr(o2), _ptr_or_null(ws), n, b,
                               _stream()), "apply_tsqt")
    count(LAUNCHES, "apply_tsqt")


def walk_grid(b: int) -> int:
    """Blocks of the walk resident on the current card at tile size b: the
    largest grid its cooperative launch takes."""
    blocks = ctypes.c_int(0)
    _check(lib().qr_walk_grid(b, ctypes.addressof(blocks)), "qr_walk_grid")
    return blocks.value


def qr_walk(desc, offsets, max_rows: int, tiles, tmat) -> None:
    """Walk every phase of the device ``desc`` in one cooperative launch:
    ``offsets`` is the int32 device copy of the phase row offsets
    (nphases + 1), ``max_rows`` the longest phase (host integer), and the
    (ntiles,b,b) ``tiles``/``tmat`` stacks are updated in place.  A
    refused launch raises; there is no per-phase fallback.  Above
    ``SHARED_MAX_B`` the scratch covers every block the launch takes:
    the resident grid, capped at the longest phase."""
    b = tiles.shape[-1]
    blocks = min(walk_grid(b), max(max_rows, 1)) if scratch_floats(b) else 0
    ws = _scratch(tiles, blocks, b)
    _check(lib().qr_walk(_ptr(desc), _ptr(offsets), offsets.numel() - 1,
                         max_rows, desc.shape[1], _ptr(tiles), _ptr(tmat),
                         _ptr_or_null(ws), blocks, b, _stream()), "qr_walk")
    count(LAUNCHES, "qr_walk")
