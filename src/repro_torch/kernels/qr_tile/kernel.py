"""ctypes binding of the hand-written tiled-QR CUDA kernels (``csrc/``).

``csrc/qr_tile.cuh`` holds the four tile ops as ``__device__`` functions
(shared-memory bodies for b <= ``SHARED_MAX_B``; above it blocked bodies,
up to b = ``WIDE_MAX_B``, that work on the tiles in global memory through
a shared-memory layout sized by the panel);
``csrc/qr_tile.cu`` wraps them in batched per-op kernels (one block per
tile; past b = ``OUTER_MIN_B`` the applies take one block per 64-column
chunk of a tile, ``apply_chunks``) and in the task-table walk ``qr_walk``
(one cooperative launch a plan: every resident block strides over the
work items of each write-colored phase, a row each or an apply's chunk,
with a grid-wide barrier between phases), and exports a plain C launcher
for each.  They
replace the Pallas kernels ``repro/kernels/qr_tile/kernel.py::geqrf``,
``tsqrf``, ``apply_qt``, ``apply_tsqt`` and the walk
``repro/engine/megakernel.py::qr_round_fn``.

The library is built from those sources by ``repro_torch._build`` at the
first launch, never at import, so this module imports on a machine with
no ``nvcc`` and no card.  Every launcher takes contiguous float32 CUDA
tensors whose checks the caller (``ops``, ``engine.megakernel``) has
made, launches on PyTorch's current stream, raises if the launch was
refused, and adds one to its entry of ``LAUNCHES``.  No kernel takes
global scratch.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict

import torch

from repro_torch.kernels import _binding
from repro_torch.kernels._binding import count

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "qr_tile.cu"     # includes csrc/qr_tile.cuh

SHARED_MAX_B = 64  # QR_MAX_B in csrc/qr_tile.cuh: the widest tile of the
#                    shared-memory bodies (a panel holds 4 threads x 16 rows
#                    of a column in registers); wider tiles run the blocked
#                    bodies
WIDE_MAX_B = 8192  # QR_WIDE_MAX_B: the widest tile of the blocked bodies
#                    (a one-column panel, its rows over the block's 256
#                    threads, 32 a thread in registers; a 256 MB tile).
#                    The ops refuse wider tiles on every device
OUTER_MIN_B = 1024  # QR_OUTER_MIN_B: wider tiles factor in 64-column outer
#                    panels and apply Q in blocks of 64 reflectors, one
#                    64-column chunk of C a work item

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
    "qr_geqrf": (_P, _P, _P, _P, _I, _I, _P),
    "qr_tsqrf": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    "qr_apply_qt": (_P, _P, _P, _P, _I, _I, _P),
    "qr_apply_tsqt": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    "qr_walk": (_P, _P, _I, _I, _I, _P, _P, _I, _P),
    "qr_walk_grid": (_I, _P),
    "qr_chunks": (_I,),
    "qr_smem_bytes": (_I,),
}


def reset_counts() -> None:
    _binding.reset(LAUNCHES, PLAIN_CALLS)


_check, _ptr, _stream = _binding.check, _binding.ptr, _binding.stream


def check_shape(b: int) -> None:
    """Raise ValueError unless the ops take (b,b) tiles: 1 <= b <=
    ``WIDE_MAX_B`` (shared-memory bodies up to ``SHARED_MAX_B``, blocked
    bodies above: panels of 64 columns down to 1 as b grows).  The plain
    path on the CPU holds the same contract, so no tile size runs on one
    device and is refused on the other.  Needs no card."""
    if not 1 <= b <= WIDE_MAX_B:
        raise ValueError(f"tile size {b} not supported: the tile ops take "
                         f"b >= 1 and b <= {WIDE_MAX_B} on every device")


def apply_chunks(b: int) -> int:
    """Work items of an apply at tile size b (``qr_apply_chunks``): one a
    64-column chunk of C past ``OUTER_MIN_B``, else one.  Needs no card."""
    return -(-b // SHARED_MAX_B) if b > OUTER_MIN_B else 1


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


def walk_grid(b: int) -> int:
    """Blocks of the walk resident on the current card at tile size b: the
    largest grid its cooperative launch takes."""
    blocks = ctypes.c_int(0)
    _check(lib().qr_walk_grid(b, ctypes.addressof(blocks)), "qr_walk_grid")
    return blocks.value


def qr_walk(desc, offsets, max_items: int, tiles, tmat) -> None:
    """Walk every phase of the device ``desc`` in one cooperative launch:
    ``offsets`` is the int32 device copy of the phase row offsets
    (nphases + 1), ``max_items`` the most work items in a phase (host
    integer: a row each, an apply row ``apply_chunks(b)``; the grid is at
    most that), and the (ntiles,b,b) ``tiles``/``tmat`` stacks are updated
    in place.  A refused launch raises; there is no per-phase fallback."""
    b = tiles.shape[-1]
    _check(lib().qr_walk(_ptr(desc), _ptr(offsets), offsets.numel() - 1,
                         max_items, desc.shape[1], _ptr(tiles), _ptr(tmat),
                         b, _stream()), "qr_walk")
    count(LAUNCHES, "qr_walk")
