"""ctypes binding of the hand-written pipeline walk (K9, ``csrc/``).

``csrc/pipe_walk.cu`` holds the walk kernel and its plain C launcher: one
launch walks one write-colored phase of a lowered pipeline table, each row
split into tiles, one block a tile (the file's header says how).  It
replaces the Pallas walk ``repro/engine/megakernel.py::pipe_round_fn``
(``_pipe_kernel``).  ``engine.megakernel.pipe_round_fn`` drives it, one
launch per non-empty phase.

The library is built from that source by ``repro_torch._build`` at the
first launch, never at import, so this module imports on a machine with
no ``nvcc`` and no card.  The launcher takes contiguous float32 CUDA
tensors whose checks the caller (``engine.megakernel``) has made, launches
on PyTorch's current stream, raises if the launch was refused, and adds
one to ``LAUNCHES["pipe_walk"]``.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import _binding
from repro_torch.kernels._binding import count

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "pipe_walk.cu"

# the tile shape of csrc/pipe_walk.cu (ACT_TM, ACT_TN, KSPLIT, GW_T),
# checked against the library when it loads: (Bt, D) tiles of the F and
# cot_in products, each split over the reduction into blocks of KSPLIT,
# and (D, D) tiles of the gW products and of U
ACT_TM, ACT_TN, KSPLIT, GW_T = 32, 64, 256, 64

# kernel launches, and plain-walk calls taken because the state lay on the
# CPU; chip_smoke.py zeroes both before the main path and reads them after
LAUNCHES: Dict[str, int] = {"pipe_walk": 0}
PLAIN_CALLS: Dict[str, int] = {"pipe_walk": 0}

_LOAD_LOCK = threading.Lock()
_LIB = None

_P, _I, _F = _binding.P, _binding.I, _binding.F
_SIGNATURES = {
    "pipe_walk": (_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P),
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
                handle = _binding.load(SOURCE, _SIGNATURES)
                shape = (ctypes.c_int * 4)()
                handle.pipe_tile_shape.restype = None
                handle.pipe_tile_shape(shape)
                want = (ACT_TM, ACT_TN, KSPLIT, GW_T)
                if tuple(shape) != want:
                    raise RuntimeError(f"pipe_walk.cu tiles {tuple(shape)}"
                                       f" != {want}")
                _LIB = handle
    return _LIB


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def f_tiles(bt: int, dim: int) -> int:
    """Output tiles of one F row, and of the cot_in part of one B row."""
    return _cdiv(bt, ACT_TM) * _cdiv(dim, ACT_TN)


def k_splits(dim: int) -> int:
    """Blocks the reduction of each such tile is split into."""
    return _cdiv(dim, KSPLIT)


def tile_offsets(desc: np.ndarray, bt: int, dim: int) -> np.ndarray:
    """The CSR of the rows' blocks, (rows + 1,) int32: an F row has
    ``f_tiles × k_splits``, a B row the (D, D) grid plus, off the first
    stage, ``f_tiles × k_splits`` of cot_in, a U row the (D, D) grid, any
    other row none.  Rows are ``[etype, stage, micro, in_slot, out_slot,
    first, last]`` with the etypes of ``engine.megakernel`` (F 0, B 1, U
    2)."""
    desc = np.asarray(desc)
    et, first = desc[:, 0], desc[:, 5] > 0
    ntf, ngw = f_tiles(bt, dim) * k_splits(dim), _cdiv(dim, GW_T) ** 2
    n = np.where(et == 0, ntf, 0)
    n = np.where(et == 1, ngw + np.where(first, 0, ntf), n)
    n = np.where(et == 2, ngw, n)
    offs = np.concatenate([[0], np.cumsum(n, dtype=np.int64)])
    if offs[-1] >= 2 ** 31:
        raise ValueError(f"{offs[-1]} tiles do not index in int32")
    return offs.astype(np.int32)


def scratch(n_micro: int, max_rows: int, bt: int, dim: int,
            device) -> Tuple[torch.Tensor, ...]:
    """The walk's scratch for phases of up to ``max_rows`` rows: the loss's
    per-tile partials (M, f_tiles) and tickets (M,), the split-K partial
    products (max_rows, k_splits, f_tiles, ACT_TM·ACT_TN) and their tickets
    (max_rows, f_tiles).  Tickets start at 0 and the walk leaves them so."""
    ntf, nks = f_tiles(bt, dim), k_splits(dim)
    return (torch.empty((n_micro, ntf), dtype=torch.float32, device=device),
            torch.zeros(n_micro, dtype=torch.int32, device=device),
            torch.empty((max_rows, nks, ntf, ACT_TM * ACT_TN),
                        dtype=torch.float32, device=device),
            torch.zeros((max_rows, ntf), dtype=torch.int32, device=device))


def pipe_walk(desc, tile_offs, row0: int, row1: int, tile0: int,
              ntiles: int, statics, buffers, scratch_bufs, inv_m: float,
              inv_numel: float) -> None:
    """Walk rows ``[row0, row1)`` of ``desc`` (one write-colored phase),
    blocks ``tile0 .. tile0 + ntiles`` of ``tile_offs`` (int32, on the
    card): ``statics`` (w, b, x, y) are read, ``buffers`` (acts, cots, gw,
    gb, loss) updated in place; ``scratch_bufs`` is ``scratch(...)`` for
    at least ``row1 - row0`` rows."""
    w, b, x, y = statics
    acts, cots, gw, gb, loss = buffers
    partials, counters, split, tickets = scratch_bufs
    if split.shape[0] < row1 - row0:
        raise ValueError(f"split-K scratch for {split.shape[0]} rows, the "
                         f"phase has {row1 - row0}")
    _check(lib().pipe_walk(_ptr(desc), desc.shape[1], _ptr(tile_offs), row0,
                           row1, tile0, ntiles, _ptr(w), _ptr(b), _ptr(x),
                           _ptr(y), _ptr(acts), _ptr(cots), _ptr(gw),
                           _ptr(gb), _ptr(loss), _ptr(partials),
                           _ptr(counters), _ptr(split), _ptr(tickets),
                           acts.shape[1], acts.shape[2], inv_m, inv_numel,
                           _stream()),
           "pipe_walk")
    count(LAUNCHES, "pipe_walk")
