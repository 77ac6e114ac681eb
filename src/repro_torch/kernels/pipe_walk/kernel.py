"""ctypes binding of the hand-written pipeline walk (K9, ``csrc/``).

``csrc/pipe_walk.cu`` holds the walk kernel and its plain C launcher: one
cooperative launch walks a whole lowered pipeline table, its resident
blocks taking each write-colored phase's tiles from a counter, with a grid
barrier between phases (the file's header says how).  It replaces the Pallas walk
``repro/engine/megakernel.py::pipe_round_fn`` (``_pipe_kernel``).
``engine.megakernel.pipe_round_fn`` drives it: ``work_list`` cuts the
table's phases into segments of tiles on the host, ``upload`` copies them
to the card, and ``pipe_walk`` launches once.

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
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _binding
from repro_torch.kernels._binding import count

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "pipe_walk.cu"

# the tile shape of csrc/pipe_walk.cu, checked against the library when it
# loads: (Bt, D) tiles of the F and cot_in products (ACT_TM x ACT_TN), each
# split over the reduction into blocks of KSPLIT; (D, D) tiles of the gW
# products (GW_TM x GW_TN); U_TILE floats of gW a U tile scales
ACT_TM, ACT_TN, KSPLIT = 32, 256, 512
GW_TM, GW_TN, U_TILE = 64, 128, 8192

# segment kinds; a phase takes its segments in this order, the long
# split-K tiles first, so the short gW tiles fill the phase's tail
SEG_COT, SEG_F, SEG_GW, SEG_U = range(4)

# kernel launches, and plain-walk calls taken because the state lay on the
# CPU; chip_smoke.py zeroes both before the main path and reads them after
LAUNCHES: Dict[str, int] = {"pipe_walk": 0}
PLAIN_CALLS: Dict[str, int] = {"pipe_walk": 0}

_LOAD_LOCK = threading.Lock()
_LIB = None

_P, _I, _F = _binding.P, _binding.I, _binding.F
_SIGNATURES = {
    "pipe_walk": (_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P),
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
                shape = (ctypes.c_int * 6)()
                handle.pipe_tile_shape.restype = None
                handle.pipe_tile_shape(shape)
                want = (ACT_TM, ACT_TN, KSPLIT, GW_TM, GW_TN, U_TILE)
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


def gw_tiles(dim: int) -> int:
    """Tiles of the (D, D) gW product of one B row."""
    return _cdiv(dim, GW_TM) * _cdiv(dim, GW_TN)


def u_tiles(dim: int) -> int:
    """Tiles of one U row."""
    return _cdiv(dim * dim, U_TILE)


def _row_segments(desc: np.ndarray, bt: int, dim: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every row's segments: (rows, kinds, tiles).  An F row has one of
    ``f_tiles × k_splits`` tiles, a B row a gW segment and, off the first
    stage, a cot_in one of ``f_tiles × k_splits``, a U row one of
    ``u_tiles``, any other row none.  Rows are ``[etype, stage, micro,
    in_slot, out_slot, first, last]`` with the etypes of
    ``engine.megakernel`` (F 0, B 1, U 2)."""
    desc = np.asarray(desc)
    et, first = desc[:, 0], desc[:, 5] > 0
    q = np.arange(len(desc))
    ntf = f_tiles(bt, dim) * k_splits(dim)
    parts = [(q[(et == 1) & ~first], SEG_COT, ntf),
             (q[et == 0], SEG_F, ntf),
             (q[et == 1], SEG_GW, gw_tiles(dim)),
             (q[et == 2], SEG_U, u_tiles(dim))]
    rows = np.concatenate([p[0] for p in parts])
    kinds = np.concatenate([np.full(len(p[0]), p[1]) for p in parts])
    tiles = np.concatenate([np.full(len(p[0]), p[2], np.int64)
                            for p in parts])
    return rows, kinds, tiles


def tile_offsets(desc: np.ndarray, bt: int, dim: int) -> np.ndarray:
    """The CSR of the rows' tiles, (rows + 1,) int32, all segments of a
    row together."""
    rows, _, tiles = _row_segments(desc, bt, dim)
    n = np.bincount(rows, weights=tiles, minlength=len(desc))
    offs = np.concatenate([[0], np.cumsum(n.astype(np.int64))])
    if offs[-1] >= 2 ** 31:
        raise ValueError(f"{offs[-1]} tiles do not index in int32")
    return offs.astype(np.int32)


class WorkList(NamedTuple):
    """What the one launch walks, on the host: ``segs`` (segments, 3)
    ``[row, kind, slot]`` (slot: the row's place in its phase, which
    indexes the split-K scratch), ``seg_offs`` (segments + 1) the CSR of
    their tiles, ``phase_segs`` (phases + 1) each non-empty phase's
    segments, and the most tiles and rows a phase holds."""
    segs: np.ndarray
    seg_offs: np.ndarray
    phase_segs: np.ndarray
    max_tiles: int
    max_rows: int


def work_list(desc: np.ndarray, bounds: Sequence[int], bt: int,
              dim: int) -> WorkList:
    """The work list of rows ``bounds[0]:bounds[-1]`` of ``desc``, phase
    ``p`` being rows ``bounds[p]:bounds[p + 1]``: each phase's segments in
    the order of their kinds (``SEG_*``), rows in table order within a
    kind; phases without tiles are dropped."""
    bounds = np.asarray([int(b) for b in bounds], np.int64)
    rows, kinds, tiles = _row_segments(desc, bt, dim)
    inside = (rows >= bounds[0]) & (rows < bounds[-1])
    rows, kinds, tiles = rows[inside], kinds[inside], tiles[inside]
    phase = np.searchsorted(bounds, rows, side="right") - 1
    order = np.lexsort((rows, kinds, phase))
    rows, kinds, tiles, phase = (rows[order], kinds[order], tiles[order],
                                 phase[order])
    offs = np.concatenate([[0], np.cumsum(tiles)])
    if offs[-1] >= 2 ** 31:
        raise ValueError(f"{offs[-1]} tiles do not index in int32")
    live = np.unique(phase)
    phase_segs = np.searchsorted(phase, np.append(live, len(bounds)))
    per_phase = offs[phase_segs[1:]] - offs[phase_segs[:-1]]
    segs = np.stack([rows, kinds, rows - bounds[phase]], 1)
    return WorkList(segs.astype(np.int32), offs.astype(np.int32),
                    phase_segs.astype(np.int32),
                    int(per_phase.max(initial=0)),
                    int(np.diff(bounds).max(initial=0)))


def upload(work: WorkList, device) -> Tuple[torch.Tensor, ...]:
    """The work list's three arrays on ``device``, in one copy."""
    packed = torch.from_numpy(np.concatenate(
        [work.segs.ravel(), work.seg_offs, work.phase_segs])).to(device)
    n0, n1 = work.segs.size, work.seg_offs.size
    return (packed[:n0], packed[n0:n0 + n1], packed[n0 + n1:])


def scratch(n_slots: int, n_micro: int, max_rows: int, bt: int, dim: int,
            device) -> Tuple[torch.Tensor, ...]:
    """The walk's scratch for ``n_slots`` (S·M) activation slots and phases
    of up to ``max_rows`` rows: each slot's g = cot (1 - h^2) (n_slots, Bt,
    D), written with its cotangent, the loss's per-tile partials (M,
    f_tiles) and tickets (M,), the split-K partial products (max_rows,
    k_splits, f_tiles, ACT_TM·ACT_TN) and their tickets (max_rows,
    f_tiles).  Tickets start at 0 and the walk leaves them so."""
    ntf, nks = f_tiles(bt, dim), k_splits(dim)
    return (torch.empty((n_slots, bt, dim), dtype=torch.float32,
                        device=device),
            torch.empty((n_micro, ntf), dtype=torch.float32, device=device),
            torch.zeros(n_micro, dtype=torch.int32, device=device),
            torch.empty((max_rows, nks, ntf, ACT_TM * ACT_TN),
                        dtype=torch.float32, device=device),
            torch.zeros((max_rows, ntf), dtype=torch.int32, device=device))


def pipe_walk(desc, work: WorkList, d_work, statics, buffers, scratch_bufs,
              inv_m: float, inv_numel: float) -> None:
    """Walk the whole of ``work`` over ``desc`` (int32, on the card) in one
    cooperative launch: ``d_work`` is ``upload(work)``, ``statics`` (w, b,
    x, y) are read, ``buffers`` (acts, cots, gw, gb, loss) updated in
    place; ``scratch_bufs`` is ``scratch(...)`` for ``work.max_rows``
    rows."""
    w, b, x, y = statics
    acts, cots, gw, gb, loss = buffers
    g, partials, counters, split, tickets = scratch_bufs
    if tickets.shape[0] < work.max_rows:
        raise ValueError(f"split-K scratch for {tickets.shape[0]} rows, a "
                         f"phase has {work.max_rows}")
    segs, seg_offs, phase_segs = d_work
    nphases = len(work.phase_segs) - 1
    taken = torch.zeros(nphases, dtype=torch.int32, device=acts.device)
    _check(lib().pipe_walk(_ptr(desc), desc.shape[1], _ptr(segs),
                           _ptr(seg_offs), _ptr(phase_segs), _ptr(taken),
                           nphases, work.max_tiles,
                           _ptr(w), _ptr(b), _ptr(x), _ptr(y), _ptr(acts),
                           _ptr(cots), _ptr(gw), _ptr(gb), _ptr(loss),
                           _ptr(g), _ptr(partials), _ptr(counters),
                           _ptr(split),
                           _ptr(tickets), acts.shape[1], acts.shape[2],
                           inv_m, inv_numel, _stream()),
           "pipe_walk")
    count(LAUNCHES, "pipe_walk")
