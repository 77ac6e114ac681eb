"""The tiled-QR task-table walk: the port of the QR family of
``repro/engine/megakernel.py`` (``qr_round_fn`` → ``_grid_walk`` +
``_qr_kernel``).

A lowered plan is a ragged table of rows ``[etype, s0, s1, s2]`` split
into write-colored phases (``descriptors.lower_tables``); the rows of a
phase touch pairwise-disjoint tiles, and phases must run in order.  The
Pallas walk relied on its grid running in order on one TPU core.  CUDA
blocks of one launch run concurrently, so here the host launches the walk
kernel once per phase, in phase order, on one stream: the launch boundary
is the barrier between phases, and within a launch each row is one block
that switches on ``etype`` over the same ``__device__`` tile functions the
per-op kernels run (``kernels/qr_tile/csrc``).  The tile and T stacks are
updated in place, so the walk has no copy-in and no copy-out.

On CPU tensors ``qr_round_fn`` runs ``qr_walk_plain``, which applies the
same rows phase by phase through the plain tile functions
(``kernels/qr_tile/ref.py``) with exactly the calls the host backends
make, so the four execution modes stay bitwise equal on the CPU too.
``chip_smoke.py`` holds the kernel walk against the plain walk on the card.

Engine types equal ``apps.qr``'s task types; ``QR_NOOP`` and any other
type outside 0..3 is a no-op in both walks (a lowering-bug guard; tables
carry no no-op rows).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.qr_tile import kernel, ref
from repro_torch.kernels.qr_tile.ops import check_tiles

# QR engine types — intentionally equal to apps.qr.T_* so task types encode
# to themselves; QR_NOOP is the defensive clamp branch (never in a table).
QR_GEQRF, QR_LARFT, QR_TSQRF, QR_SSRFT, QR_NOOP = range(5)
QR_ARG_WIDTH = 3       # rows: [etype, slot0, slot1, slot2] (tile indices)


def qr_row_access(row: Sequence[int]) -> Tuple[Tuple, Tuple]:
    """QR keyspace: ``("t", slot)`` tile-stack rows, ``("m", slot)``
    T-factor rows (column-major tile index)."""
    et = row[0]
    if et == QR_GEQRF:
        s0 = row[1]
        return (("t", s0),), (("t", s0), ("m", s0))
    if et == QR_LARFT:
        s0, s1 = row[1], row[2]
        return (("t", s0), ("m", s0), ("t", s1)), (("t", s1),)
    if et == QR_TSQRF:
        s0, s1 = row[1], row[2]
        return (("t", s0), ("t", s1)), (("t", s0), ("t", s1), ("m", s1))
    if et == QR_SSRFT:
        s0, s1, s2 = row[1], row[2], row[3]
        return ((("t", s0), ("m", s0), ("t", s1), ("t", s2)),
                (("t", s1), ("t", s2)))
    return (), ()


def _plain_row(row: Sequence[int], tiles: torch.Tensor,
               tmat: torch.Tensor) -> None:
    et, s0, s1, s2 = (int(v) for v in row[:4])
    if et == QR_GEQRF:        # [kk] — factor the diagonal tile, stash T
        rv, _, t = ref.geqrf_ref(tiles[s0])
        tiles[s0] = rv
        tmat[s0] = t
    elif et == QR_LARFT:      # [kk, kj] — apply Qᵀ of the diagonal tile
        tiles[s1] = ref.apply_qt_ref(tiles[s0], tmat[s0], tiles[s1])
    elif et == QR_TSQRF:      # [kk, ik] — R over the rect tile; V stays
        a0 = tiles[s0]        # below kk's diagonal
        r1, v2, _, t = ref.tsqrf_ref(torch.triu(a0), tiles[s1])
        tiles[s0] = torch.triu(r1) + torch.tril(a0, -1)
        tiles[s1] = v2
        tmat[s1] = t
    elif et == QR_SSRFT:      # [ik, kj, ij] — apply the (I; V2) reflector
        o1, o2 = ref.apply_tsqt_ref(tiles[s0], tmat[s0], tiles[s1],
                                    tiles[s2])
        tiles[s1] = o1
        tiles[s2] = o2
    # QR_NOOP and anything out of range: no-op


def qr_walk_plain(desc, phase_bounds: Sequence[int], tiles: torch.Tensor,
                  tmat: torch.Tensor) -> None:
    """The plain walk: apply rows ``phase_bounds[0]:phase_bounds[-1]`` of
    ``desc`` phase by phase (each phase's rows in table order) through the
    plain tile functions, updating ``tiles``/``tmat`` in place.  Works on
    any device; the wrappers take it only for CPU tensors."""
    rows = torch.as_tensor(desc).cpu().tolist()
    for p0, p1 in zip(phase_bounds, phase_bounds[1:]):
        for q in range(int(p0), int(p1)):
            _plain_row(rows[q], tiles, tmat)


def _check_table(desc, phase_bounds: Sequence[int], ntiles: int) -> None:
    """Refuse a table the walk would run out of bounds on: phase bounds
    must be ascending row offsets into ``desc`` and every slot a tile
    index (one device sync for a CUDA ``desc``)."""
    bounds = [int(b) for b in phase_bounds]
    if bounds != sorted(bounds) or bounds[0] < 0 or bounds[-1] > len(desc):
        raise ValueError(f"phase bounds {bounds[0]}..{bounds[-1]} do not "
                         f"index the {len(desc)} rows of the table")
    slots = torch.as_tensor(desc)[:, 1:4]
    if slots.numel():
        lo, hi = torch.stack([slots.min(), slots.max()]).tolist()
        if lo < 0 or hi >= ntiles:
            raise ValueError(f"table slots {lo}..{hi} outside the "
                             f"{ntiles}-tile stack")


def qr_round_fn(desc: torch.Tensor, phase_bounds: Sequence[int], statics,
                buffers: Tuple[torch.Tensor, torch.Tensor]):
    """Walk executor for the QR family:
    ``(desc, phase_bounds, (), (tiles, tmat)) -> (tiles, tmat)``, updated
    in place.  ``phase_bounds`` are absolute row offsets into ``desc``
    (host integers); ``tiles``/``tmat`` are (ntiles, b, b) stacks in
    column-major tile-index order; ``tmat[kk]`` holds the GEQRF T factor
    and ``tmat[ik]`` the TSQRF one (disjoint indices, one buffer).

    On CUDA tensors: one ``qr_walk`` launch per phase, in order, on the
    current stream (``desc`` must be the device copy, int32 contiguous).
    On CPU tensors: ``qr_walk_plain``."""
    del statics
    tiles, tmat = buffers
    _check_table(desc, phase_bounds, tiles.shape[0])
    if tiles.device.type == "cpu":
        kernel.count(kernel.PLAIN_CALLS, "qr_walk")
        qr_walk_plain(desc, phase_bounds, tiles, tmat)
        return tiles, tmat
    check_tiles(tiles, tmat)
    if (desc.device != tiles.device or desc.dtype != torch.int32
            or not desc.is_contiguous() or desc.shape[1] < 4):
        raise ValueError("desc must be a contiguous int32 (items, 4) table "
                         "on the tiles' device")
    for p0, p1 in zip(phase_bounds, phase_bounds[1:]):
        if p1 > p0:
            kernel.qr_walk(desc, int(p0), int(p1), tiles, tmat)
    return tiles, tmat
