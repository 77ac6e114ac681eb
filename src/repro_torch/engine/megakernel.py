"""The task-table walks of the port's engine: the counterparts of
``repro/engine/megakernel.py``'s three families (``qr_round_fn`` /
``bh_round_fn`` / ``pipe_round_fn`` → ``_grid_walk`` + ``_qr_kernel`` /
``_bh_kernel`` / ``_pipe_kernel``).

A lowered plan is a ragged table of rows ``[etype, args...]`` split into
write-colored phases (``descriptors.lower_tables``).  The Pallas walks
relied on their grid running in order on one TPU core.  CUDA blocks of one
launch run concurrently, so each family states what it keeps in order:

* **QR** walks a whole plan in ONE cooperative launch: every resident
  block strides over the rows of a phase (the rows of a phase touch
  pairwise-disjoint tiles), and a grid-wide barrier separates phases, so
  the walk's time is the sum over its phases of the slowest tile op plus
  a barrier (125 a 2048² plan), bound by the latency of one tile body.
  Each row is run by one block that switches on ``etype`` over the same
  ``__device__`` tile functions the per-op kernels run
  (``kernels/qr_tile/csrc``), whose chains the bodies keep short; tile
  loads bypass L1, which is not coherent across SMs.
* **Barnes-Hut** would need 2,148,304 phases at the paper's 1M particles,
  because a leaf's ~58 consecutive particle-cell rows all add into the
  same accelerations.  It walks launch groups instead
  (``descriptors.launch_groups``): runs of whole rounds in which no row's
  write key is read or written by a row with another write key, each
  bucketed by write key in table order.  One launch per group, one warp
  per bucket, the bucket's rows in table order over each leaf's real
  particles (``kernels/nbody/csrc``): at most one launch per round.
* **Pipeline** (the canonical dense F/B/U family) walks a whole plan in
  ONE cooperative launch too, as QR does: a row writes several keys
  (``act``/``cot``/``loss`` on F, ``gw``/``gb``/``cot`` on B), so launch
  groups, which want one write key a row, do not apply.  A phase holds at
  most S rows, so each row is cut into tiles, and the resident blocks
  take a phase's tiles from a counter, the longest kinds first, with a
  grid-wide barrier between phases (``kernels/pipe_walk/csrc``).

State stacks are updated in place, so the walks have no copy-in and no
copy-out.  On CPU tensors each round function runs its plain walk, which
applies the same rows in table order through the plain functions
(``kernels/*/ref.py``) — QR's with exactly the calls its host backends
make, so its four execution modes stay bitwise equal on the CPU too;
``chip_smoke.py`` holds each kernel walk against its plain walk on the
card.  Each family keeps a no-op type: ``*_NOOP``
and any type out of range is a no-op in both walks (a lowering-bug guard;
tables carry no no-op rows).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.nbody import kernel as nb_kernel
from repro_torch.kernels.nbody import ref as nb_ref
from repro_torch.kernels.pipe_walk import kernel as pw_kernel
from repro_torch.kernels.pipe_walk import ref as pw_ref
from repro_torch.kernels.qr_tile import kernel, ref
from repro_torch.kernels.qr_tile.ops import check_tiles

from .descriptors import LaunchGroups

# QR engine types — intentionally equal to apps.qr.T_* so task types encode
# to themselves; QR_NOOP is the defensive clamp branch (never in a table).
QR_GEQRF, QR_LARFT, QR_TSQRF, QR_SSRFT, QR_NOOP = range(5)
QR_ARG_WIDTH = 3       # rows: [etype, slot0, slot1, slot2] (tile indices)
QR_LAUNCHES_PER_PLAN = 1   # the walk is one cooperative launch a plan

# Barnes-Hut engine (work-item) types; BH_NOOP is the clamp branch.
(BH_COM_LEAF, BH_COM_INNER, BH_SELF, BH_PP, BH_PC, BH_NOOP) = range(6)
BH_MAX_CHILDREN = 8    # octree fan-out; COM_INNER rows carry 8 child cells
# and ragged PC source lists chunk into rows of 8 cells (pad = zero-mass)
BH_ARG_WIDTH = 1 + BH_MAX_CHILDREN   # rows: [etype, write, a0..a7]

# Pipeline F/B/U engine types; PIPE_NOOP is the clamp branch.  Rows:
# [etype, stage, micro, in_slot, out_slot, first, last] where the slots are
# flat (stage, micro) indices into the stacked activation/cotangent slabs.
PIPE_F, PIPE_B, PIPE_U, PIPE_NOOP = range(4)
PIPE_ARG_WIDTH = 6
PIPE_LAUNCHES_PER_PLAN = 1   # the walk is one cooperative launch a plan


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


def check_qr_table(desc, phase_bounds: Sequence[int], ntiles: int) -> None:
    """Refuse a table the walk would run out of bounds on: phase bounds
    must be ascending row offsets into ``desc`` and every slot a tile
    index.  ``desc`` is a host copy (array or CPU tensor): no device is
    touched."""
    desc = np.asarray(desc)
    if desc.ndim != 2 or desc.shape[1] < 4:
        raise ValueError(f"a QR table is (items, >= 4), not {desc.shape}")
    bounds = [int(b) for b in phase_bounds]
    if (not bounds or bounds != sorted(bounds) or bounds[0] < 0
            or bounds[-1] > len(desc)):
        raise ValueError(f"phase bounds {bounds[:1]}..{bounds[-1:]} do not "
                         f"index the {len(desc)} rows of the table")
    slots = desc[:, 1:4]
    if slots.size:
        lo, hi = int(slots.min()), int(slots.max())
        if lo < 0 or hi >= ntiles:
            raise ValueError(f"table slots {lo}..{hi} outside the "
                             f"{ntiles}-tile stack")


def qr_round_fn(desc: torch.Tensor, phase_bounds: Sequence[int], statics,
                buffers: Tuple[torch.Tensor, torch.Tensor]):
    """Walk executor for the QR family:
    ``(desc, phase_bounds, (), (tiles, tmat)) -> (tiles, tmat)``, updated
    in place.  ``phase_bounds`` are absolute row offsets into ``desc``
    (host integers; on a card, the ``runner.Phases`` that records the
    uploaded table); ``tiles``/``tmat`` are (ntiles, b, b)
    stacks in column-major tile-index order; ``tmat[kk]`` holds the GEQRF
    T factor and ``tmat[ik]`` the TSQRF one (disjoint indices, one
    buffer).

    On CUDA tensors: one ``qr_walk`` launch for all the phases, on the
    current stream.  ``desc`` and ``phase_bounds`` must come from one
    ``runner.upload_phases`` call; the table's range is checked on the
    host copy the phases record, so the call makes no device sync.  On
    CPU tensors: ``qr_walk_plain``."""
    del statics
    tiles, tmat = buffers
    if tiles.device.type == "cpu":
        check_qr_table(desc, phase_bounds, tiles.shape[0])
        kernel.count(kernel.PLAIN_CALLS, "qr_walk")
        qr_walk_plain(desc, phase_bounds, tiles, tmat)
        return tiles, tmat
    check_tiles(tiles, tmat)
    if (getattr(phase_bounds, "device_desc", None) is not desc
            or desc.device != tiles.device):
        raise ValueError("on a card desc and its phases come from one "
                         "runner.upload_phases call, on the tiles' device")
    check_qr_table(phase_bounds.host_desc, phase_bounds, tiles.shape[0])
    bounds = [int(b) for b in phase_bounds]
    max_rows = max((b1 - b0 for b0, b1 in zip(bounds, bounds[1:])),
                   default=0)
    if max_rows > 0:
        kernel.qr_walk(desc, phase_bounds.device_offsets, max_rows, tiles,
                       tmat)
    return tiles, tmat


# ---------------------------------------------------------------------------
# Barnes-Hut family
# ---------------------------------------------------------------------------

def bh_row_access(row: Sequence[int]) -> Tuple[Tuple, Tuple]:
    """Barnes-Hut keyspace: ``("a", leaf_slot)`` acceleration blocks,
    ``("c", cell)`` COM/mass rows.  Particle positions/masses are
    read-only statics and carry no keys."""
    et = row[0]
    if et == BH_COM_LEAF:
        return (), (("c", row[1]),)
    if et == BH_COM_INNER:
        return (tuple(("c", int(c)) for c in row[2:2 + BH_MAX_CHILDREN]),
                (("c", row[1]),))
    if et in (BH_SELF, BH_PP):
        return (), (("a", row[1]),)
    if et == BH_PC:
        return (tuple(("c", int(c)) for c in row[2:2 + BH_MAX_CHILDREN]),
                (("a", row[1]),))
    return (), ()


def bh_row_keys(desc) -> Tuple[np.ndarray, np.ndarray]:
    """``bh_row_access`` for a whole table at once, as integers for
    ``descriptors.launch_groups``: ``("a", s)`` is ``2 s`` and ``("c", c)``
    is ``2 c + 1``.  Returns each row's write key (-1 for a no-op row) and
    its read keys, (items, 8) padded with -1."""
    desc = np.asarray(desc)
    et, w = desc[:, 0], desc[:, 1].astype(np.int64)
    write = np.where(et <= BH_COM_INNER, 2 * w + 1, 2 * w)
    write[(et < BH_COM_LEAF) | (et > BH_PC)] = -1
    gathers = (et == BH_COM_INNER) | (et == BH_PC)
    cells = desc[:, 2:2 + BH_MAX_CHILDREN].astype(np.int64)
    return write, np.where(gathers[:, None], 2 * cells + 1, -1)


def _bh_plain_row(row: Sequence[int], xs, ms, acc, com, cmass,
                  eps: float) -> None:
    et, w = row[0], row[1]
    cells = list(row[2:2 + BH_MAX_CHILDREN])
    if et == BH_COM_LEAF:      # [cell, leaf]: mass-weighted mean of a block
        x, m = xs[row[2]], ms[row[2]]
        tot = m.sum()
        com[w] = (x @ m) / tot.clamp_min(1e-30)
        cmass[w] = tot
    elif et == BH_COM_INNER:   # [cell, c0..c7]: combine children's COMs
        m = cmass[cells, 0]
        tot = m.sum()
        com[w] = (com[cells].T @ m) / tot.clamp_min(1e-30)
        cmass[w] = tot
    elif et == BH_SELF:        # [leaf]: all pairs within one block
        acc[w] += nb_ref.acc_self_ref(xs[w], ms[w], eps)
    elif et == BH_PP:          # [leaf_i, leaf_j]: one direction of a pair
        acc[w] += nb_ref.acc_pair_ref(xs[w], xs[row[2]], ms[row[2]], eps)
    elif et == BH_PC:          # [leaf, s0..s7]: ≤ 8 COM sources
        acc[w] += nb_ref.acc_pair_ref(xs[w], com[cells].T, cmass[cells, 0],
                                      eps)
    # BH_NOOP and anything out of range: no-op


def bh_walk_plain(desc, xs, ms, acc, com, cmass, eps: float) -> None:
    """The plain walk: apply every row of ``desc``, in its order, through
    the plain functions (``kernels/nbody/ref.py``, the COM reductions as
    torch expressions), updating ``acc``/``com``/``cmass`` in place.
    Works on any device; the round function takes it only for CPU
    tensors."""
    for row in torch.as_tensor(desc).cpu().tolist():
        _bh_plain_row(row, xs, ms, acc, com, cmass, eps)


def _check_bh_table(desc, groups: LaunchGroups, nleaves: int,
                    ncells: int) -> None:
    """Refuse a table the walk would run out of bounds on: the groups must
    cut all rows of ``desc`` into buckets, and every leaf slot and cell id
    must index the state (one device sync for a CUDA ``desc``)."""
    bo, go = groups.bucket_offsets, groups.group_offsets
    if (bo[0] != 0 or bo[-1] != len(desc) or (np.diff(bo) < 0).any()
            or go[0] != 0 or go[-1] != len(bo) - 1
            or (np.diff(go) < 0).any()):
        raise ValueError("launch groups do not cut the table's rows into "
                         "buckets")
    d = torch.as_tensor(desc).long()
    if not len(d):
        return
    et, w, a0 = d[:, 0], d[:, 1], d[:, 2]
    to_acc = (et >= BH_SELF) & (et <= BH_PC)
    to_com = (et == BH_COM_LEAF) | (et == BH_COM_INNER)
    leaf_arg = (et == BH_PP) | (et == BH_COM_LEAF)
    gathers = (et == BH_COM_INNER) | (et == BH_PC)
    cells = d[:, 2:2 + BH_MAX_CHILDREN]
    bad = ((to_acc & ((w < 0) | (w >= nleaves)))
           | (to_com & ((w < 0) | (w >= ncells)))
           | (leaf_arg & ((a0 < 0) | (a0 >= nleaves)))
           | (gathers & ((cells < 0) | (cells > ncells)).any(1)))
    if bool(bad.any()):
        q = int(bad.nonzero()[0, 0])
        raise ValueError(f"table row {q} {d[q].tolist()} indexes outside "
                         f"{nleaves} leaves / {ncells} cells")


def _check_bh_state(desc, xs, ms, counts, acc, com, cmass) -> None:
    """Validate the walk's operands for a launch (one device sync for the
    counts' range)."""
    L, _, P = xs.shape
    shapes = {"xs": (xs, (L, 3, P)), "ms": (ms, (L, P)),
              "acc": (acc, (L, 3, P)), "com": (com, (com.shape[0], 3)),
              "cmass": (cmass, (com.shape[0], 1))}
    for name, (t, shape) in shapes.items():
        if (t.device != xs.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {xs.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 1 <= P <= nb_kernel.MAX_P:
        raise ValueError(f"leaf blocks of {P} particles not supported: the "
                         f"walk takes at most {nb_kernel.MAX_P}")
    if (counts.device != xs.device or counts.dtype != torch.int32
            or tuple(counts.shape) != (L,) or not counts.is_contiguous()
            or bool(((counts < 0) | (counts > P)).any())):
        raise ValueError(f"counts must be a contiguous int32 ({L},) tensor "
                         f"of leaf sizes in [0, {P}] on {xs.device}")
    if (desc.device != xs.device or desc.dtype != torch.int32
            or not desc.is_contiguous()
            or desc.shape[1] < 1 + BH_ARG_WIDTH):
        raise ValueError(f"desc must be a contiguous int32 (items, "
                         f"{1 + BH_ARG_WIDTH}) table on the state's device")


def bucket_order(groups: LaunchGroups) -> np.ndarray:
    """The order the walk on the card takes each launch group's buckets
    in: longest first (a warp walks a bucket, and a block holds its place
    on the card until its slowest warp is done), ties in bucket order.
    Buckets of a group are independent, so the order changes no result."""
    lengths = np.diff(groups.bucket_offsets)
    group = np.repeat(np.arange(len(groups.group_offsets) - 1),
                      np.diff(groups.group_offsets))
    top = int(lengths.max(initial=0))
    key = group * (top + 1) + (top - lengths)   # group, then longest first
    if key.max(initial=0) < 2 ** 16:
        key = key.astype(np.uint16)             # a stable radix sort
    return np.argsort(key, kind="stable")


def bh_round_fn(eps: float):
    """Walk executor for the Barnes-Hut family:
    ``(desc, groups, (xs, ms, counts), (acc, com, cmass)) -> (acc, com,
    cmass)``, updated in place.  ``desc`` holds the table's rows in the
    walk order ``groups.order`` (``descriptors.launch_groups``); ``xs``/
    ``ms`` are (L, 3, P)/(L, P) zero-mass-padded leaf blocks and
    ``counts`` (L,) int32 their real sizes (read only), ``acc`` is (L, 3,
    P), and ``com``/``cmass`` are (ncells + 1, 3)/(ncells + 1, 1) with the
    extra zero row as the pad target of COM_INNER and PC rows.

    On CUDA tensors: one ``bh_walk`` launch per launch group, in order, on
    the current stream, one warp per bucket, longest first
    (``bucket_order``; ``desc`` must be the device copy, int32
    contiguous); it walks only the real particles, so the pad particles'
    accelerations stay as they were.  On CPU tensors:
    ``bh_walk_plain`` over the rows in that order, which per-destination
    table order makes bitwise equal to the table order."""
    eps = float(eps)

    def round_fn(desc, groups: LaunchGroups, statics, buffers):
        xs, ms, counts = statics
        acc, com, cmass = buffers
        _check_bh_table(desc, groups, xs.shape[0], com.shape[0] - 1)
        if acc.device.type == "cpu":
            nb_kernel.count(nb_kernel.PLAIN_CALLS, "bh_walk")
            bh_walk_plain(desc, xs, ms, acc, com, cmass, eps)
            return acc, com, cmass
        _check_bh_state(desc, xs, ms, counts, acc, com, cmass)
        bo = groups.bucket_offsets
        both = torch.as_tensor(np.concatenate(
            [bo, bucket_order(groups)]).astype(np.int32), device=acc.device)
        ptr, order = both[:len(bo)], both[len(bo):]
        go = groups.group_offsets
        for b0, b1 in zip(go.tolist(), go[1:].tolist()):
            if b1 > b0:
                nb_kernel.bh_walk(desc, ptr, order, b0, b1, xs, ms, counts,
                                  acc, com, cmass, eps * eps)
        return acc, com, cmass

    return round_fn


# ---------------------------------------------------------------------------
# pipeline F/B/U family (the canonical uniform dense stage, see
# repro_torch.pipeline.exec: stage = tanh(x @ w + b), loss = mean squared
# error)
# ---------------------------------------------------------------------------

def pipe_row_access(row: Sequence[int]) -> Tuple[Tuple, Tuple]:
    """Pipeline keyspace: ``("act"|"cot", slot)`` activation/cotangent
    slabs, ``("gw"|"gb", stage)`` grad buffers, ``("loss", micro)`` loss
    rows.  Stage parameters and microbatch inputs are statics."""
    et, s, m, a_in, a_out = row[0], row[1], row[2], row[3], row[4]
    if et == PIPE_F:
        return ((("act", a_in), ("cot", a_out), ("loss", m)),
                (("act", a_out), ("cot", a_out), ("loss", m)))
    if et == PIPE_B:
        return ((("act", a_in), ("act", a_out), ("cot", a_out),
                 ("gw", s), ("gb", s), ("cot", a_in)),
                (("gw", s), ("gb", s), ("cot", a_in)))
    if et == PIPE_U:
        return ((("gw", s), ("gb", s)), (("gw", s), ("gb", s)))
    return (), ()


def _pipe_plain_row(row: Sequence[int], statics, buffers, inv_m: float,
                    inv_numel: float) -> None:
    et, s, m, a_in, a_out, first, last = (int(v) for v in row[:7])
    w, b, x, y = statics
    acts, cots, gw, gb, loss = buffers
    inp = x[m] if first else acts[a_in]    # a_in == a_out on stage 0
    if et == PIPE_F:      # acts[s,m] = tanh(in @ w_s + b_s); last: loss+seed
        h = pw_ref.fwd_ref(inp, w[s], b[s])
        acts[a_out] = h
        if last:
            loss[m, 0], cots[a_out] = pw_ref.loss_seed_ref(h, y[m],
                                                           inv_numel)
    elif et == PIPE_B:    # grads[s] += vjp; cotangent flows to stage s-1
        dgw, dgb, cot_in = pw_ref.bwd_ref(inp, acts[a_out], cots[a_out],
                                          w[s], bool(first))
        gw[s] += dgw
        gb[s] += dgb
        if cot_in is not None:
            cots[a_in] = cot_in
    elif et == PIPE_U:    # microbatch averaging; the optimizer is the caller's
        gw[s], gb[s] = pw_ref.upd_ref(gw[s], gb[s], inv_m)
    # PIPE_NOOP and anything out of range: no-op


def pipe_walk_plain(desc, phase_bounds: Sequence[int], statics, buffers,
                    inv_m: float) -> None:
    """The plain walk: apply rows ``phase_bounds[0]:phase_bounds[-1]`` of
    ``desc`` phase by phase (each phase's rows in table order) through the
    plain row functions (``kernels/pipe_walk/ref.py``), updating the
    buffers in place.  Works on any device; the round function takes it
    only for CPU tensors."""
    acts = buffers[0]
    inv_numel = 1.0 / (acts.shape[1] * acts.shape[2])
    rows = torch.as_tensor(desc).cpu().tolist()
    for q in range(int(phase_bounds[0]), int(phase_bounds[-1])):
        _pipe_plain_row(rows[q], statics, buffers, inv_m, inv_numel)


def _check_pipe_table(desc: np.ndarray, phase_bounds: Sequence[int],
                      n_stages: int, n_micro: int) -> None:
    """Refuse a table the walk would run out of bounds on: ascending
    phase bounds inside the table, and every F/B/U row's stage, micro and
    slots inside the state."""
    bounds = [int(v) for v in phase_bounds]
    if bounds != sorted(bounds) or bounds[0] < 0 or bounds[-1] > len(desc):
        raise ValueError(f"phase bounds {bounds[0]}..{bounds[-1]} do not "
                         f"index the {len(desc)} rows of the table")
    if desc.ndim != 2 or desc.shape[1] < 1 + PIPE_ARG_WIDTH:
        raise ValueError(f"pipeline rows need {1 + PIPE_ARG_WIDTH} columns, "
                         f"got shape {desc.shape}")
    d = desc[(desc[:, 0] >= PIPE_F) & (desc[:, 0] <= PIPE_U)].astype(np.int64)
    if not len(d):
        return
    lims = (n_stages, n_micro, n_stages * n_micro, n_stages * n_micro)
    for col, lim in enumerate(lims, start=1):
        if d[:, col].min() < 0 or d[:, col].max() >= lim:
            raise ValueError(f"table column {col} outside [0, {lim}): the "
                             f"state has {n_stages} stages, {n_micro} "
                             f"microbatches")


def _check_pipe_state(desc, statics, buffers) -> None:
    """Validate the walk's operands for a launch."""
    w, b, x, y = statics
    acts, cots, gw, gb, loss = buffers
    S, D = b.shape
    M, Bt = x.shape[:2]
    shapes = {"w": (w, (S, D, D)), "b": (b, (S, D)), "x": (x, (M, Bt, D)),
              "y": (y, (M, Bt, D)), "acts": (acts, (S * M, Bt, D)),
              "cots": (cots, (S * M, Bt, D)), "gw": (gw, (S, D, D)),
              "gb": (gb, (S, D)), "loss": (loss, (M, 1))}
    for name, (t, shape) in shapes.items():
        if (t.device != acts.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {acts.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if (desc.device != acts.device or desc.dtype != torch.int32
            or not desc.is_contiguous()):
        raise ValueError("desc must be a contiguous int32 table on the "
                         "state's device")


def pipe_round_fn(inv_m: float):
    """Walk executor for the pipeline family:
    ``(desc, phase_bounds, (w, b, x, y), (acts, cots, gw, gb, loss)) ->
    buffers``, updated in place.  ``w``/``b`` are (S, D, D)/(S, D)
    stage-parameter stacks, ``x``/``y`` (M, Bt, D) microbatch
    inputs/targets (read only); the state is the stacked stage-activation
    (``acts``) and cotangent (``cots``) slabs — flat (S·M, Bt, D), slot =
    stage·M + micro — the grad-accumulation buffers ``gw``/``gb`` and the
    per-micro ``loss`` (M, 1).  ``inv_m`` = 1/M is the U rows' microbatch
    averaging.

    On CUDA tensors: ONE cooperative ``pipe_walk`` launch for all the
    phases, on the current stream (``desc`` must be the device copy, int32
    contiguous).  Its work list is cut on the host from the host copy that
    ``phase_bounds`` records when it comes from ``runner.upload_phases``
    (else from one copy of ``desc``) and uploaded in one copy.  On CPU
    tensors: ``pipe_walk_plain``."""
    inv_m = float(inv_m)

    def round_fn(desc, phase_bounds, statics, buffers):
        w, b, x, y = statics
        acts = buffers[0]
        host = getattr(phase_bounds, "host_desc", None)
        if host is None or getattr(phase_bounds, "device_desc",
                                   None) is not desc:
            host = torch.as_tensor(desc).cpu().numpy()
        _check_pipe_table(host, phase_bounds, w.shape[0], x.shape[0])
        if acts.device.type == "cpu":
            pw_kernel.count(pw_kernel.PLAIN_CALLS, "pipe_walk")
            pipe_walk_plain(desc, phase_bounds, statics, buffers, inv_m)
            return buffers
        _check_pipe_state(desc, statics, buffers)
        M, bt, dim = x.shape
        work = pw_kernel.work_list(host, phase_bounds, bt, dim)
        if work.max_tiles > 0:
            pw_kernel.pipe_walk(
                desc, work, pw_kernel.upload(work, acts.device), statics,
                buffers, pw_kernel.scratch(acts.shape[0], M, work.max_rows,
                                           bt, dim, acts.device),
                inv_m, 1.0 / (bt * dim))
        return buffers

    return round_fn
