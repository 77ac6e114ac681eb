"""Task-table lowering: an ExecutionPlan as ragged device-resident arrays.

``lower_tables`` turns a lowered :class:`~repro_torch.core.plan.ExecutionPlan`
into a :class:`TaskTable` — a flat CSR descriptor array over rounds and
write-colored sub-phases — by asking the same ``BatchSpec`` registry that
drives the host round executor for each task's *device* encoding
(``BatchSpec.encode``).  QR, Barnes-Hut and the pipeline F/B/U synthesizer
all lower through this one path; what differs per family is only the
encoder, the row-access map that drives the write coloring, and the
megakernel that interprets the rows (``repro_torch.engine.megakernel``).  The
``engine`` entry of the execution backend registry (``core/backends.py``,
DESIGN.md §Backends) drives this lowering for any family whose registry
carries encoders plus ``EngineHooks``.  Layout and invariants: DESIGN.md
§Engine ("Ragged tables & grid walk").

A descriptor row is ``[engine_type, arg0, ..., arg{A-1}]`` (int32).  One
*task* may encode to several rows (Barnes-Hut tasks expand into their
direct-interaction work items); rows inherit the task's round, so every
round's row slice stays conflict-free — rows of one round belong to tasks
whose locked resource subtrees are disjoint (property-tested in
``tests/test_engine_properties.py``).  Rows carry whatever per-item
scalars the family's round function needs beyond identity — the serving
tier's decode rows are ``[ENG_DECODE, slot, pos]`` so the per-slot
page-walk bound rides the descriptor into the paged-attention kernel
(DESIGN.md §Serving) instead of round-tripping through host state.  Row order within a round mirrors
``ExecutionPlan.execute``: typed batches in ascending type order, tasks in
batch order — so the engine's observable sequencing matches the host
rounds mode.  Virtual tasks encode to nothing; empty rounds lower to a
zero-length CSR slice, never a synthetic no-op row.

The table is *ragged*: rounds index the flat row array through
``round_offsets`` and each round is further split into contiguous
sub-phases (``phase_offsets``, ``round_phase_ptr``) by the write-coloring
pass (:func:`repro_torch.core.plan.color_phases` over the family's
``row_access`` map), such that no two items of one phase read or write a
common state row.  Phases are what the megakernel's grid dimension walks —
items of a phase may execute in any order or in parallel, phases run in
order.  There are NO padding rows anywhere (``stats["pad_fraction"]`` is
identically 0; CI asserts it).

Port note: a copy of ``repro.engine.descriptors`` (the tables stay numpy
on the host; ``repro_torch.engine.runner`` uploads ``desc`` to the device
once per plan), plus ``table_from_arrays``, which rebuilds a table from
another table's arrays so the port's walk can run exactly the schedule
the reference lowered, and ``launch_groups``, which cuts a table into the
launches of a walk whose blocks each own one write key (Barnes-Hut).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import FLAG_VIRTUAL, QSched
from repro_torch.core.plan import BatchSpec, ExecutionPlan, color_phases
from repro_torch.obs import trace as _trace

# row -> (reads, writes): hashable state-row keys a descriptor row loads
# from / stores to, in a family-defined keyspace.  Drives the write
# coloring; the per-family maps live next to the row layouts in
# ``repro_torch.engine.megakernel``.
RowAccess = Callable[[Tuple[int, ...]], Tuple[Sequence, Sequence]]
# desc -> (write (items,), reads (items, k)): the same map for a whole
# table as non-negative integer keys, one write key per row (-1: none),
# reads padded with -1.  Drives ``launch_groups``.
RowKeys = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


@dataclass(frozen=True)
class TaskTable:
    """Ragged, device-ready descriptor tables for one lowered plan.

    ``desc[q]`` is flat row ``q``: ``[etype, args...]`` (unused trailing
    arg columns are zero); ``tids[q]`` is the owning task id — host-side
    provenance for tests, stats and per-item cost replay, never shipped to
    the kernel.  ``round_offsets`` (CSR over rounds) and ``phase_offsets``
    (CSR over write-colored sub-phases, plan-wide) both index ``desc``;
    ``round_phase_ptr[r]:round_phase_ptr[r+1]`` are round ``r``'s phase
    ids, so its phase boundaries are
    ``phase_offsets[round_phase_ptr[r] : round_phase_ptr[r+1] + 1]``.
    """
    desc: np.ndarray             # (nr_items, 1 + arg_width) int32
    tids: np.ndarray             # (nr_items,) int32
    round_offsets: np.ndarray    # (R + 1,) int64, CSR over rounds
    phase_offsets: np.ndarray    # (P + 1,) int64, CSR over sub-phases
    round_phase_ptr: np.ndarray  # (R + 1,) int64, round -> phase id range
    arg_width: int
    nr_tasks: int
    structural_hash: str
    stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def nr_rounds(self) -> int:
        return self.round_offsets.shape[0] - 1

    @property
    def nr_phases(self) -> int:
        return self.phase_offsets.shape[0] - 1

    @property
    def nr_items(self) -> int:
        return int(self.round_offsets[-1])

    @property
    def round_lengths(self) -> np.ndarray:
        return np.diff(self.round_offsets)

    def round_rows(self, r: int) -> np.ndarray:
        o0, o1 = int(self.round_offsets[r]), int(self.round_offsets[r + 1])
        return self.desc[o0:o1]

    def round_tids(self, r: int) -> List[int]:
        o0, o1 = int(self.round_offsets[r]), int(self.round_offsets[r + 1])
        return self.tids[o0:o1].tolist()

    def round_phases(self, r: int) -> np.ndarray:
        """Round ``r``'s phase boundaries as offsets into the flat row
        array (``[round_offsets[r], ..., round_offsets[r+1]]``; length 1
        for an empty round)."""
        p0, p1 = int(self.round_phase_ptr[r]), int(self.round_phase_ptr[r + 1])
        if p0 == p1:
            return self.round_offsets[r:r + 1].copy()
        return self.phase_offsets[p0:p1 + 1]


def lower_tables(plan: ExecutionPlan, sched: QSched,
                 registry: Mapping[int, BatchSpec], *,
                 arg_width: int,
                 row_access: Optional[RowAccess] = None) -> TaskTable:
    """Lower a plan's rounds into a ragged :class:`TaskTable` via the
    registry's ``encode`` hooks, write-coloring each round's rows into
    sub-phases with ``row_access`` (no ``row_access``: one phase per
    non-empty round — only valid when the caller guarantees a round's rows
    never touch a common state row, or the walk stays sequential).  Raises
    ``KeyError`` when a non-virtual task type has no spec or no encoder,
    mirroring ``ExecutionPlan.execute``."""
    plan.check_compatible(sched)
    flags = sched._tflags
    datas = sched._tdata
    all_rows: List[Tuple[int, ...]] = []
    all_tids: List[int] = []
    round_offsets = np.zeros(plan.nr_rounds + 1, dtype=np.int64)
    phase_offsets: List[int] = [0]
    round_phase_ptr = np.zeros(plan.nr_rounds + 1, dtype=np.int64)
    tables_span = _trace.span("engine.lower_tables", tasks=plan.nr_tasks,
                              rounds=plan.nr_rounds)
    with tables_span:
        for r, rnd in enumerate(plan.rounds):
            rows: List[Tuple[int, ...]] = []
            rtids: List[int] = []
            with _trace.span("engine.encode", round=r):
                for tb in rnd.batches:
                    real = [t for t in tb.tids
                            if not flags[t] & FLAG_VIRTUAL]
                    if not real:
                        continue
                    spec = registry.get(tb.ttype)
                    if spec is None:
                        raise KeyError(
                            f"no BatchSpec registered for task type "
                            f"{tb.ttype}")
                    if spec.encode is None:
                        raise KeyError(
                            f"BatchSpec for task type {tb.ttype} has no "
                            f"engine encoder (BatchSpec.encode)")
                    for tid in real:
                        for row in spec.encode(tid, datas[tid]):
                            row = tuple(int(v) for v in row)
                            if len(row) > 1 + arg_width:
                                raise ValueError(
                                    f"encoder for type {tb.ttype} emitted "
                                    f"{len(row)} columns, table holds "
                                    f"{1 + arg_width}")
                            rows.append(row)
                            rtids.append(tid)
            base = len(all_rows)
            if rows:
                if row_access is None:
                    bounds = [0, len(rows)]
                else:
                    bounds = color_phases([row_access(row) for row in rows])
                phase_offsets.extend(base + b for b in bounds[1:])
            # empty rounds contribute zero phases + a zero-length CSR slice
            all_rows.extend(rows)
            all_tids.extend(rtids)
            round_offsets[r + 1] = len(all_rows)
            round_phase_ptr[r + 1] = len(phase_offsets) - 1
        tables_span.args["items"] = len(all_rows)
        tables_span.args["phases"] = len(phase_offsets) - 1

    nr_items = len(all_rows)
    desc = np.zeros((nr_items, 1 + arg_width), dtype=np.int32)
    for q, row in enumerate(all_rows):
        desc[q, :len(row)] = row
    tids = np.asarray(all_tids, dtype=np.int32)
    phase_off = np.asarray(phase_offsets, dtype=np.int64)
    lengths = np.diff(round_offsets)
    width = int(lengths.max()) if lengths.size else 0
    nr_phases = phase_off.shape[0] - 1
    phase_lengths = np.diff(phase_off)
    # measured, not asserted-by-construction: rows allocated in the flat
    # array beyond what the round CSR references are pad/filler work (CI
    # gates pad_fraction == 0, so a layout change that reintroduces
    # filler rows fails the gate instead of silently inflating the walk)
    pad_rows = desc.shape[0] - int(round_offsets[-1])
    return TaskTable(
        desc=desc, tids=tids, round_offsets=round_offsets,
        phase_offsets=phase_off, round_phase_ptr=round_phase_ptr,
        arg_width=arg_width, nr_tasks=plan.nr_tasks,
        structural_hash=plan.structural_hash,
        stats={"rounds": plan.nr_rounds, "phases": nr_phases,
               "items": nr_items, "width": width,
               "max_phase_len": int(phase_lengths.max())
               if phase_lengths.size else 0,
               # the dense layout this table replaces padded every round
               # to the plan-wide max width; the ragged walk does zero
               # pad work — benchmarks report the ratio as walk_reduction
               "padded_rows": plan.nr_rounds * width,
               "pad_rows": pad_rows,
               "pad_fraction": pad_rows / max(desc.shape[0], 1)})


def count_host_dispatches(plan: ExecutionPlan, sched: QSched,
                          registry: Mapping[int, BatchSpec]) -> int:
    """Host kernel dispatches the per-round BatchSpec path performs for
    this plan: one per batched group, one per ``run_one`` task.  The port's
    engine replaces them with one cooperative walk launch a plan (the QR
    and pipeline families, ``ENGINE_DISPATCHES_PER_PLAN``) or, for a
    family walked in launch groups (Barnes-Hut), one launch per group
    (``LaunchGroups.nr_groups``)."""
    flags = sched._tflags
    n = 0
    for rnd in plan.rounds:
        for tb in rnd.batches:
            real = [t for t in tb.tids if not flags[t] & FLAG_VIRTUAL]
            if not real:
                continue
            spec = registry.get(tb.ttype)
            if (spec is not None and spec.run_batch is not None
                    and len(real) >= spec.min_batch):
                n += 1
            else:
                n += len(real)
    return n


def table_from_arrays(*, desc, tids, round_offsets, phase_offsets,
                      round_phase_ptr, arg_width: int, nr_tasks: int,
                      structural_hash: str = "",
                      stats: Optional[Dict[str, Any]] = None) -> TaskTable:
    """Build a :class:`TaskTable` from another table's arrays (for example
    ``repro.engine.TaskTable``'s fields, passed as numpy arrays), with the
    dtypes this module's ``lower_tables`` produces.  Raises when the CSR
    arrays do not describe one ragged table."""
    desc = np.ascontiguousarray(desc, dtype=np.int32)
    tids = np.ascontiguousarray(tids, dtype=np.int32)
    round_offsets = np.ascontiguousarray(round_offsets, dtype=np.int64)
    phase_offsets = np.ascontiguousarray(phase_offsets, dtype=np.int64)
    round_phase_ptr = np.ascontiguousarray(round_phase_ptr, dtype=np.int64)
    if desc.ndim != 2 or desc.shape[1] != 1 + arg_width:
        raise ValueError(f"desc must be (items, {1 + arg_width}), got "
                         f"{desc.shape}")
    if (tids.shape != (desc.shape[0],)
            or round_offsets[-1] != desc.shape[0]
            or phase_offsets[-1] != desc.shape[0]
            or round_phase_ptr.shape != round_offsets.shape
            or round_phase_ptr[-1] != phase_offsets.shape[0] - 1):
        raise ValueError("inconsistent task-table arrays")
    return TaskTable(desc=desc, tids=tids, round_offsets=round_offsets,
                     phase_offsets=phase_offsets,
                     round_phase_ptr=round_phase_ptr, arg_width=arg_width,
                     nr_tasks=nr_tasks, structural_hash=structural_hash,
                     stats=dict(stats or {}))


@dataclass(frozen=True)
class LaunchGroups:
    """A task table cut for a walk that launches once per group, with one
    worker (a warp, in the Barnes-Hut walk) per bucket.  ``order`` lists the table's rows in walk order:
    group by group, and within a group bucket by bucket, each bucket's
    rows in table order.  ``bucket_offsets`` is the CSR of buckets over
    ``order`` and ``group_offsets`` the CSR of groups over buckets."""
    order: np.ndarray            # (nr_items,) int64
    bucket_offsets: np.ndarray   # (B + 1,) int64
    group_offsets: np.ndarray    # (G + 1,) int64

    @property
    def nr_groups(self) -> int:
        return self.group_offsets.shape[0] - 1

    @property
    def nr_buckets(self) -> int:
        return self.bucket_offsets.shape[0] - 1


def launch_groups(tables: TaskTable, row_keys: RowKeys) -> LaunchGroups:
    """Cut ``tables`` into launch groups for a walk whose blocks each own
    one write key.

    A group is a run of whole consecutive rounds in which no row's write
    key is read or written by a row with another write key (rows that
    share a key only for reading are fine: Barnes-Hut's PC rows of
    different leaves read the same COM rows).  Within a group the rows are
    bucketed by write key, keeping table order.  Walking the groups in
    order, each bucket's rows in order, therefore keeps the reference's
    invariant: rows that write the same state row run in table order, and
    a row never runs before the rows whose writes it reads (or after the
    rows that read what it overwrites).  Rounds are merged greedily, so
    there are at most ``tables.nr_rounds`` groups.

    Raises ``ValueError`` for a table it cannot cut safely: a row without
    exactly one write key, or a round in which a row reads a key that a
    row with another write key writes."""
    with _trace.span("engine.launch_groups", items=tables.nr_items,
                     rounds=tables.nr_rounds) as sp:
        write, reads = row_keys(tables.desc)
        write = np.asarray(write, dtype=np.int64)
        reads = np.asarray(reads, dtype=np.int64).reshape(len(write), -1)
        if (write < 0).any():
            q = int(np.flatnonzero(write < 0)[0])
            raise ValueError(f"row {q} {tables.desc[q].tolist()} has no "
                             f"write key: launch groups need exactly one "
                             f"per row")
        # reads of a key by a row that does not own it (-1: none)
        foreign = np.where(reads == write[:, None], -1, reads)
        nkeys = int(max(write.max(initial=-1), foreign.max(initial=-1))) + 1
        written = np.zeros(nkeys, bool)     # keys written by the group
        read = np.zeros(nkeys, bool)        # keys read by a non-owner
        group_of = np.zeros(len(write), np.int64)
        gid = -1
        ro = tables.round_offsets
        for r in range(tables.nr_rounds):
            o0, o1 = int(ro[r]), int(ro[r + 1])
            if o0 == o1:
                continue
            w = write[o0:o1]
            f = foreign[o0:o1]
            f = f[f >= 0]
            mine = np.zeros(nkeys, bool)
            mine[w] = True
            if mine[f].any():
                raise ValueError(
                    f"round {r} reads keys its other rows write "
                    f"({np.unique(f[mine[f]])[:8].tolist()}): no launch "
                    f"group can hold it")
            if gid < 0 or written[f].any() or read[w].any():
                gid += 1                    # a new group starts here
                written[:] = False
                read[:] = False
            written[w] = True
            read[f] = True
            group_of[o0:o1] = gid
        order = np.lexsort((write, group_of))        # stable: table order
        g, k = group_of[order], write[order]
        new = np.ones(len(order), bool)
        new[1:] = (g[1:] != g[:-1]) | (k[1:] != k[:-1])
        starts = np.flatnonzero(new)
        bucket_offsets = np.append(starts, len(order)).astype(np.int64)
        group_offsets = np.searchsorted(g[starts], np.arange(gid + 2),
                                        side="left").astype(np.int64)
        sp.args["groups"] = gid + 1
        sp.args["buckets"] = len(starts)
    return LaunchGroups(order=order.astype(np.int64),
                        bucket_offsets=bucket_offsets,
                        group_offsets=group_offsets)
