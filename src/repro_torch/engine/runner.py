"""Device-resident plan execution: the port of ``repro/engine/runner.py``'s
``execute_plan``.

The reference ran a whole plan as one jitted XLA program (one host
dispatch, donated buffers, a jit cache per launch layout).  Eager PyTorch
has none of that machinery to carry over: ``execute_plan`` uploads
``desc`` to the device once per plan and calls the family walk once over
the whole plan, which launches its kernel on the current stream and
updates the state buffers in place.
The schedule is one of two:

* the write-colored phases (``Phases``: the host row offsets, and on a
  card the table they were uploaded with, ``upload_phases``).  The tiled
  QR walks them in ONE cooperative launch a plan: its blocks stride over
  each phase's rows and meet at a grid-wide barrier between phases, so
  the walk's time is the sum of each phase's slowest tile op and a
  barrier, and no phase waits on the host.  The pipeline walk does the
  same over its phases' tiles;
* launch groups (Barnes-Hut, ``descriptors.launch_groups``): ``desc`` is
  uploaded in the groups' walk order and the walk launches once per
  group, at most once per round.

The QR walk checks the table's range on the host copy its ``Phases``
carries, so it makes no device sync.  The walk kernel's own counter
(``kernels.*.kernel.LAUNCHES``) counts the launches where they happen.

``measure_round_times`` runs a table one round at a time (and, with
``per_item``, one item at a time), timing each launch: the measured
times ``core.simulator.replay_round_times`` / ``replay_item_times`` feed
back into the discrete-event model.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (Callable, Iterable, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from .descriptors import (LaunchGroups, RowKeys, TaskTable, launch_groups,
                          table_from_arrays)

# walk launches a plan for the QR and pipeline families: one cooperative
# launch over every phase (the reference's one jitted dispatch a plan)
ENGINE_DISPATCHES_PER_PLAN = 1


class Phases(tuple):
    """The absolute row offsets of a table's phases (a tuple of host
    ints).  ``upload_phases`` records the table they were uploaded with:
    ``host_desc``, its host copy, and ``device_desc`` / ``device_offsets``,
    the int32 table and offsets on the card (views of the one uploaded
    buffer).  All three are None for phases made any other way."""

    host_desc: Optional[np.ndarray] = None
    device_desc: Optional[torch.Tensor] = None
    device_offsets: Optional[torch.Tensor] = None


def upload_phases(desc: np.ndarray, offsets: Iterable[int],
                  device) -> Tuple[torch.Tensor, Phases]:
    """``desc`` and the phase offsets in one host-to-device copy: the
    (items, width) int32 device table and the ``Phases`` that records it
    beside its host copy and the offsets' device copy."""
    desc = np.ascontiguousarray(desc, dtype=np.int32)
    phases = Phases(int(b) for b in offsets)
    packed = torch.from_numpy(np.concatenate(
        [desc.ravel(), np.asarray(phases, dtype=np.int32)])).to(device)
    phases.host_desc = desc
    phases.device_desc = packed[:desc.size].view(desc.shape)
    phases.device_offsets = packed[desc.size:]
    return phases.device_desc, phases


# (desc, schedule, statics, buffers) -> buffers; the schedule is the
# phases to walk, or the launch groups of a table whose desc was uploaded
# in their walk order
RoundFn = Callable[[torch.Tensor, Union[Phases, LaunchGroups],
                    Tuple, Tuple], Tuple]


def execute_plan(tables: TaskTable, round_fn: RoundFn,
                 statics: Sequence, buffers: Sequence,
                 groups: Optional[LaunchGroups] = None) -> Tuple:
    """Execute a lowered task table, phase by phase or, when ``groups`` is
    given, launch group by launch group.  ``statics`` are read-only family
    inputs (may be empty); ``buffers`` are the mutable state tensors,
    updated in place and returned.  The device is the buffers' device."""
    statics = tuple(statics)
    buffers = tuple(buffers)
    if tables.nr_items == 0:
        return buffers
    device = buffers[0].device
    if groups is None:
        host = tables.desc
        schedule = Phases(int(b) for b in tables.phase_offsets)
    else:
        host = tables.desc[groups.order]
        schedule = groups
    if device.type == "cpu":
        desc = torch.as_tensor(host)
    elif groups is None:
        desc, schedule = upload_phases(host, schedule, device)
    else:
        desc = torch.as_tensor(host).to(device, non_blocking=False)
    reg = _metrics.get_registry()
    reg.counter("engine.plans_executed").inc()
    reg.counter("engine.items_walked").inc(tables.nr_items)
    tr = _trace.get_tracer()
    if not tr.enabled:
        return round_fn(desc, schedule, statics, buffers)
    # execute span: tracing synchronizes the device so the span covers
    # execution, not just the enqueue — an observer cost paid only when a
    # tracer is installed
    t0 = _trace.now()
    out = round_fn(desc, schedule, statics, buffers)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tr.event_span("engine.execute", t0, _trace.now(), lane="engine",
                  items=tables.nr_items, rounds=tables.nr_rounds,
                  phases=tables.nr_phases,
                  groups=None if groups is None else groups.nr_groups)
    return out


# ---------------------------------------------------------------------------
# measured round and item times
# ---------------------------------------------------------------------------

@dataclass
class RoundTimings:
    """Measured engine times (``measure_round_times``): ``round_s[r]`` is
    round ``r``'s wall time (one walk launch over that round's rows, 0.0
    for an empty round); ``item_s[q]``, only with ``per_item=True``, is
    flat work item ``q``'s wall time (one single-row launch each, mapped
    to tasks through ``TaskTable.tids``: the input of
    ``core.simulator.replay_item_times``).  ``buffers`` is the final state
    of the rounds pass, bitwise what ``execute_plan`` gives from the same
    state."""
    round_s: List[float]
    item_s: Optional[np.ndarray]
    buffers: Tuple


def _sub_table(tables: TaskTable, o0: int, o1: int,
               bounds: Sequence[int]) -> TaskTable:
    """Rows ``o0:o1`` of ``tables`` as a one-round table whose phases are
    ``bounds`` (absolute offsets, from ``o0`` to ``o1``)."""
    return table_from_arrays(
        desc=tables.desc[o0:o1], tids=tables.tids[o0:o1],
        round_offsets=[0, o1 - o0],
        phase_offsets=[int(b) - o0 for b in bounds],
        round_phase_ptr=[0, len(bounds) - 1], arg_width=tables.arg_width,
        nr_tasks=tables.nr_tasks)


def _launch(sub: TaskTable, device: torch.device,
            row_keys: Optional[RowKeys]):
    """``(desc, schedule)`` of a one-round table, on ``device``: its
    phases through ``upload_phases`` (one copy), or, for a family walked
    in launch groups, its rows in the groups' walk order."""
    if row_keys is not None:
        groups = launch_groups(sub, row_keys)
        return (torch.as_tensor(sub.desc[groups.order]).to(device),
                groups)
    phases = [int(b) for b in sub.phase_offsets]
    if device.type == "cpu":
        return torch.as_tensor(sub.desc), Phases(phases)
    return upload_phases(sub.desc, phases, device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_round_times(tables: TaskTable, round_fn: RoundFn,
                        statics: Sequence, buffers: Sequence, *,
                        per_item: bool = False,
                        row_keys: Optional[RowKeys] = None) -> RoundTimings:
    """Execute a task table one round at a time, timing each launch
    (blocked on completion: ``torch.cuda.synchronize`` on the card): the
    measured per-round engine times that
    ``core.simulator.replay_round_times`` feeds back into the
    discrete-event model, to hold its makespan prediction against the
    fused one-launch ``execute_plan`` time.  With ``per_item=True`` a
    further pass runs the table one *item* at a time, giving each task
    its own measured cost (``core.simulator.replay_item_times``).  Every
    round's launch runs once before the timed pass (and one item launch
    before the item pass), so the timings are steady state.

    Each round's rows, and each item's row, are uploaded before the timed
    pass with their own phase offsets (``upload_phases``), so a launch
    times the walk, not the copy.  A family walked in launch groups
    (Barnes-Hut) passes its ``row_keys``: each round, and each item, is
    then cut into launch groups (``descriptors.launch_groups``) and walked
    as ``execute_plan`` walks a group.

    The walks update state in place, so every pass (warm-up, rounds,
    items) starts from its own ``clone()`` of ``buffers``: the caller's
    buffers are left as they were.  ``RoundTimings.buffers`` is the rounds
    pass's final state.

    Caveat on per-item granularity: each single-item launch pays the whole
    launch overhead, so where that rivals one item's arithmetic (the plain
    walk on the CPU in particular) ``item_s`` is an upper bound skewed
    toward launch cost, and the replay checks the model's mechanics
    (additivity, lane bounds) rather than hardware task costs."""
    statics = tuple(statics)
    init = tuple(buffers)
    device = init[0].device
    tr = _trace.get_tracer()

    def fresh() -> Tuple:
        return tuple(b.clone() for b in init)

    launches = []
    for r in range(tables.nr_rounds):
        o0 = int(tables.round_offsets[r])
        o1 = int(tables.round_offsets[r + 1])
        launches.append(None if o1 == o0 else _launch(
            _sub_table(tables, o0, o1, tables.round_phases(r)), device,
            row_keys))

    bufs = fresh()                          # warm-up, every round's launch
    for launch in launches:
        if launch is not None:
            bufs = round_fn(launch[0], launch[1], statics, bufs)
    _sync(device)

    round_s: List[float] = []
    bufs = fresh()
    for r, launch in enumerate(launches):
        if launch is None:
            round_s.append(0.0)
            continue
        t0 = time.perf_counter()
        bufs = round_fn(launch[0], launch[1], statics, bufs)
        _sync(device)
        t1 = time.perf_counter()
        round_s.append(t1 - t0)
        if tr.enabled:
            tr.event_span("engine.round", t0, t1, lane="engine rounds",
                          round=r,
                          items=int(tables.round_offsets[r + 1]
                                    - tables.round_offsets[r]))
    out = bufs

    item_s = None
    if per_item:
        items = [_launch(_sub_table(tables, q, q + 1, (q, q + 1)), device,
                         row_keys) for q in range(tables.nr_items)]
        if items:                           # warm-up, one item launch
            round_fn(items[0][0], items[0][1], statics, fresh())
            _sync(device)
        bufs = fresh()
        item_s = np.zeros(tables.nr_items, np.float64)
        etypes = tables.desc[:, 0]
        for q, (desc, schedule) in enumerate(items):
            t0 = time.perf_counter()
            bufs = round_fn(desc, schedule, statics, bufs)
            _sync(device)
            t1 = time.perf_counter()
            item_s[q] = t1 - t0
            if tr.enabled:
                # the paper's per-task tic/toc, keyed back to tasks
                # through TaskTable.tids: one timeline row, since the
                # pass is sequential by construction
                tr.task(int(tables.tids[q]), int(etypes[q]), 0, t0, t1)
    return RoundTimings(round_s=round_s, item_s=item_s, buffers=out)
