"""Discrete-event simulation of the QuickSched execution protocol.

This container has a single CPU core, so the paper's 64-core wall-clock
scaling (Figs 8, 11) cannot be measured directly.  The simulator drives the
*identical* scheduler code path (queues, hierarchical locks, critical-path
priorities, work stealing, re-owning) with virtual time: a worker that
obtains a task occupies it for ``cost / speed`` time units, holding its
resource locks for the duration.  The resulting makespans give the
scheduler-limited strong-scaling curves, directly comparable to the paper's
(minus hardware effects like the Opteron L2 sharing, which the paper itself
excludes from scheduler quality).

``overhead`` models the per-gettask scheduler cost (paper Fig 13 reports it
at < 1 % of total time on 64 cores).

Port note: a copy of ``repro.core.simulator``.  ``repro_torch`` imports
nothing of ``repro`` (not even its jax-free modules), so it keeps its own
copy; the pipeline schedule synthesis (``pipeline.synthesize_schedule``)
runs on it, and ``engine.measure_round_times`` measures the times the
``replay_*`` functions take.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.obs import trace as _trace

from .graph import FLAG_VIRTUAL, QSched


@dataclass
class TimelineEvent:
    tid: int
    worker: int
    t0: float
    t1: float
    type: int = 0


@dataclass
class SimResult:
    makespan: float
    timeline: List[TimelineEvent]
    nr_workers: int
    busy: List[float]
    per_type_cost: Dict[int, float]
    overhead_time: float
    steals: int
    gettask_calls: int

    @property
    def total_cost(self) -> float:
        return sum(e.t1 - e.t0 for e in self.timeline)

    def efficiency(self, serial_time: Optional[float] = None) -> float:
        t1 = serial_time if serial_time is not None else self.total_cost
        return t1 / (self.nr_workers * self.makespan)

    def speedup(self, serial_time: Optional[float] = None) -> float:
        t1 = serial_time if serial_time is not None else self.total_cost
        return t1 / self.makespan


def simulate(sched: QSched, nr_workers: int, overhead: float = 0.0,
             speed: float = 1.0) -> SimResult:
    """Simulate ``sched`` on ``nr_workers`` workers.  ``sched.nr_queues``
    should equal ``nr_workers`` for the paper's one-queue-per-core setup
    (but any combination is allowed)."""
    with _trace.span("sim.simulate", tasks=sched.nr_tasks,
                     workers=nr_workers):
        return _simulate(sched, nr_workers, overhead, speed)


def _simulate(sched: QSched, nr_workers: int, overhead: float,
              speed: float) -> SimResult:
    sched.start(threaded=False)
    timeline: List[TimelineEvent] = []
    busy = [0.0] * nr_workers
    per_type: Dict[int, float] = {}
    overhead_time = 0.0

    # (finish_time, seq, worker, tid) — seq breaks ties deterministically
    running: List = []
    seq = 0
    now = 0.0
    idle = list(range(nr_workers))

    def try_dispatch():
        nonlocal seq, overhead_time
        # keep handing tasks to idle workers until none can get one
        progress = True
        while idle and progress:
            progress = False
            for w in list(idle):
                qid = w % sched.nr_queues
                tid = sched.gettask(qid, block=False)
                overhead_time += overhead
                if tid is not None:
                    t = sched.tasks[tid]
                    dur = t.cost / speed + overhead
                    heapq.heappush(running, (now + dur, seq, w, tid))
                    seq += 1
                    idle.remove(w)
                    timeline.append(
                        TimelineEvent(tid, w, now, now + dur, t.type))
                    busy[w] += dur
                    per_type[t.type] = per_type.get(t.type, 0.0) + dur
                    progress = True

    try_dispatch()
    while running:
        now, _, w, tid = heapq.heappop(running)
        sched.done(tid)
        idle.append(w)
        try_dispatch()

    if sched.waiting > 0:
        raise RuntimeError(
            f"simulation deadlocked with {sched.waiting} tasks unexecuted")
    return SimResult(
        makespan=now,
        timeline=timeline,
        nr_workers=nr_workers,
        busy=busy,
        per_type_cost=per_type,
        overhead_time=overhead_time,
        steals=sched.steals,
        gettask_calls=sched.gettask_calls,
    )


def timeline_to_tracer(result: SimResult, tracer=None, *,
                       process: str = "predicted", scale: float = 1.0,
                       t_origin: float = 0.0) -> int:
    """Emit a simulated timeline as trace task records — the *same* schema
    measured executions use, so a predicted timeline and a measured one
    render as two process tracks in a single Perfetto view (the paper's
    Fig 8/13 predicted-vs-measured methodology; ROADMAP simulator
    validation).

    Virtual time maps to trace seconds as ``t_origin + t * scale``: when
    the simulation replayed *measured* costs (``replay_item_times`` /
    ``replay_round_times``), ``scale=1.0`` keeps the two tracks on one
    clock and ``t_origin`` aligns the predicted start with the measured
    one.  Records land on the global tracer unless one is passed; returns
    the number of records emitted (0 on a disabled tracer)."""
    tr = _trace.get_tracer() if tracer is None else tracer
    if not tr.enabled:
        return 0
    for e in result.timeline:
        tr.task(e.tid, e.type, e.worker,
                t_origin + e.t0 * scale, t_origin + e.t1 * scale,
                process=process)
    return len(result.timeline)


def replay_round_times(sched: QSched, plan, round_times,
                       nr_workers: int = 1, overhead: float = 0.0) -> SimResult:
    """Validate the makespan model against measured engine rounds
    (ROADMAP: simulator validation, the paper's Fig 8/13 methodology).

    Each measured per-round time (``engine.measure_round_times``) is
    distributed over that round's tasks in proportion to their static
    costs, fed back through ``set_costs`` — the paper's cost-feedback
    loop — and the discrete-event simulator replays the schedule.  With
    ``nr_workers=1`` the predicted makespan is the additive round model
    (Σ round times); with more workers it is the model's prediction of
    what lane parallelism would buy.  Costs are restored afterwards so
    the scheduler (and the plan cache keyed on its hash) is unchanged."""
    if len(round_times) != plan.nr_rounds:
        raise ValueError(
            f"{len(round_times)} round times for a {plan.nr_rounds}-round "
            f"plan")
    old_costs = list(sched._tcost)
    costs = list(old_costs)
    for rnd, rt in zip(plan.rounds, round_times):
        share = sum(old_costs[t] for t in rnd.tids)
        for t in rnd.tids:
            costs[t] = (rt * old_costs[t] / share if share > 0
                        else rt / len(rnd.tids))
    try:
        sched.set_costs(costs)
        sched.prepare()
        return simulate(sched, nr_workers, overhead=overhead)
    finally:
        sched.set_costs(old_costs)
        sched.prepare()


def replay_item_times(sched: QSched, item_tids, item_times,
                      nr_workers: int = 1, overhead: float = 0.0) -> SimResult:
    """Replay *per-item* engine measurements (``engine.measure_round_times``
    with ``per_item=True``) through the discrete-event model.

    Where :func:`replay_round_times` can only distribute a round's wall
    time over its tasks by static cost share (an additive, 1-worker model),
    per-item measurements give each task its *own* measured cost — the sum
    of its descriptor items' times (``item_tids`` maps items back to
    tasks, ``TaskTable.tids``) — so the replay with ``nr_workers > 1``
    predicts what lane parallelism would buy from real measurements: the
    first step of validating the simulator beyond one worker (ROADMAP).
    Tasks that lowered to no items (virtual tasks) replay at zero cost.
    Costs are restored afterwards, as in :func:`replay_round_times`."""
    item_tids = [int(t) for t in item_tids]
    item_times = [float(t) for t in item_times]
    if len(item_tids) != len(item_times):
        raise ValueError(
            f"{len(item_times)} item times for {len(item_tids)} items")
    old_costs = list(sched._tcost)
    costs = [0.0] * len(old_costs)
    for tid, dt in zip(item_tids, item_times):
        if not 0 <= tid < len(costs):
            raise ValueError(f"item task id {tid} out of range")
        costs[tid] += dt
    try:
        sched.set_costs(costs)
        sched.prepare()
        return simulate(sched, nr_workers, overhead=overhead)
    finally:
        sched.set_costs(old_costs)
        sched.prepare()


def scaling_curve(make_sched, worker_counts, overhead: float = 0.0):
    """Run ``simulate`` for each worker count; ``make_sched(n)`` must return
    a fresh prepared QSched with n queues.  Returns list of
    (n, makespan, speedup, efficiency) using the 1-worker makespan as T1."""
    rows = []
    t1 = None
    for n in worker_counts:
        res = simulate(make_sched(n), n, overhead=overhead)
        if t1 is None:
            t1 = res.makespan if n == 1 else res.total_cost
        rows.append((n, res.makespan, t1 / res.makespan,
                     t1 / (n * res.makespan)))
    return rows
