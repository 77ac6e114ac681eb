"""Static conflict-aware schedules for SPMD execution.

On an accelerator there is no runtime lock — the compiled program is bulk
synchronous.  The QuickSched insight (the whole DAG is known up front)
becomes: *prove at schedule time* that no two conflicting tasks overlap.

``conflict_rounds`` partitions the task graph into rounds: every task in a
round has all dependencies in strictly earlier rounds, and no two tasks in a
round lock overlapping resource subtrees.  Each round then executes as one
SPMD step (every mesh lane runs its assigned tasks); inter-round data motion
is explicit.  Task → lane assignment inside a round follows resource
ownership (the cache-affinity analogue) with greedy load balancing
(the work-stealing analogue).

``list_schedule`` wraps the discrete-event simulator to produce a
worker-timed schedule (used for pipeline-parallel synthesis, where stage
lanes are the workers).

Port note: a copy of ``repro.core.static_sched``.  ``conflict_rounds``
wraps the port's own ``plan.lower`` and ``list_schedule`` its own
``simulate``; nothing of ``repro`` is imported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from .graph import QSched
from .locks import SeqLockManager
from .simulator import SimResult, simulate


@dataclass
class Round:
    tasks: List[int]               # task ids in this round
    lanes: Dict[int, List[int]]    # lane -> ordered task ids


def conflict_rounds(sched: QSched, nr_lanes: int,
                    max_tasks_per_round: Optional[int] = None) -> List[Round]:
    """Thin compatibility wrapper over the shared ``plan.lower`` lowering,
    returning the legacy ``Round`` shape.  Rounds satisfy the same
    invariants (``validate_rounds``) as the pre-refactor implementation;
    on graphs with intra-level conflicts the exact packing can differ in
    weight-tie order (newly released tasks enter the ready set in
    ascending-id order)."""
    from .plan import lower

    plan = lower(sched, nr_lanes, max_tasks_per_round)
    return [Round(list(rnd.tids),
                  {l: list(tids) for l, tids in enumerate(rnd.lanes)})
            for rnd in plan.rounds]


def validate_rounds(sched: QSched, rounds: List[Round]) -> None:
    """Dependencies strictly cross rounds; conflicts never share a round."""
    pos = {}
    for k, rnd in enumerate(rounds):
        for tid in rnd.tasks:
            assert tid not in pos, f"task {tid} scheduled twice"
            pos[tid] = k
    assert len(pos) == sched.nr_tasks, "missing tasks in rounds"
    for t in sched.tasks:
        for j in t.unlocks:
            assert pos[j] > pos[t.tid], f"dep {t.tid}->{j} within/behind round"
    parents = [r.parent for r in sched.resources]
    for rnd in rounds:
        lm = SeqLockManager(parents)
        for tid in rnd.tasks:
            assert lm.lock_all(sched.tasks[tid].locks), (
                f"conflicting tasks share round: {rnd.tasks}")


def list_schedule(sched: QSched, nr_workers: int) -> SimResult:
    """Worker-timed static schedule via the discrete-event engine."""
    return simulate(sched, nr_workers)
