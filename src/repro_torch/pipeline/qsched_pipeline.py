"""Pipeline-parallel schedule synthesis from a QuickSched task graph.

Instead of hard-coding 1F1B/GPipe, the pipeline schedule EMERGES from the
paper's machinery:

  * tasks: F(s,m) forward and B(s,m) backward per (stage s, microbatch m),
    plus one weight-update task U(s) per stage;
  * dependencies: F(s,m) ← F(s-1,m);  B(s,m) ← B(s+1,m);
    B(last,m) ← F(last,m);  U(s) ← all B(s,·) (via the wait counter);
  * conflicts: every task on stage s locks the stage resource (a device can
    run one thing at a time); B(s,m) additionally locks the *gradient
    accumulation buffer* resource g_s — the paper's motivating
    "order-independent but serialized" case (§1: FMM force accumulation);
    U(s) locks g_s too, so it conflicts with every accumulation without a
    fixed order.
  * priorities: critical-path weights make deep-stage forwards urgent —
    exactly the property that turns the greedy schedule into 1F1B rather
    than GPipe-style fill-drain.

``synthesize_schedule`` runs the discrete-event engine (one queue per
stage, ownership pinned, no stealing — placement is physical) and returns
per-stage timelines; ``bubble_fraction`` compares against the analytic
1F1B bubble  (S-1)/(M+S-1).

Port note: a copy of ``repro.pipeline.qsched_pipeline`` on the port's own
scheduler core; ``tests/test_torch_pipeline.py`` holds its graphs, plans,
tables and schedules equal to the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.core import ExecutionPlan, QSched, lower, simulate

F, B, U = 0, 1, 2
KIND = {F: "F", B: "B", U: "U"}


def build_pipeline_graph(n_stages: int, n_micro: int, fwd_cost: float = 1.0,
                         bwd_cost: float = 2.0, upd_cost: float = 0.5,
                         max_in_flight: int = 0,
                         per_stage_window: bool = False) -> Tuple[QSched, Dict]:
    """``max_in_flight`` > 0 bounds the activation stash per stage: F(s,m)
    additionally depends on B(s, m - W).  ``per_stage_window`` uses the
    1F1B stash profile W_k = n_stages - k, under which the greedy
    critical-path schedule reproduces the 1F1B bubble AND memory exactly
    (benchmarks/pipeline_bubble.py) — 1F1B *emerges*, it is not coded."""
    s = QSched(nr_queues=n_stages, reown=False)
    stage_res = [s.addres(owner=k) for k in range(n_stages)]
    grad_res = [s.addres(owner=k, parent=stage_res[k])
                for k in range(n_stages)]
    fid: Dict[Tuple[int, int], int] = {}
    bid: Dict[Tuple[int, int], int] = {}
    for m in range(n_micro):
        for k in range(n_stages):
            t = s.addtask(F, data=("F", k, m), cost=fwd_cost)
            s.addlock(t, stage_res[k])
            if k > 0:
                s.addunlock(fid[k - 1, m], t)
            fid[k, m] = t
    for m in range(n_micro):
        for k in reversed(range(n_stages)):
            t = s.addtask(B, data=("B", k, m), cost=bwd_cost)
            s.addlock(t, grad_res[k])     # conflict: grad accumulation
            if k == n_stages - 1:
                s.addunlock(fid[k, m], t)
            else:
                s.addunlock(bid[k + 1, m], t)
            bid[k, m] = t
    if max_in_flight > 0 or per_stage_window:  # activation-memory throttle
        for k in range(n_stages):
            w = (n_stages - k) if per_stage_window else max_in_flight
            for m in range(w, n_micro):
                s.addunlock(bid[k, m - w], fid[k, m])
    for k in range(n_stages):
        t = s.addtask(U, data=("U", k), cost=upd_cost)
        s.addlock(t, grad_res[k])
        for m in range(n_micro):
            s.addunlock(bid[k, m], t)
    return s, {"fid": fid, "bid": bid, "stage_res": stage_res}


@dataclass
class PipelineSchedule:
    n_stages: int
    n_micro: int
    makespan: float
    # per stage: ordered [(kind, stage, micro, t0, t1)]
    lanes: List[List[Tuple[str, int, int, float, float]]]
    work_time: float

    def order_for_stage(self, k: int) -> List[Tuple[str, int]]:
        """[(F|B|U, microbatch)] in execution order — feed to an executor."""
        return [(kind, m) for kind, _, m, _, _ in self.lanes[k]]


def synthesize_schedule(n_stages: int, n_micro: int, fwd_cost: float = 1.0,
                        bwd_cost: float = 2.0, upd_cost: float = 0.5,
                        max_in_flight: int = 0,
                        per_stage_window: bool = False) -> PipelineSchedule:
    sched, meta = build_pipeline_graph(n_stages, n_micro, fwd_cost,
                                       bwd_cost, upd_cost, max_in_flight,
                                       per_stage_window)
    res = simulate(sched, n_stages)
    sched.validate_schedule(res.timeline)
    lanes: List[List] = [[] for _ in range(n_stages)]
    for ev in res.timeline:
        kind, k, *rest = sched.tasks[ev.tid].data
        m = rest[0] if rest else -1
        lanes[k].append((kind, k, m, ev.t0, ev.t1))
    for lane in lanes:
        lane.sort(key=lambda e: e[3])
    work = sum(ev.t1 - ev.t0 for ev in res.timeline)
    return PipelineSchedule(n_stages, n_micro, res.makespan, lanes, work)


def lower_pipeline_plan(n_stages: int, n_micro: int, fwd_cost: float = 1.0,
                        bwd_cost: float = 2.0, upd_cost: float = 0.5,
                        max_in_flight: int = 0,
                        per_stage_window: bool = False
                        ) -> Tuple[QSched, Dict, ExecutionPlan]:
    """Lower the pipeline graph through the shared ExecutionPlan layer: each
    round is one bulk-synchronous pipeline step (per-stage conflicts cap a
    round at one task per stage; grad-buffer conflicts keep accumulation and
    the update exclusive).  The plan cache means a trainer loop rebuilding
    the same (S, M, costs) graph every step skips re-lowering.  The returned
    plan executes on any registered backend (``core.backends``) —
    ``exec.pipelined_value_and_grad_plan`` drives it end to end, including
    the ``engine`` path (the K9 walk, one cooperative launch a plan over
    its write-colored phases)."""
    sched, meta = build_pipeline_graph(n_stages, n_micro, fwd_cost, bwd_cost,
                                       upd_cost, max_in_flight,
                                       per_stage_window)
    plan = lower(sched, nr_lanes=n_stages)
    return sched, meta, plan


def bubble_fraction(ps: PipelineSchedule) -> float:
    return 1.0 - ps.work_time / (ps.n_stages * ps.makespan)


def one_f_one_b_bubble(n_stages: int, n_micro: int) -> float:
    """Analytic 1F1B bubble fraction (equal fwd+bwd per microbatch)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
