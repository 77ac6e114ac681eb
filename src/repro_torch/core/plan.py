"""ExecutionPlan: the shared lowering layer over a prepared QSched graph.

``lower()`` partitions any prepared graph into *typed, conflict-free,
batchable rounds*: every task in a round has all dependencies in strictly
earlier rounds, no two tasks in a round lock overlapping resource subtrees,
and within a round tasks are grouped by task type so same-type groups can
execute as one vmapped kernel call.  Each round also carries a lane
assignment (resource-ownership affinity + greedy load balancing — the
paper's cache-affinity / work-stealing analogues at schedule time).

This is the single lowering shared by the QR app, Barnes-Hut, and the
pipeline synthesizer; executing a plan needs only a *batch-spec registry*:

    registry = {TASK_TYPE: BatchSpec(run_one=..., run_batch=...)}
    lower(sched, nr_lanes=8).execute(sched, registry)

``run_batch`` (optional) receives all of a round's same-type payloads at
once — stack the operands, call the vmapped kernel, scatter back.  Types
without a ``run_batch`` fall back to per-task ``run_one``.

Plans are cached keyed by the graph's structural hash (CSR arrays + costs +
weights + resource forest/ownership), so trainer/serving loops that rebuild
an identical graph every step skip re-lowering entirely.  The lowering
itself runs over the compiled CSR arrays: when every topo level is
internally conflict-free (QR, pipeline) one vectorized validation pass
emits the Kahn levels as the rounds directly; otherwise a greedy loop with
vectorized ready-set bookkeeping (``csr_gather`` + ``bincount``) and a flat
check-and-claim lock state over precomputed ancestor chains packs rounds
exactly like the runtime protocol would.

Port note: a copy of ``repro.core.plan``.  ``repro_torch`` imports nothing of
``repro`` (not even its jax-free modules), so it keeps its own copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from .arrays import csr_gather
from .graph import FLAG_VIRTUAL, QSched

_PLAN_CACHE: "Dict[Tuple[str, int, Optional[int]], ExecutionPlan]" = {}
_PLAN_CACHE_MAX = 64
# exact-count cache accounting lives on the metrics registry
# (DESIGN.md §Observability); plan_cache_info() keeps the dict shape the
# serving tests assert against
_CACHE_HITS = _metrics.get_registry().counter("plan.cache.hits")
_CACHE_MISSES = _metrics.get_registry().counter("plan.cache.misses")


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _CACHE_HITS.reset()
    _CACHE_MISSES.reset()


def plan_cache_info() -> Dict[str, int]:
    """Cache occupancy plus hit/miss counters since the last
    ``clear_plan_cache``.  The counters are how the serving tier asserts
    its compiled-module-registry behaviour: admission/decode rounds with
    an already-seen batch shape must be cache hits (``tests/test_serve.py``
    plan-cache regression)."""
    return {"entries": len(_PLAN_CACHE), "max": _PLAN_CACHE_MAX,
            "hits": _CACHE_HITS.value, "misses": _CACHE_MISSES.value}


@dataclass(frozen=True)
class BatchSpec:
    """How one task type executes inside a plan round.

    ``run_one(tid, data)`` executes a single task; ``run_batch(tids, datas)``
    (optional) executes a whole same-type group — it is only used when the
    group has at least ``min_batch`` tasks.

    ``encode`` (optional) is the *device* lowering of the same type: it maps
    one task to integer descriptor rows ``[(engine_type, arg0, ...), ...]``
    for the ``repro.engine`` task tables (DESIGN.md §Engine).  One registry
    therefore describes a task family for both execution paths — the
    host-dispatched round executor below and the device-resident engine.
    """
    run_one: Callable[[int, Any], None]
    run_batch: Optional[Callable[[Sequence[int], Sequence[Any]], None]] = None
    min_batch: int = 2
    encode: Optional[Callable[[int, Any], Sequence[Tuple[int, ...]]]] = None


@dataclass(frozen=True)
class TypedBatch:
    ttype: int
    tids: Tuple[int, ...]


@dataclass(frozen=True)
class PlanRound:
    tids: Tuple[int, ...]                 # weight-descending
    batches: Tuple[TypedBatch, ...]       # grouped by type, type-ascending
    lanes: Tuple[Tuple[int, ...], ...]    # lane -> ordered task ids


@dataclass
class ExecutionPlan:
    """A lowered schedule: conflict-free rounds of typed batches.

    The plan stores only task *ids* — payloads are read from the scheduler
    at execution time, so one cached plan serves every structurally
    identical graph (trainer loops rebuilding the same graph each step).
    """
    rounds: List[PlanRound]
    nr_lanes: int
    nr_tasks: int
    structural_hash: str
    stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def nr_rounds(self) -> int:
        return len(self.rounds)

    def check_compatible(self, sched: QSched) -> None:
        """Refuse to pair this plan with a structurally different graph.

        When the plan carries a structural hash (cached lowerings), the
        scheduler must hash identically — executing a plan against a graph
        with different dependencies/conflicts would silently violate them.
        Shared by ``execute`` and the engine table lowering
        (``repro.engine.descriptors``)."""
        if sched.nr_tasks != self.nr_tasks:
            raise ValueError(
                f"plan lowered for {self.nr_tasks} tasks, scheduler has "
                f"{sched.nr_tasks}")
        if self.structural_hash and sched.structural_hash() != self.structural_hash:
            raise ValueError(
                "plan was lowered for a structurally different graph "
                "(structural hash mismatch)")

    def execute(self, sched: QSched,
                registry: Mapping[int, BatchSpec]) -> None:
        """Run every round's typed batches through the registry.  Virtual
        tasks are scheduled but never passed to a spec (FLAG_VIRTUAL)."""
        self.check_compatible(sched)
        datas = sched._tdata
        flags = sched._tflags
        for rnd in self.rounds:
            for tb in rnd.batches:
                tids = [t for t in tb.tids if not flags[t] & FLAG_VIRTUAL]
                if not tids:
                    continue      # all-virtual batches need no BatchSpec
                spec = registry.get(tb.ttype)
                if spec is None:
                    raise KeyError(
                        f"no BatchSpec registered for task type {tb.ttype}")
                if spec.run_batch is not None and len(tids) >= spec.min_batch:
                    spec.run_batch(tids, [datas[t] for t in tids])
                else:
                    run_one = spec.run_one
                    for t in tids:
                        run_one(t, datas[t])

    def run(self, sched: QSched, registry: Mapping[int, "BatchSpec"],
            backend: str = "rounds", *, nr_workers: int = 1,
            engine: Any = None) -> None:
        """Execute this plan on a registered execution backend
        (``core.backends``): ``rounds`` dispatches the typed batches on
        the host, ``engine`` ships descriptor tables to the device
        megakernel, ``sequential``/``threaded`` drain the scheduler
        directly (the plan is ignored but capability-checked)."""
        from .backends import run_plan        # late: backends imports plan
        run_plan(sched, registry, backend, nr_workers=nr_workers,
                 engine=engine, plan=self)


def color_phases(accesses: Sequence[Tuple[Sequence, Sequence]]) -> List[int]:
    """Write-coloring pass: split one round's ordered work items into
    *sub-phases* safe for a parallel walk (DESIGN.md §Engine, "Ragged
    tables & grid walk").

    ``accesses[i]`` is ``(reads, writes)`` — hashable state-row keys item
    ``i`` loads from / stores to.  Conflict-free rounds guarantee that no
    two *tasks* of a round touch overlapping locked resource subtrees, but
    a single task may expand into several descriptor rows that
    read-modify-write the same state row (Barnes-Hut ``acc[leaf] += …``
    chunks, pipeline grad-buffer accumulation), and ``use``-shared state
    may be read by one item while another rewrites it.  Those item pairs
    must not execute concurrently.

    The pass is an order-preserving barrier coloring: items are scanned in
    slab order and a new phase opens exactly when an item conflicts with
    the phase being filled (its writes intersect the phase's reads or
    writes, or its reads intersect the phase's writes).  Phases are
    therefore *contiguous* slices of the original order, items that share
    a destination keep their relative order across phases (accumulation
    order — and hence bit patterns — match the sequential walk), and
    within a phase no two items touch a common state row, so the engine
    may execute a phase's items in any order or in parallel
    (property-tested in ``tests/test_engine_properties.py``).

    Returns the phase boundaries as offsets into ``accesses``
    (``[0, …, len(accesses)]``); ``len(result) - 1`` is the phase count
    (0 for an empty round)."""
    bounds: List[int] = [0]
    if not accesses:
        return bounds
    with _trace.span("plan.color_phases", items=len(accesses)):
        cur_reads: set = set()
        cur_writes: set = set()
        for i, (reads, writes) in enumerate(accesses):
            r, w = set(reads), set(writes)
            conflict = bool((cur_writes & (r | w)) or (w & cur_reads))
            if conflict and i > bounds[-1]:
                bounds.append(i)
                cur_reads, cur_writes = set(), set()
            cur_reads |= r
            cur_writes |= w
        bounds.append(len(accesses))
    return bounds


def lower(sched: QSched, nr_lanes: int,
          max_tasks_per_round: Optional[int] = None,
          cache: bool = True) -> ExecutionPlan:
    """Lower a (prepared) graph into an ExecutionPlan.  Cached by the
    graph's structural hash — identical structure+costs+ownership reuse the
    existing plan without re-lowering."""
    if not sched._is_prepared():
        sched.prepare()
    shash = sched.structural_hash() if cache else ""
    if cache:
        key = (shash, nr_lanes, max_tasks_per_round)
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            _PLAN_CACHE.pop(key)       # LRU: refresh on hit
            _PLAN_CACHE[key] = hit
            _CACHE_HITS.inc()
            return hit
        _CACHE_MISSES.inc()
    with _trace.span("plan.lower", tasks=sched.nr_tasks,
                     nr_lanes=nr_lanes) as sp:
        plan = _lower(sched, nr_lanes, max_tasks_per_round, shash)
        sp.args["rounds"] = plan.nr_rounds
    if cache:
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[key] = plan
    return plan


def _ancestor_chains(parents: List[int]) -> List[Tuple[int, ...]]:
    chains: List[Tuple[int, ...]] = []
    for r in range(len(parents)):
        out = []
        u = parents[r]
        while u != -1:
            out.append(u)
            u = parents[u]
        chains.append(tuple(out))
    return chains


def _affinity_prefs(g, nr_lanes: int, owners: List[int]) -> List[int]:
    """Per-task lane preference: the owner of the task's first locked (else
    first used) resource under the ownership map at lowering time, -1 when
    that maps to no lane.  One vectorized pass; the map is static for the
    whole lowering (the paper's initial tile/cell → queue assignment), while
    runtime executors keep the dynamic re-owning of §3.4."""
    n = g.n
    owners_arr = np.asarray(owners, dtype=np.int64)
    lp, li = g.locks_indptr, g.locks_indices
    up, ui = g.uses_indptr, g.uses_indices
    first = np.full(n, -1, dtype=np.int64)
    if ui.size:
        has_use = up[1:] > up[:-1]
        first[has_use] = ui[up[:-1][has_use]]
    if li.size:
        has_lock = lp[1:] > lp[:-1]
        first[has_lock] = li[lp[:-1][has_lock]]   # locks take precedence
    pref = np.full(n, -1, dtype=np.int64)
    sel = first >= 0
    pref[sel] = owners_arr[first[sel]]
    pref[(pref < 0) | (pref >= nr_lanes)] = -1
    return pref.tolist()


def _balance_round(chosen: List[int], pref: List[int], cost: List[float],
                   nr_lanes: int) -> Tuple[Tuple[int, ...], ...]:
    """Greedy load balance of one round (``chosen`` is weight-descending):
    a task takes its preferred lane unless it is unset or already holds more
    than 2× the round's mean per-lane cost, in which case it spills to the
    currently least-loaded lane (the schedule-time work-stealing analogue).
    The mean-based overload cap is a constant per round, so affinity
    assignments cost O(1) and only actual spills scan for the minimum."""
    lanes: List[List[int]] = [[] for _ in range(nr_lanes)]
    load = [0.0] * nr_lanes
    cap = 2.0 * sum(cost[t] for t in chosen) / nr_lanes + 1e-12
    for tid in chosen:
        lane = pref[tid]
        if lane < 0 or load[lane] > cap:
            lane = load.index(min(load))  # steal: owner lane overloaded
        lanes[lane].append(tid)
        load[lane] += cost[tid]
    return tuple(tuple(l) for l in lanes)


def _batches_of(chosen: List[int], types: List[int]) -> Tuple[TypedBatch, ...]:
    by_type: Dict[int, List[int]] = {}
    for tid in chosen:
        by_type.setdefault(types[tid], []).append(tid)
    return tuple(TypedBatch(tt, tuple(tids))
                 for tt, tids in sorted(by_type.items()))


def _level_rounds(sched: QSched, g, nr_lanes: int, cap: int,
                  types: List[int], cost: List[float], pref: List[int],
                  flat_forest: bool):
    """Shortcut: when every topo level is internally conflict-free, the
    greedy round construction provably reproduces the Kahn levels computed
    by ``prepare()`` — validate that property in one vectorized pass over
    the locks COO and emit all rounds without iterating the ready set.
    Returns None when some level carries a conflict (or the cap binds) and
    the general greedy loop must run."""
    n = g.n
    sizes = np.diff(g.level_ptr)
    if sizes.size and int(sizes.max()) > cap:
        return None
    lvl_of = np.empty(n, dtype=np.int64)
    lvl_of[g.order] = np.repeat(np.arange(sizes.size, dtype=np.int64), sizes)
    li = g.locks_indices
    if li.size:
        task_per = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(g.locks_indptr))
        keys = lvl_of[task_per] * g.nres + li
        skeys = np.sort(keys)
        if bool((skeys[1:] == skeys[:-1]).any()):
            return None          # two tasks in one level lock the same res
        if not flat_forest:
            anc = _ancestor_chains(sched._res_parent)
            anc_indptr = np.zeros(g.nres + 1, dtype=np.int64)
            np.cumsum([len(c) for c in anc], out=anc_indptr[1:])
            anc_indices = np.asarray([a for c in anc for a in c],
                                     dtype=np.int64)
            anc_deg = anc_indptr[li + 1] - anc_indptr[li]
            anc_flat = csr_gather(anc_indptr, anc_indices, li)
            if anc_flat.size:
                akeys = (np.repeat(lvl_of[task_per], anc_deg) * g.nres
                         + anc_flat)
                pos = np.searchsorted(skeys, akeys)
                pos = np.minimum(pos, skeys.size - 1)
                if bool((skeys[pos] == akeys).any()):
                    return None  # locked res + ancestor within one level
    # round order the greedy loop would produce: level, then weight
    # descending, ties by ascending id (lexsort is stable)
    perm_list = np.lexsort((-sched._weight, lvl_of)).tolist()
    rounds: List[PlanRound] = []
    off = 0
    for sz in sizes.tolist():
        chosen = perm_list[off:off + sz]
        off += sz
        rounds.append(PlanRound(
            tuple(chosen), _batches_of(chosen, types),
            _balance_round(chosen, pref, cost, nr_lanes)))
    return rounds


def _lower(sched: QSched, nr_lanes: int, cap: Optional[int],
           shash: str) -> ExecutionPlan:
    g = sched.graph
    n = g.n
    weight = sched._weight.tolist()
    types = sched._ttype
    cost = sched._tcost
    cap = cap or n
    flat_forest = all(p == -1 for p in sched._res_parent)
    pref = _affinity_prefs(g, nr_lanes, sched._res_owner)

    level_rounds = _level_rounds(sched, g, nr_lanes, cap, types, cost,
                                 pref, flat_forest)
    if level_rounds is not None:
        return _finish_plan(level_rounds, nr_lanes, n, shash,
                            fastpath_rounds=len(level_rounds),
                            level_shortcut=True)

    wait = g.wait0.copy()
    ready: List[int] = np.flatnonzero(g.wait0 == 0).tolist()
    ready.sort(key=weight.__getitem__, reverse=True)
    locks = g.locks_list
    anc = _ancestor_chains(sched._res_parent)
    # flat lock state, reset incrementally between rounds (paper §3.2
    # semantics: lock excludes ancestors and descendants via hold counts)
    locked = bytearray(g.nres)
    hold = [0] * g.nres

    rounds: List[PlanRound] = []
    done = 0
    fastpath_rounds = 0
    while done < n:
        # Fast path: check the whole ready set for mutual conflict-freedom
        # in one vectorized pass (no duplicate locked resource, no locked
        # resource in another's ancestor chain).
        chosen: Optional[List[int]] = None
        skipped: List[int] = []
        if len(ready) <= cap:
            ls_flat = csr_gather(g.locks_indptr, g.locks_indices,
                                 np.asarray(ready, dtype=np.int64))
            uniq = np.unique(ls_flat)
            ok = uniq.size == ls_flat.size
            if ok and not flat_forest and uniq.size:
                mask = np.zeros(g.nres, dtype=bool)
                mask[uniq] = True
                anc_flat = np.asarray(
                    [a for r in uniq.tolist() for a in anc[r]],
                    dtype=np.int64)
                ok = not (anc_flat.size and bool(mask[anc_flat].any()))
            if ok:
                chosen = ready
                fastpath_rounds += 1
        if chosen is None:
            chosen = []
            for tid in ready:
                if len(chosen) >= cap:
                    skipped.append(tid)
                    continue
                ls = locks[tid]
                ok = True
                taken = 0
                for r in ls:
                    if locked[r] or hold[r]:
                        ok = False
                        break
                    locked[r] = 1
                    for a in anc[r]:
                        if locked[a]:
                            ok = False
                            locked[r] = 0
                            break
                        hold[a] += 1
                    if not ok:
                        # roll back the partial ancestor holds of r
                        for a in anc[r]:
                            if locked[a]:
                                break
                            hold[a] -= 1
                        break
                    taken += 1
                if ok:
                    chosen.append(tid)
                else:
                    for r in ls[:taken]:      # all-or-nothing rollback
                        locked[r] = 0
                        for a in anc[r]:
                            hold[a] -= 1
                    skipped.append(tid)
            if not chosen:
                raise RuntimeError(
                    "static schedule stalled (conflict deadlock?)")
            # release this round's lock state for the next one
            for tid in chosen:
                for r in locks[tid]:
                    locked[r] = 0
                    for a in anc[r]:
                        hold[a] -= 1
        rounds.append(PlanRound(
            tuple(chosen), _batches_of(chosen, types),
            _balance_round(chosen, pref, cost, nr_lanes)))
        done += len(chosen)
        # release dependencies (vectorized over the whole round)
        newly: List[int] = []
        succ = csr_gather(g.unlocks_indptr, g.unlocks_indices,
                          np.asarray(chosen, dtype=np.int64))
        if succ.size:
            dec = np.bincount(succ, minlength=n)
            wait -= dec
            newly = np.flatnonzero((wait == 0) & (dec > 0)).tolist()
        ready = skipped + newly
        ready.sort(key=weight.__getitem__, reverse=True)

    return _finish_plan(rounds, nr_lanes, n, shash,
                        fastpath_rounds=fastpath_rounds,
                        level_shortcut=False)


def _finish_plan(rounds: List[PlanRound], nr_lanes: int, n: int, shash: str,
                 fastpath_rounds: int, level_shortcut: bool) -> ExecutionPlan:
    batched = sum(1 for rnd in rounds for tb in rnd.batches if len(tb.tids) > 1)
    return ExecutionPlan(
        rounds=rounds, nr_lanes=nr_lanes, nr_tasks=n, structural_hash=shash,
        stats={"rounds": len(rounds), "tasks": n,
               "fastpath_rounds": fastpath_rounds,
               "level_shortcut": level_shortcut,
               "multi_task_batches": batched})
