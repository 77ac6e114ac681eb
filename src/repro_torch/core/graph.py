"""The qsched object: tasks, resources, dependencies, conflicts (paper §3.1–3.4).

The full task graph is constructed explicitly *before* execution
(``addtask`` / ``addres`` / ``addlock`` / ``adduse`` / ``addunlock``), then
``prepare()`` computes wait counters and critical-path weights.  Execution
engines (simulator, threaded executor, static scheduler, ExecutionPlan)
drive the same ``start`` / ``gettask`` / ``done`` protocol.

Storage is array-native: graph construction appends to flat scalar/COO
lists (no per-task objects), and ``prepare()`` compiles them into the CSR
``CompiledGraph`` (see ``arrays.py``) that every downstream consumer —
toposort, weights, wait counters, ``conflict_rounds``, the plan lowering —
operates on.  ``sched.tasks[i]`` / ``sched.resources[r]`` remain available
as lightweight views over that storage, so the paper's appendix-A API is
unchanged.

Port note: a copy of ``repro.core.graph``.  ``repro_torch`` imports nothing of
``repro`` (not even its jax-free modules), so it keeps its own copy.
"""

from __future__ import annotations

import hashlib
import random
import threading
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from repro_torch.obs import trace as _trace

from .arrays import CompiledGraph
from .locks import BaseLockManager, make_lock_manager
from .queue import TaskQueue

TASK_NONE = -1
RES_NONE = -1
OWNER_NONE = -1

FLAG_NONE = 0
FLAG_VIRTUAL = 1  # grouping-only task: scheduled but not passed to fun

_EMPTY = np.empty(0, dtype=np.int64)


class _EdgeList:
    """Append-only (a, b) id-pair store mixing per-call appends (Python tail
    lists) with bulk numpy chunks, folded lazily into one array pair.
    Insertion order is preserved across both paths."""

    __slots__ = ("chunks", "ta", "tb")

    def __init__(self):
        self.chunks: List = []
        self.ta: List[int] = []
        self.tb: List[int] = []

    def append(self, a: int, b: int) -> None:
        self.ta.append(a)
        self.tb.append(b)

    def _fold_tail(self) -> None:
        if self.ta:
            self.chunks.append((np.asarray(self.ta, dtype=np.int64),
                                np.asarray(self.tb, dtype=np.int64)))
            self.ta = []
            self.tb = []

    def extend_arrays(self, a: np.ndarray, b: np.ndarray) -> None:
        self._fold_tail()
        self.chunks.append((a, b))

    def __len__(self) -> int:
        return sum(c[0].size for c in self.chunks) + len(self.ta)

    def arrays(self):
        """(a_array, b_array) in insertion order; collapses storage to one
        chunk so repeated calls are O(1)."""
        self._fold_tail()
        if not self.chunks:
            return _EMPTY, _EMPTY
        if len(self.chunks) > 1:
            self.chunks = [(np.concatenate([c[0] for c in self.chunks]),
                            np.concatenate([c[1] for c in self.chunks]))]
        return self.chunks[0]

    def pairs(self):
        a, b = self.arrays()
        return zip(a.tolist(), b.tolist())


class Task:
    """View of one task over the scheduler's struct-of-arrays storage.

    Reads are always consistent with the underlying arrays; ``weight`` and
    ``cost`` writes go straight through (the priority-ablation benchmarks
    overwrite weights after ``prepare()``).  The adjacency properties
    (``unlocks``/``locks``/``uses``) are read-only snapshots — mutate the
    graph through ``addunlock``/``addlock``/``adduse``.
    """

    __slots__ = ("_s", "tid")

    def __init__(self, sched: "QSched", tid: int):
        self._s = sched
        self.tid = tid

    @property
    def type(self) -> int:
        return self._s._ttype[self.tid]

    @property
    def data(self) -> Any:
        return self._s._tdata[self.tid]

    @property
    def cost(self) -> float:
        return self._s._tcost[self.tid]

    @cost.setter
    def cost(self, v: float) -> None:
        self._s._tcost[self.tid] = float(v)
        self._s._prepared = False
        self._s._shash = None

    @property
    def flags(self) -> int:
        return self._s._tflags[self.tid]

    @property
    def weight(self) -> float:
        w = self._s._weight
        return float(w[self.tid]) if w is not None else 0.0

    @weight.setter
    def weight(self, v: float) -> None:
        self._s._ensure_weight()[self.tid] = v
        self._s._shash = None

    @property
    def wait(self) -> int:
        w = self._s._wait
        return int(w[self.tid]) if w is not None else 0

    @property
    def unlocks(self) -> List[int]:
        return self._s._adj()[0][self.tid]

    @property
    def locks(self) -> List[int]:
        return self._s._adj()[1][self.tid]

    @property
    def uses(self) -> List[int]:
        return self._s._adj()[2][self.tid]

    def __repr__(self) -> str:
        return (f"Task(tid={self.tid}, type={self.type}, data={self.data!r}, "
                f"cost={self.cost}, weight={self.weight})")


class Resource:
    """View of one resource (id, parent, owner) over the array storage."""

    __slots__ = ("_s", "rid")

    def __init__(self, sched: "QSched", rid: int):
        self._s = sched
        self.rid = rid

    @property
    def parent(self) -> int:
        return self._s._res_parent[self.rid]

    @property
    def owner(self) -> int:
        return self._s._res_owner[self.rid]

    @owner.setter
    def owner(self, v: int) -> None:
        self._s._res_owner[self.rid] = v
        self._s._shash = None

    def __repr__(self) -> str:
        return (f"Resource(rid={self.rid}, parent={self.parent}, "
                f"owner={self.owner})")


class _Seq:
    """Indexable/iterable view sequence (``sched.tasks``, ``sched.resources``)."""

    __slots__ = ("_s", "_cls", "_len")

    def __init__(self, sched: "QSched", cls, length: Callable[[], int]):
        self._s = sched
        self._cls = cls
        self._len = length

    def __len__(self) -> int:
        return self._len()

    def __getitem__(self, i: int):
        n = self._len()
        if i < 0:
            i += n
        if not (0 <= i < n):
            raise IndexError(i)
        return self._cls(self._s, i)

    def __iter__(self):
        for i in range(self._len()):
            yield self._cls(self._s, i)


class QSched:
    """Task scheduler with dependencies and conflicts.

    ``reown=True`` re-assigns resource ownership to the stealing queue
    (paper §3.4); the QR benchmark enables it, Barnes-Hut disables it.
    """

    def __init__(self, nr_queues: int = 1, reown: bool = True,
                 seed: int = 0):
        # struct-of-arrays task storage (parallel lists during build)
        self._ttype: List[int] = []
        self._tdata: List[Any] = []
        self._tcost: List[float] = []
        self._tflags: List[int] = []
        # COO edges / locks / uses (hybrid list/array chunk storage)
        self._deps = _EdgeList()
        self._locks = _EdgeList()
        self._uses = _EdgeList()
        # resources
        self._res_parent: List[int] = []
        self._res_owner: List[int] = []
        self.graph: Optional[CompiledGraph] = None
        self._adj_cache = None     # (version, unlocks, locks, uses)
        self._weight: Optional[np.ndarray] = None
        self._wait: Optional[List[int]] = None
        self._shash = None         # (version, hash) memo for structural_hash

        # cached view sequences (lengths resolve lazily through callables)
        self._tasks_seq = _Seq(self, Task, lambda: len(self._ttype))
        self._res_seq = _Seq(self, Resource, lambda: len(self._res_parent))

        self.nr_queues = nr_queues
        self.reown = reown
        self._rng = random.Random(seed)
        self._prepared = False
        # populated by prepare()/start():
        self.lockmgr: Optional[BaseLockManager] = None
        self.queues: List[TaskQueue] = []
        self.waiting = 0
        self._waiting_mutex = threading.Lock()
        self.topo_order: List[int] = []
        # bookkeeping for benchmarks / the paper's overhead accounting
        # (Fig 13): lock_failures counts failed all-or-nothing lockres
        # attempts in gettask (previously silently retried)
        self.steals = 0
        self.gettask_calls = 0
        self.lock_failures = 0

    # -- graph construction (paper appendix A API) --------------------------
    def addtask(self, type: int = 0, data: Any = None, cost: float = 1.0,
                flags: int = FLAG_NONE) -> int:
        tid = len(self._ttype)
        self._ttype.append(type)
        self._tdata.append(data)
        self._tcost.append(float(cost))
        self._tflags.append(flags)
        return tid

    def addres(self, owner: int = OWNER_NONE, parent: int = RES_NONE) -> int:
        rid = len(self._res_parent)
        if parent != RES_NONE and not (0 <= parent < rid):
            raise ValueError(f"invalid parent resource {parent}")
        self._res_parent.append(parent)
        self._res_owner.append(owner)
        return rid

    def addlock(self, t: int, r: int) -> None:
        if not 0 <= t < len(self._ttype):
            raise ValueError(
                f"addlock: task id {t} out of range [0, {len(self._ttype)})")
        if not 0 <= r < len(self._res_parent):
            raise ValueError(
                f"addlock: resource id {r} out of range "
                f"[0, {len(self._res_parent)})")
        self._locks.append(t, r)

    def adduse(self, t: int, r: int) -> None:
        if not 0 <= t < len(self._ttype):
            raise ValueError(
                f"adduse: task id {t} out of range [0, {len(self._ttype)})")
        if not 0 <= r < len(self._res_parent):
            raise ValueError(
                f"adduse: resource id {r} out of range "
                f"[0, {len(self._res_parent)})")
        self._uses.append(t, r)

    def addunlock(self, ta: int, tb: int) -> None:
        """tb depends on ta (ta unlocks tb)."""
        if ta == tb:
            raise ValueError("task cannot depend on itself")
        n = len(self._ttype)
        if not 0 <= ta < n:
            raise ValueError(
                f"addunlock: task id {ta} out of range [0, {n})")
        if not 0 <= tb < n:
            raise ValueError(
                f"addunlock: task id {tb} out of range [0, {n})")
        self._deps.append(ta, tb)

    # -- bulk construction (array-native fast path) --------------------------
    def addtasks(self, types, costs, datas: Sequence[Any],
                 flags: Optional[Sequence[int]] = None) -> np.ndarray:
        """Vectorized ``addtask``: append whole arrays (or plain lists) of
        tasks at once.  Returns the new task ids as an array."""
        tlist = types.tolist() if isinstance(types, np.ndarray) else types
        clist = costs.tolist() if isinstance(costs, np.ndarray) else costs
        k = len(tlist)
        if not (len(clist) == k and len(datas) == k
                and (flags is None or len(flags) == k)):
            raise ValueError(
                f"addtasks: mismatched lengths types={k} "
                f"costs={len(clist)} datas={len(datas)}"
                + (f" flags={len(flags)}" if flags is not None else ""))
        n0 = len(self._ttype)
        self._ttype.extend(tlist)
        self._tcost.extend(clist)
        self._tdata.extend(datas)
        self._tflags.extend([FLAG_NONE] * k if flags is None else list(flags))
        return np.arange(n0, n0 + k, dtype=np.int64)

    def _check_ids(self, arr: np.ndarray, limit: int, what: str,
                   who: str) -> None:
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= limit):
            bad = arr[(arr < 0) | (arr >= limit)]
            raise ValueError(
                f"{who}: {what} id(s) {bad[:8].tolist()} out of range "
                f"[0, {limit})")

    def addunlocks(self, src, dst) -> None:
        """Vectorized ``addunlock`` over parallel id arrays."""
        src = np.asarray(src, dtype=np.int64).ravel()
        dst = np.asarray(dst, dtype=np.int64).ravel()
        if src.shape != dst.shape:
            raise ValueError("addunlocks: src/dst length mismatch")
        n = len(self._ttype)
        self._check_ids(src, n, "task", "addunlocks")
        self._check_ids(dst, n, "task", "addunlocks")
        if src.size and bool((src == dst).any()):
            raise ValueError("task cannot depend on itself")
        self._deps.extend_arrays(src, dst)

    def addlocks(self, ts, rs) -> None:
        """Vectorized ``addlock`` over parallel id arrays."""
        ts = np.asarray(ts, dtype=np.int64).ravel()
        rs = np.asarray(rs, dtype=np.int64).ravel()
        if ts.shape != rs.shape:
            raise ValueError("addlocks: task/resource length mismatch")
        self._check_ids(ts, len(self._ttype), "task", "addlocks")
        self._check_ids(rs, len(self._res_parent), "resource", "addlocks")
        self._locks.extend_arrays(ts, rs)

    def adduses(self, ts, rs) -> None:
        """Vectorized ``adduse`` over parallel id arrays."""
        ts = np.asarray(ts, dtype=np.int64).ravel()
        rs = np.asarray(rs, dtype=np.int64).ravel()
        if ts.shape != rs.shape:
            raise ValueError("adduses: task/resource length mismatch")
        self._check_ids(ts, len(self._ttype), "task", "adduses")
        self._check_ids(rs, len(self._res_parent), "resource", "adduses")
        self._uses.extend_arrays(ts, rs)

    # -- derived structure ----------------------------------------------------
    @property
    def tasks(self) -> _Seq:
        return self._tasks_seq

    @property
    def resources(self) -> _Seq:
        return self._res_seq

    @property
    def nr_tasks(self) -> int:
        return len(self._ttype)

    @property
    def nr_resources(self) -> int:
        return len(self._res_parent)

    @property
    def nr_deps(self) -> int:
        return len(self._deps)

    @property
    def nr_locks(self) -> int:
        return len(self._locks)

    @property
    def nr_uses(self) -> int:
        return len(self._uses)

    def set_costs(self, costs: Sequence[float]) -> None:
        """Feed back measured task costs (the paper: 'the actual cost of the
        same task last time it was executed')."""
        if len(costs) != len(self._tcost):
            raise ValueError(
                f"set_costs: got {len(costs)} costs for "
                f"{len(self._tcost)} tasks")
        self._tcost = [float(c) for c in costs]
        self._prepared = False
        self._shash = None

    # -- compiled views -------------------------------------------------------
    def _sig(self):
        """Structural version: derived from the append-only list lengths, so
        graph construction pays zero bookkeeping per call."""
        return (len(self._ttype), len(self._deps), len(self._locks),
                len(self._uses), len(self._res_parent))

    def _is_prepared(self) -> bool:
        return (self._prepared and self.graph is not None
                and self.graph.version == self._sig())

    def _compiled(self) -> CompiledGraph:
        """Structure compile, cached per structural version (costs and
        weights do not invalidate it)."""
        sig = self._sig()
        if self.graph is None or self.graph.version != sig:
            with _trace.span("core.compile", tasks=len(self._ttype),
                             deps=len(self._deps)):
                dep_src, dep_dst = self._deps.arrays()
                lock_t, lock_r = self._locks.arrays()
                use_t, use_r = self._uses.arrays()
                self.graph = CompiledGraph(
                    sig, len(self._ttype), len(self._res_parent),
                    dep_src, dep_dst, lock_t, lock_r, use_t, use_r)
            self._adj_cache = None
        return self.graph

    def _adj(self):
        """(unlocks, locks, uses) lists-of-lists for the current version —
        from the compiled CSR when available, else built from the COO lists
        (pre-``prepare()`` reads; locks unsorted there, as before)."""
        g = self.graph
        if g is not None and g.version == self._sig():
            return g.unlocks_list, g.locks_list, g.uses_list
        if self._adj_cache is None or self._adj_cache[0] != self._sig():
            n = len(self._ttype)
            unlocks: List[List[int]] = [[] for _ in range(n)]
            locks: List[List[int]] = [[] for _ in range(n)]
            uses: List[List[int]] = [[] for _ in range(n)]
            for a, b in self._deps.pairs():
                unlocks[a].append(b)
            for t, r in self._locks.pairs():
                locks[t].append(r)
            for t, r in self._uses.pairs():
                uses[t].append(r)
            self._adj_cache = (self._sig(), unlocks, locks, uses)
        return self._adj_cache[1], self._adj_cache[2], self._adj_cache[3]

    def _ensure_weight(self) -> np.ndarray:
        if self._weight is None or self._weight.shape[0] != len(self._ttype):
            self._weight = np.zeros(len(self._ttype), dtype=np.float64)
        return self._weight

    def structural_hash(self) -> str:
        """Hash of the compiled structure + task types/flags/costs +
        weights + resource forest/ownership — the ExecutionPlan cache key
        (two graphs with equal hashes lower to identical plans).  Memoized
        per structural version; cost/weight/ownership mutations invalidate
        the memo."""
        g = self._compiled()
        if (not self._is_prepared() or self._weight is None
                or self._weight.shape[0] != g.n):
            self.prepare()
        if self._shash is not None and self._shash[0] == g.version:
            return self._shash[1]
        h = hashlib.blake2b(digest_size=16)
        h.update(f"{g.n},{g.nres}".encode())
        for arr in (g.unlocks_indptr, g.unlocks_indices,
                    g.locks_indptr, g.locks_indices,
                    g.uses_indptr, g.uses_indices):
            h.update(arr.tobytes())
        h.update(np.asarray(self._ttype, dtype=np.int64).tobytes())
        h.update(np.asarray(self._tflags, dtype=np.int64).tobytes())
        h.update(np.asarray(self._tcost, dtype=np.float64).tobytes())
        h.update(self._weight.tobytes())
        h.update(np.asarray(self._res_parent, dtype=np.int64).tobytes())
        h.update(np.asarray(self._res_owner, dtype=np.int64).tobytes())
        self._shash = (g.version, h.hexdigest())
        return self._shash[1]

    def prepare(self) -> None:
        """Compile the graph structure to CSR (once per version), then run
        the vectorized Kahn toposort + critical-path sweep; lock lists come
        out sorted by resource id (deadlock avoidance, paper §3.3)."""
        with _trace.span("core.prepare", tasks=self.nr_tasks,
                         deps=self.nr_deps):
            g = self._compiled()
            cost = np.asarray(self._tcost, dtype=np.float64)
            self._weight = g.weights(cost)
            self._wait = g.wait0.tolist()
            self.topo_order = g.order.tolist()
            self._prepared = True
            self._shash = None

    # -- execution protocol (paper §3.4) ---------------------------------------
    def start(self, threaded: bool = False) -> None:
        """qsched_start: build lock manager + queues, enqueue ready tasks."""
        if not self._is_prepared():
            self.prepare()
        g = self._compiled()
        self.lockmgr = make_lock_manager(self._res_parent, threaded)
        wtab = self._ensure_weight().tolist()
        self.queues = [TaskQueue(wtab, threaded) for _ in range(self.nr_queues)]
        self.waiting = self.nr_tasks
        self.steals = 0
        self.gettask_calls = 0
        self.lock_failures = 0
        self._wait = g.wait0.tolist()
        for tid in np.flatnonzero(g.wait0 == 0).tolist():
            self.enqueue(tid)

    def enqueue(self, tid: int) -> None:
        """qsched_enqueue: score queues by how many of the task's resources
        they own; send the task to the highest-scoring queue."""
        g = self.graph
        owner = self._res_owner
        score = [0] * self.nr_queues
        best = 0
        for r in g.locks_list[tid]:
            o = owner[r]
            if o != OWNER_NONE:
                score[o] += 1
                if score[o] > score[best]:
                    best = o
        for r in g.uses_list[tid]:
            o = owner[r]
            if o != OWNER_NONE:
                score[o] += 1
                if score[o] > score[best]:
                    best = o
        self.queues[best].put(tid)

    def _try_lock_task(self, tid: int) -> bool:
        ok = self.lockmgr.lock_all(self.graph.locks_list[tid])
        if not ok:
            # the paper's overhead accounting: a failed all-or-nothing
            # lockres attempt that gettask silently retries.  Exact under
            # threading (mutex-guarded); the failure path is off the
            # contention-free fast path so the cost is paid only when a
            # conflict actually occurred.
            with self._waiting_mutex:
                self.lock_failures += 1
        return ok

    def gettask(self, qid: int, block: bool = False) -> Optional[int]:
        """qsched_gettask: preferred queue first, then work-steal from the
        other queues in random order.  Non-blocking by default (the
        simulator retries on events); ``block`` spins like the paper's
        OpenMP loop and is used by the threaded executor."""
        while True:
            self.gettask_calls += 1
            if self.waiting <= 0:
                return None
            tid = self.queues[qid].get(self._try_lock_task)
            if tid is None and self.nr_queues > 1:
                others = [k for k in range(self.nr_queues) if k != qid]
                self._rng.shuffle(others)
                for k in others:
                    tid = self.queues[k].get(self._try_lock_task)
                    if tid is not None:
                        self.steals += 1
                        break
            if tid is not None:
                if self.reown:
                    g = self.graph
                    owner = self._res_owner
                    for r in g.locks_list[tid]:
                        owner[r] = qid
                    for r in g.uses_list[tid]:
                        owner[r] = qid
                    self._shash = None   # ownership feeds the plan hash
                return tid
            if not block:
                return None

    def done(self, tid: int) -> List[int]:
        """qsched_done: release resources, unlock dependents, enqueue any
        whose wait hits zero.  Returns the newly-released task ids."""
        g = self.graph
        self.lockmgr.unlock_all(g.locks_list[tid])
        wait = self._wait
        released: List[int] = []
        for j in g.unlocks_list[tid]:
            with self._waiting_mutex:
                wait[j] -= 1
                ready = wait[j] == 0
            if ready:
                self.enqueue(j)
                released.append(j)
        with self._waiting_mutex:
            self.waiting -= 1
        return released

    # -- convenience -----------------------------------------------------------
    def run_threaded(self, nr_threads: int, fun: Callable[[int, Any], None]) -> None:
        """qsched_run with a pthread-style pool (paper §3.4).  ``fun`` is
        called as fun(type, data) for every non-virtual task."""
        from .executors import ThreadedExecutor

        ThreadedExecutor(self, nr_threads).run(fun)

    def validate_schedule(self, timeline) -> None:
        """Assert a (task, worker, t0, t1) timeline respects dependencies and
        conflicts — used by tests and the property suite."""
        unlocks, locks, _ = self._adj()
        start = {e.tid: e.t0 for e in timeline}
        end = {e.tid: e.t1 for e in timeline}
        assert len(start) == self.nr_tasks, "not all tasks executed"
        for tid in range(self.nr_tasks):
            for j in unlocks[tid]:
                assert start[j] >= end[tid] - 1e-9, (
                    f"dependency violated: {j} started {start[j]} before "
                    f"{tid} finished {end[tid]}"
                )
        # conflicts: tasks locking overlapping resource subtrees must not
        # overlap in time.  Expand each task's locks to cover descendants via
        # ancestor chains: two tasks conflict iff one's locked resource is an
        # ancestor-or-self of the other's.
        anc = {}
        parents = self._res_parent

        def ancestors(r):
            if r not in anc:
                chain = set()
                u = r
                while u != RES_NONE:
                    chain.add(u)
                    u = parents[u]
                anc[r] = chain
            return anc[r]

        by_res = {}
        for e in timeline:
            for r in locks[e.tid]:
                for a in ancestors(r):
                    by_res.setdefault(a, []).append(e)
        for r, evs in by_res.items():
            evs.sort(key=lambda e: e.t0)
            for a, b in zip(evs, evs[1:]):
                # siblings both holding ancestor r do not conflict; only
                # pairs where one locks r itself do.
                if r in locks[a.tid] or r in locks[b.tid]:
                    assert b.t0 >= a.t1 - 1e-9, (
                        f"conflict violated on resource {r}: tasks "
                        f"{a.tid}@[{a.t0},{a.t1}) and {b.tid}@[{b.t0},{b.t1})"
                    )
