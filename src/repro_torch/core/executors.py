"""Host-side executors for a prepared QSched graph.

* ``ThreadedExecutor`` — the paper's pthreads worker pool: one queue per
  thread, spin(-ish) on gettask, execute, done.  Exercises the *threaded*
  lock protocol (real mutex-emulated CAS).  Python's GIL serialises compute,
  so this validates correctness, not speedup.  On a CUDA device every
  worker launches on the caller's current stream, so stream order carries
  the dependency order that the lock protocol released.
* ``SequentialExecutor`` — a single worker draining the scheduler in
  priority order; task bodies run eagerly, in that order.

Both accept ``pass_tid=True`` to call ``fun(type, data, tid)`` for task
bodies that key side tables by task id (Barnes-Hut's per-task work lists).

Observability (DESIGN.md §Observability): when the global tracer is
enabled, both executors record one per-task tic/toc record
``(tid, type, worker, t0, t1)`` — the paper's per-thread task timelines
(Figs 6/7/11/12).  Independently of tracing, each run tallies exact
per-type execution counts (``type_counts``) and, for the threaded
executor, the failed ``lockres`` attempts of the run (``lock_failures``,
the paper's Fig 13 overhead accounting) — both also bulk-incremented
onto the global metrics registry (``executor.tasks.type*``,
``executor.tasks_executed``, ``executor.lock_failures``).

Port note: a copy of ``repro.core.executors``.  ``repro_torch`` imports
nothing of ``repro`` (not even its jax-free modules), so it keeps its own
copy.  One change: ``ThreadedExecutor`` workers enter the caller's CUDA
stream (``_caller_stream``), because PyTorch's current stream is
thread-local and a new thread would otherwise launch on the default one.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Mapping

import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from .graph import FLAG_VIRTUAL, QSched


def registry_fun(registry: Mapping[int, Any]) -> Callable[[int, Any, int], None]:
    """Adapt a BatchSpec registry into the ``fun(type, data, tid)`` shape
    the executors call: each task dispatches to its type's ``run_one``.
    This is how the sequential/threaded backends share the exact same
    per-type task bodies as the rounds/engine paths (core.backends)."""
    def fun(ttype: int, data: Any, tid: int) -> None:
        spec = registry.get(ttype)
        if spec is None:
            raise KeyError(f"no BatchSpec registered for task type {ttype}")
        spec.run_one(tid, data)
    return fun


def _publish_counts(prefix: str, type_counts: Dict[int, int],
                    lock_failures: int = 0) -> None:
    """Bulk-increment one run's exact tallies onto the global registry
    (one ``inc`` per type, never per task — zero hot-path cost)."""
    reg = _metrics.get_registry()
    total = 0
    for ttype, n in type_counts.items():
        reg.counter(f"{prefix}.tasks.type{ttype}").inc(n)
        total += n
    reg.counter(f"{prefix}.tasks_executed").inc(total)
    if lock_failures:
        reg.counter(f"{prefix}.lock_failures").inc(lock_failures)


def _caller_stream() -> Callable[[], Any]:
    """Context factory that puts a worker thread on the calling thread's
    current CUDA stream (a no-op when CUDA was never initialised, e.g. a
    CPU run)."""
    if not torch.cuda.is_initialized():
        return contextlib.nullcontext
    stream = torch.cuda.current_stream()
    return lambda: torch.cuda.stream(stream)


class ThreadedExecutor:
    def __init__(self, sched: QSched, nr_threads: int):
        self.sched = sched
        self.nr_threads = nr_threads
        self.errors: List[BaseException] = []
        self._abort = threading.Event()
        # per-run accounting, reset by run() like the error state
        self.lock_failures = 0
        self.type_counts: Dict[int, int] = {}
        self._worker_counts: List[Dict[int, int]] = []

    def _worker(self, wid: int, fun: Callable[..., None],
                pass_tid: bool, stream_ctx: Callable[[], Any]) -> None:
        with stream_ctx():
            self._drain(wid, fun, pass_tid)

    def _drain(self, wid: int, fun: Callable[..., None],
               pass_tid: bool) -> None:
        s = self.sched
        qid = wid % s.nr_queues
        ttype, tdata, tflags = s._ttype, s._tdata, s._tflags
        tr = _trace.get_tracer()
        counts = self._worker_counts[wid]
        try:
            while not self._abort.is_set():
                tid = s.gettask(qid, block=False)
                if tid is None:
                    if s.waiting <= 0:
                        return
                    time.sleep(1e-5)  # qsched_flag_yield analogue
                    continue
                if not tflags[tid] & FLAG_VIRTUAL:
                    tt = ttype[tid]
                    if tr.enabled:
                        t0 = time.perf_counter()
                    if pass_tid:
                        fun(tt, tdata[tid], tid)
                    else:
                        fun(tt, tdata[tid])
                    if tr.enabled:
                        tr.task(tid, tt, wid, t0, time.perf_counter())
                    counts[tt] = counts.get(tt, 0) + 1
                s.done(tid)
        except BaseException as e:  # surface worker errors to the caller
            self.errors.append(e)
            # A failed task never reaches done(), so `waiting` can never
            # drain — without this abort the surviving workers would spin
            # forever and run() would hang in join instead of raising.
            self._abort.set()

    def run(self, fun: Callable[..., None], pass_tid: bool = False) -> None:
        self.errors.clear()
        self._abort.clear()
        self.lock_failures = 0
        self.type_counts = {}
        self._worker_counts = [{} for _ in range(self.nr_threads)]
        self.sched.start(threaded=True)
        stream_ctx = _caller_stream()
        threads = [
            threading.Thread(target=self._worker,
                             args=(w, fun, pass_tid, stream_ctx),
                             daemon=True)
            for w in range(self.nr_threads)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        # workers have quiesced: merge their private tallies (exact, no
        # cross-thread increments anywhere on the hot path)
        for counts in self._worker_counts:
            for tt, n in counts.items():
                self.type_counts[tt] = self.type_counts.get(tt, 0) + n
        self.lock_failures = self.sched.lock_failures
        _publish_counts("executor", self.type_counts, self.lock_failures)
        if self.errors:
            raise self.errors[0]
        if self.sched.waiting > 0:
            raise RuntimeError(
                f"{self.sched.waiting} tasks unexecuted (deadlock?)")
        assert self.sched.lockmgr.all_free(), "resources left locked"

    def run_registry(self, registry: Mapping[int, Any]) -> None:
        """Drain the scheduler dispatching each task to its type's
        ``BatchSpec.run_one`` (the backend-registry entry point)."""
        self.run(registry_fun(registry), pass_tid=True)


class SequentialExecutor:
    """Drain the scheduler with one worker, running each task body
    eagerly in the scheduler's priority order.

    Per-task tic/toc records measure *host dispatch* time here — on a CUDA
    device the bodies enqueue kernels and return, so the records show
    scheduling order, not device time."""

    def __init__(self, sched: QSched):
        self.sched = sched
        self.type_counts: Dict[int, int] = {}

    def run(self, fun: Callable[..., None],
            pass_tid: bool = False) -> List[int]:
        s = self.sched
        s.start(threaded=False)
        ttype, tdata, tflags = s._ttype, s._tdata, s._tflags
        tr = _trace.get_tracer()
        counts: Dict[int, int] = {}
        order: List[int] = []
        while True:
            tid = s.gettask(0, block=False)
            if tid is None:
                if s.waiting <= 0:
                    break
                raise RuntimeError(
                    f"no runnable task with {s.waiting} waiting (deadlock)")
            if not tflags[tid] & FLAG_VIRTUAL:
                tt = ttype[tid]
                if tr.enabled:
                    t0 = time.perf_counter()
                if pass_tid:
                    fun(tt, tdata[tid], tid)
                else:
                    fun(tt, tdata[tid])
                if tr.enabled:
                    tr.task(tid, tt, 0, t0, time.perf_counter())
                counts[tt] = counts.get(tt, 0) + 1
            order.append(tid)
            s.done(tid)
        self.type_counts = counts
        _publish_counts("executor", counts)
        return order

    def run_registry(self, registry: Mapping[int, Any]) -> List[int]:
        """Drain the scheduler dispatching each task to its type's
        ``BatchSpec.run_one`` (the backend-registry entry point)."""
        return self.run(registry_fun(registry), pass_tid=True)
