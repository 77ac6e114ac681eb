"""Task-level tracing: the paper's tic/toc instrumentation as a subsystem.

QuickSched's evaluation *is* an observability artifact — per-task
timestamps rendered as per-thread task timelines (Figs 6/7/11/12) plus
explicit scheduler-overhead accounting (Figs 8/13).  This module is the
single clock and record store behind that methodology for every tier of
the repo: a thread-safe :class:`Tracer` collecting

* **spans** — nested named intervals opened with ``with tracer.span(...)``
  (thread-local nesting, the scheduler's build/prepare/lower/encode
  phases, engine launch segments, serving request lifecycles), or
  recorded post-hoc with explicit timestamps via ``event_span`` (for
  intervals measured around blocking device calls or spanning multiple
  service ticks);
* **task records** — the paper's flat per-task tic/toc tuples
  ``(tid, task_type, lane, t0, t1)``: one per executed task, with the
  lane/worker as the timeline row (``ThreadedExecutor`` workers, engine
  measurement items, simulator lanes);
* **counter samples** — named time-series points (page-pool occupancy,
  queue depth) that export as Perfetto counter tracks.

Every record carries a ``process`` label; the Chrome exporter
(``repro.obs.export``) maps distinct labels to distinct pid tracks, which
is how simulator-*predicted* timelines overlay *measured* ones in a
single Perfetto view.

The process-global default tracer is a :class:`NullTracer` — a guaranteed
near-zero-overhead no-op (``span()`` returns one shared singleton context
manager, ``task``/``counter``/``event_span`` return immediately, and
``enabled`` is False so hot loops can skip even the timestamp reads).
``enable()`` swaps in a recording tracer; instrumentation sites never
need to know which is installed.  The tracing-disabled cost through the
scheduler hot path is gated ≤ 3% in ``benchmarks/sched_overhead.py``.

Port note: a copy of ``repro.obs.trace``.  ``repro_torch`` imports nothing of
``repro`` (not even its jax-free modules), so it keeps its own copy.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

now = time.perf_counter     # the one clock every record uses

DEFAULT_PROCESS = "measured"


@dataclass
class SpanRecord:
    """One closed interval.  ``lane`` is the timeline row label (thread
    name for nested spans, caller-chosen for ``event_span``); ``depth`` is
    the thread-local nesting depth at open time (1 = top level, 0 for
    explicit-timestamp spans, which carry no nesting)."""
    name: str
    t0: float
    t1: float
    lane: str
    depth: int
    process: str = DEFAULT_PROCESS
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TaskRecord:
    """The paper's per-task tic/toc tuple: task ``tid`` of ``task_type``
    ran on ``lane`` (worker/thread/queue id) from ``t0`` to ``t1``."""
    tid: int
    task_type: int
    lane: int
    t0: float
    t1: float
    process: str = DEFAULT_PROCESS
    name: Optional[str] = None


@dataclass
class CounterSample:
    name: str
    t: float
    value: float
    process: str = DEFAULT_PROCESS


class _Span:
    """Context manager recording one nested span on exit.  ``args`` may be
    mutated inside the ``with`` block to attach results computed during
    the span (round counts, cache hits, ...)."""

    __slots__ = ("_tracer", "name", "args", "t0", "_lane", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        tr = self._tracer
        stack = tr._stack()
        stack.append(self)
        self._depth = len(stack)
        self._lane = threading.current_thread().name
        self.t0 = now()
        return self

    def __exit__(self, *exc) -> None:
        t1 = now()
        tr = self._tracer
        tr._stack().pop()
        with tr._lock:
            tr.spans.append(SpanRecord(
                self.name, self.t0, t1, self._lane, self._depth,
                tr.process, self.args))


class _NullSpan:
    """Shared no-op span: one instance serves every disabled ``span()``
    call.  ``args`` assignments land in a throwaway class dict that is
    never read (the record is never stored)."""

    __slots__ = ()
    name = ""
    args: Dict[str, Any] = {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe trace record store.  All three record kinds append
    under one lock; reads (the exporter, tests) take snapshots via the
    plain list attributes after the traced region has quiesced."""

    enabled = True

    def __init__(self, process: str = DEFAULT_PROCESS):
        self.process = process
        self.spans: List[SpanRecord] = []
        self.tasks: List[TaskRecord] = []
        self.counters: List[CounterSample] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self.t_start = now()

    def _stack(self) -> List[_Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **args: Any) -> _Span:
        """Open a nested span: ``with tracer.span("plan.lower", tasks=n):``.
        Nesting is per-thread; the record is appended when the block
        exits."""
        return _Span(self, name, args)

    def event_span(self, name: str, t0: float, t1: float, *,
                   lane: str = "events", process: Optional[str] = None,
                   **args: Any) -> None:
        """Record a span with explicit timestamps (no thread-local
        nesting) — intervals measured around blocking device calls or
        assembled after the fact (request lifecycles)."""
        with self._lock:
            self.spans.append(SpanRecord(
                name, float(t0), float(t1), lane, 0,
                process or self.process, args))

    def task(self, tid: int, task_type: int, lane: int, t0: float,
             t1: float, *, process: Optional[str] = None,
             name: Optional[str] = None) -> None:
        """Record one task execution — the paper's tic/toc tuple."""
        with self._lock:
            self.tasks.append(TaskRecord(
                int(tid), int(task_type), int(lane), float(t0), float(t1),
                process or self.process, name))

    def counter(self, name: str, value: float, t: Optional[float] = None, *,
                process: Optional[str] = None) -> None:
        """Record one sample of a named time-series (exports as a Perfetto
        counter track)."""
        with self._lock:
            self.counters.append(CounterSample(
                name, now() if t is None else float(t), float(value),
                process or self.process))

    # -- introspection ------------------------------------------------------
    @property
    def nr_records(self) -> int:
        return len(self.spans) + len(self.tasks) + len(self.counters)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.tasks.clear()
            self.counters.clear()
            self.t_start = now()


class NullTracer:
    """Disabled tracer: every entry point is a constant-time no-op and
    ``span()`` always returns the same shared singleton, so instrumented
    code paths pay only a method call when tracing is off (gated ≤ 3% on
    the scheduler hot path by ``benchmarks/sched_overhead.py``)."""

    enabled = False
    process = DEFAULT_PROCESS
    spans: List[SpanRecord] = []      # class-level, never appended to
    tasks: List[TaskRecord] = []
    counters: List[CounterSample] = []

    def span(self, name: str, **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def event_span(self, name: str, t0: float, t1: float, **kw: Any) -> None:
        pass

    def task(self, tid: int, task_type: int, lane: int, t0: float,
             t1: float, **kw: Any) -> None:
        pass

    def counter(self, name: str, value: float,
                t: Optional[float] = None, **kw: Any) -> None:
        pass

    @property
    def nr_records(self) -> int:
        return 0

    def clear(self) -> None:
        pass


_NULL = NullTracer()
_default: Union[Tracer, NullTracer] = _NULL


def get_tracer() -> Union[Tracer, NullTracer]:
    """The process-global tracer every instrumentation site records to."""
    return _default


def set_tracer(tracer: Union[Tracer, NullTracer]) -> Union[Tracer, NullTracer]:
    global _default
    _default = tracer
    return tracer


def enable(process: str = DEFAULT_PROCESS) -> Tracer:
    """Install (and return) a fresh recording tracer as the global
    default."""
    return set_tracer(Tracer(process))


def disable() -> None:
    """Restore the no-op default."""
    set_tracer(_NULL)


def span(name: str, **args: Any):
    """Module-level convenience: open a span on the global tracer."""
    return _default.span(name, **args)
