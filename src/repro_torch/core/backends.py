"""Execution backends: one registry for every way a task graph can run.

The paper's central claim is that ONE scheduler core serves heterogeneous
workloads without per-workload executor code.  This module is where that
claim lives at the dispatch layer: a :class:`Backend` knows how to drive a
``(sched, plan, registry)`` triple, backends register under their mode
string, and every caller — the QR app, Barnes-Hut, the pipeline
synthesizer, benchmarks — executes through ``get_backend(mode).run(...)``
(or the :func:`run_plan` convenience that also lowers the plan when the
backend needs one).  No ``if mode == ...`` ladders anywhere above core.

What a backend needs is discoverable, not hard-coded per app:

* the host backends (``sequential``, ``threaded``, ``rounds``) need each
  task type's ``BatchSpec.run_one`` (plus ``run_batch`` for round
  batching);
* the ``engine`` backend additionally needs per-type device encoders
  (``BatchSpec.encode``, DESIGN.md §Engine) and family-level
  :class:`EngineHooks` (which megakernel interprets the rows, which state
  buffers it owns).  ``Backend.supports(plan, registry, engine)`` reports
  whether a lowered plan can run on a backend *before* running it, so
  callers can probe capability instead of guessing.

Capability flags instead of mode strings: ``needs_plan`` (the backend
executes a lowered ExecutionPlan), ``concurrent`` (task bodies run on
worker threads — shared state must be thread-mutable), ``device_resident``
(task bodies run inside a fused device kernel — state must be device
arrays).  Apps branch on these attributes, never on the mode name.
DESIGN.md §Backends.

Port note: a copy of ``repro.core.backends``.  ``repro_torch`` imports
nothing of ``repro`` (not even its jax-free modules), so it keeps its own
copy, with its own process-local registry: the device backend keeps the
mode name ``engine`` without touching ``repro``'s.  Changes: the
``engine`` backend runs ``repro_torch.engine`` (one CUDA walk launch per
write-colored phase), ``compiled_kernels`` probes for an sm_90 CUDA card,
and ``EngineHooks`` drops ``fuse_rounds``/``donate``, which have no
counterpart in eager PyTorch (the walk already launches phase by phase
over the whole plan, and the tile stack is updated in place).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

from .executors import SequentialExecutor, ThreadedExecutor
from .graph import FLAG_VIRTUAL, QSched
from .plan import BatchSpec, ExecutionPlan, lower


class BackendUnsupported(ValueError):
    """Raised when a backend cannot execute the given plan/registry."""


@dataclass(frozen=True)
class EngineHooks:
    """Family-level configuration the ``engine`` backend needs beyond the
    per-type ``BatchSpec.encode`` rows: which megakernel interprets the
    descriptor rows, which state rows each row touches, and which device
    buffers the kernel owns.

    ``row_access(row) -> (reads, writes)`` maps one descriptor row to the
    hashable state-row keys it loads from / stores to — the input to the
    write-coloring pass that splits each round into grid-parallel-safe
    sub-phases (``core.plan.color_phases``, DESIGN.md §Engine "Ragged
    tables & grid walk").  ``statics``/``buffers`` are zero-arg factories
    (called once per run) so hooks stay cheap to build — device stacking
    happens only when the engine actually executes.
    ``writeback(buffers)`` scatters the final device state back into the
    caller's host-side structures.
    """
    arg_width: int
    round_fn: Callable   # (desc, phase_bounds, statics, buffers) -> buffers
    statics: Callable[[], Tuple]
    buffers: Callable[[], Tuple]
    writeback: Callable[[Tuple], None]
    row_access: Optional[Callable] = None


def _plan_types(plan: ExecutionPlan, sched: QSched) -> Sequence[int]:
    """Task types with at least one non-virtual task in the plan."""
    flags = sched._tflags
    seen = []
    for rnd in plan.rounds:
        for tb in rnd.batches:
            if tb.ttype in seen:
                continue
            if any(not flags[t] & FLAG_VIRTUAL for t in tb.tids):
                seen.append(tb.ttype)
    return seen


class Backend:
    """Base execution backend.  Subclasses set the capability flags and
    implement ``run``; ``supports`` defaults to requiring a ``run_one``
    per non-virtual task type (every backend dispatches through the same
    BatchSpec registry)."""

    name: str = "?"
    needs_plan: bool = False      # run() consumes a lowered ExecutionPlan
    concurrent: bool = False      # task bodies run on worker threads
    device_resident: bool = False  # task bodies run inside a fused kernel

    def supports(self, plan: Optional[ExecutionPlan], sched: QSched,
                 registry: Mapping[int, BatchSpec],
                 engine: Optional[EngineHooks] = None) -> bool:
        if plan is None:
            return True
        return all(t in registry for t in _plan_types(plan, sched))

    def compiled_kernels(self) -> bool:
        """Capability probe: True when this backend executes its device
        kernels natively compiled for the local runtime (as opposed to
        host dispatch or Pallas interpret mode).  Callers use it to pick
        between a kernel-resident fast path and a jitted fallback — the
        serving tier selects its paged-attention decode path this way
        (DESIGN.md §Serving) — instead of sniffing platform names."""
        return False

    def run(self, sched: QSched, plan: Optional[ExecutionPlan],
            registry: Mapping[int, BatchSpec], *, nr_workers: int = 1,
            engine: Optional[EngineHooks] = None) -> None:
        raise NotImplementedError

    def check(self, plan, sched, registry, engine) -> None:
        if not self.supports(plan, sched, registry, engine):
            raise BackendUnsupported(
                f"backend {self.name!r} cannot execute this plan "
                f"(missing run_one/encode hooks or engine family hooks)")


class SequentialBackend(Backend):
    """One worker drains the scheduler in priority order, calling each
    type's ``run_one`` eagerly."""

    name = "sequential"

    def run(self, sched, plan, registry, *, nr_workers=1, engine=None):
        del plan, nr_workers, engine
        SequentialExecutor(sched).run_registry(registry)


class ThreadedBackend(Backend):
    """The paper's pthread-pool analogue: ``nr_workers`` threads pull from
    per-worker queues under the real lock protocol.  Shared state must
    tolerate concurrent task bodies (``concurrent=True``) — the resource
    locks are the only thing preventing lost updates."""

    name = "threaded"
    concurrent = True

    def run(self, sched, plan, registry, *, nr_workers=1, engine=None):
        del plan, engine
        ThreadedExecutor(sched, nr_workers).run_registry(registry)


class RoundsBackend(Backend):
    """Bulk-synchronous conflict-free rounds via ``ExecutionPlan.execute``:
    same-type groups within a round batch through ``run_batch`` (stack →
    one batched kernel launch → scatter), everything else through ``run_one``."""

    name = "rounds"
    needs_plan = True

    def run(self, sched, plan, registry, *, nr_workers=1, engine=None):
        del nr_workers, engine
        plan.execute(sched, registry)


class EngineBackend(Backend):
    """Device-resident execution (DESIGN.md §Engine): the plan lowers to
    descriptor task tables through the registry's ``encode`` hooks and the
    family's walk kernel runs them, one launch per write-colored phase on
    one stream."""

    name = "engine"
    needs_plan = True
    device_resident = True

    def supports(self, plan, sched, registry, engine=None):
        if engine is None or plan is None:
            return False
        return all(t in registry and registry[t].encode is not None
                   for t in _plan_types(plan, sched))

    def compiled_kernels(self) -> bool:
        # the port's walk kernels are built for sm_90a (Hopper); anywhere
        # else the engine runs its plain PyTorch walk on CPU tensors
        import torch
        return (torch.cuda.is_available()
                and torch.cuda.get_device_capability(0) == (9, 0))

    def run(self, sched, plan, registry, *, nr_workers=1, engine=None):
        del nr_workers
        # engine lives above core in the layer diagram; import lazily so
        # core carries no hard dependency on the kernel stack
        from repro_torch.engine import execute_plan, lower_tables
        tables = lower_tables(plan, sched, registry,
                              arg_width=engine.arg_width,
                              row_access=engine.row_access)
        out = execute_plan(tables, engine.round_fn, engine.statics(),
                           engine.buffers())
        engine.writeback(out)


_BACKENDS: Dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    """Register (or replace) a backend under its ``name``."""
    _BACKENDS[backend.name] = backend
    return backend


def get_backend(mode: str) -> Backend:
    try:
        return _BACKENDS[mode]
    except KeyError:
        raise ValueError(
            f"unknown execution backend {mode!r}; registered: "
            f"{sorted(_BACKENDS)}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


register_backend(SequentialBackend())
register_backend(ThreadedBackend())
register_backend(RoundsBackend())
register_backend(EngineBackend())


def run_plan(sched: QSched, registry: Mapping[int, BatchSpec],
             mode: str = "sequential", *, nr_workers: int = 1,
             nr_lanes: Optional[int] = None,
             engine: Optional[EngineHooks] = None,
             plan: Optional[ExecutionPlan] = None) -> Optional[ExecutionPlan]:
    """THE unified dispatch: look the backend up, lower the plan if the
    backend needs one (and none was passed), check capability, run.
    Returns the plan that was executed (None for plan-free backends) so
    callers can inspect rounds/stats."""
    backend = get_backend(mode)
    if backend.needs_plan and plan is None:
        plan = lower(sched, nr_lanes or max(nr_workers, 1))
    backend.check(plan, sched, registry, engine)
    backend.run(sched, plan, registry, nr_workers=nr_workers, engine=engine)
    return plan
