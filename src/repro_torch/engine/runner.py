"""Device-resident plan execution: the port of ``repro/engine/runner.py``'s
``execute_plan``.

The reference ran a whole plan as one jitted XLA program (one host
dispatch, donated buffers, a jit cache per launch layout).  Eager PyTorch
has none of that machinery to carry over: ``execute_plan`` uploads the
table's ``desc`` to the device once per plan, keeps the phase bounds on
the host, and calls the family walk once over the whole plan, which
launches one kernel per write-colored phase on the current stream and
updates the state buffers in place.  Launches per plan are therefore at
most ``tables.nr_phases`` (one per non-empty phase), not one; the walk
kernel's own counter (``kernels.qr_tile.kernel.LAUNCHES``) counts them
where they happen.  Capturing the
phase launches in a CUDA graph, or a persistent walk with a device-side
barrier per phase, is later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from .descriptors import TaskTable

# (desc, phase_bounds, statics, buffers) -> buffers; phase_bounds are the
# host-side absolute row offsets of the phases to walk
RoundFn = Callable[[torch.Tensor, Tuple[int, ...], Tuple, Tuple], Tuple]


def execute_plan(tables: TaskTable, round_fn: RoundFn,
                 statics: Sequence, buffers: Sequence) -> Tuple:
    """Execute a lowered task table.  ``statics`` are read-only family
    inputs (may be empty); ``buffers`` are the mutable state tensors,
    updated in place and returned.  The device is the buffers' device."""
    statics = tuple(statics)
    buffers = tuple(buffers)
    if tables.nr_items == 0:
        return buffers
    device = buffers[0].device
    desc = torch.as_tensor(tables.desc)
    if device.type != "cpu":
        desc = desc.to(device, non_blocking=False)
    bounds = tuple(int(b) for b in tables.phase_offsets)
    reg = _metrics.get_registry()
    reg.counter("engine.plans_executed").inc()
    reg.counter("engine.items_walked").inc(tables.nr_items)
    tr = _trace.get_tracer()
    if not tr.enabled:
        return round_fn(desc, bounds, statics, buffers)
    # execute span: tracing synchronizes the device so the span covers
    # execution, not just the enqueue — an observer cost paid only when a
    # tracer is installed
    t0 = _trace.now()
    out = round_fn(desc, bounds, statics, buffers)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tr.event_span("engine.execute", t0, _trace.now(), lane="engine",
                  items=tables.nr_items, rounds=tables.nr_rounds,
                  phases=tables.nr_phases)
    return out
