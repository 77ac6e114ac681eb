"""Device-resident plan execution: the port of ``repro/engine/runner.py``'s
``execute_plan``.

The reference ran a whole plan as one jitted XLA program (one host
dispatch, donated buffers, a jit cache per launch layout).  Eager PyTorch
has none of that machinery to carry over: ``execute_plan`` uploads the
table's ``desc`` to the device once per plan, keeps the walk's schedule on
the host, and calls the family walk once over the whole plan, which
launches its kernel on the current stream and updates the state buffers
in place.  The schedule is one of two:

* the write-colored phases (tiled QR): one launch per non-empty phase,
  so launches per plan are at most ``tables.nr_phases``;
* launch groups (Barnes-Hut, ``descriptors.launch_groups``): ``desc`` is
  uploaded in the groups' walk order and the walk launches once per
  group, at most once per round.

The walk kernel's own counter (``kernels.*.kernel.LAUNCHES``) counts the
launches where they happen.  Capturing the launches in a CUDA graph, or a
persistent walk with a device-side barrier, is later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from .descriptors import LaunchGroups, TaskTable

# (desc, schedule, statics, buffers) -> buffers; the schedule is the
# host-side absolute row offsets of the phases to walk, or the launch
# groups of a table whose desc was uploaded in their walk order
RoundFn = Callable[[torch.Tensor, Union[Tuple[int, ...], LaunchGroups],
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
        desc = tables.desc
        schedule = tuple(int(b) for b in tables.phase_offsets)
    else:
        desc = tables.desc[groups.order]
        schedule = groups
    desc = torch.as_tensor(desc)
    if device.type != "cpu":
        desc = desc.to(device, non_blocking=False)
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
