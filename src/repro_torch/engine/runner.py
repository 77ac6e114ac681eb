"""Device-resident plan execution: the port of ``repro/engine/runner.py``'s
``execute_plan``.

The reference ran a whole plan as one jitted XLA program (one host
dispatch, donated buffers, a jit cache per launch layout).  Eager PyTorch
has none of that machinery to carry over: ``execute_plan`` uploads
``desc`` to the device once per plan and calls the family walk once over
the whole plan, which launches its kernel on the current stream and
updates the state buffers in place.
The schedule is one of two:

* the write-colored phases (``Phases``: the host row offsets, and on a
  card the table they were uploaded with, ``upload_phases``).  The tiled
  QR walks them in ONE cooperative launch a plan: its blocks stride over
  each phase's rows and meet at a grid-wide barrier between phases, so
  the walk's time is the sum of each phase's slowest tile op and a
  barrier, and no phase waits on the host.  The pipeline walk still
  launches once per non-empty phase;
* launch groups (Barnes-Hut, ``descriptors.launch_groups``): ``desc`` is
  uploaded in the groups' walk order and the walk launches once per
  group, at most once per round.

The QR walk checks the table's range on the host copy its ``Phases``
carries, so it makes no device sync.  The walk kernel's own counter
(``kernels.*.kernel.LAUNCHES``) counts the launches where they happen.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

from .descriptors import LaunchGroups, TaskTable


class Phases(tuple):
    """The absolute row offsets of a table's phases (a tuple of host
    ints).  ``upload_phases`` records the table they were uploaded with:
    ``host_desc``, its host copy, and ``device_desc`` / ``device_offsets``,
    the int32 table and offsets on the card (views of the one uploaded
    buffer).  All three are None for phases made any other way."""

    host_desc: Optional[np.ndarray] = None
    device_desc: Optional[torch.Tensor] = None
    device_offsets: Optional[torch.Tensor] = None


def upload_phases(desc: np.ndarray, offsets: Iterable[int],
                  device) -> Tuple[torch.Tensor, Phases]:
    """``desc`` and the phase offsets in one host-to-device copy: the
    (items, width) int32 device table and the ``Phases`` that records it
    beside its host copy and the offsets' device copy."""
    desc = np.ascontiguousarray(desc, dtype=np.int32)
    phases = Phases(int(b) for b in offsets)
    packed = torch.from_numpy(np.concatenate(
        [desc.ravel(), np.asarray(phases, dtype=np.int32)])).to(device)
    phases.host_desc = desc
    phases.device_desc = packed[:desc.size].view(desc.shape)
    phases.device_offsets = packed[desc.size:]
    return phases.device_desc, phases


# (desc, schedule, statics, buffers) -> buffers; the schedule is the
# phases to walk, or the launch groups of a table whose desc was uploaded
# in their walk order
RoundFn = Callable[[torch.Tensor, Union[Phases, LaunchGroups],
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
        host = tables.desc
        schedule = Phases(int(b) for b in tables.phase_offsets)
    else:
        host = tables.desc[groups.order]
        schedule = groups
    if device.type == "cpu":
        desc = torch.as_tensor(host)
    elif groups is None:
        desc, schedule = upload_phases(host, schedule, device)
    else:
        desc = torch.as_tensor(host).to(device, non_blocking=False)
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
