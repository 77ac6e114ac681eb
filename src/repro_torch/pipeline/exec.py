"""Numerical executor for a synthesized pipeline schedule: the port of
``repro/pipeline/exec.py``.

Runs the (stage, microbatch) tasks in schedule order — forwards store VJP
closures, backwards propagate cotangents and accumulate per-stage gradients
*in whatever order the conflict resolution chose* (the accumulation is
order-independent, which is exactly why it is modelled as a QuickSched
conflict and not a dependency chain).  The result must equal
``torch.autograd`` of the unpipelined loss (tested, and held on the card).

Two entry points share the same task bodies (``_PipeRunner``, on
``torch.func.vjp`` where the reference used ``jax.vjp``):

* ``pipelined_value_and_grad``       — replays a discrete-event
  ``PipelineSchedule`` in global time order;
* ``pipelined_value_and_grad_plan``  — executes the shared ExecutionPlan
  lowering (``lower_pipeline_plan``) on any registered execution backend
  (``core.backends``).  ``rounds`` runs one conflict-free round per
  bulk-synchronous pipeline step on the host; ``sequential``/``threaded``
  drain the scheduler directly; ``engine`` lowers the F/B/U tasks to
  descriptor tables and runs the whole value-and-grad step as the K9 walk
  (``engine.pipe_round_fn``), one cooperative launch a plan over its
  write-colored phases (a grid barrier between them), over the
  stacked stage-activation and grad-accumulation slabs updated in place.
  The host modes run the stage products with ``torch.matmul``, as the
  reference's host modes run ``jax.vjp`` outside any Pallas kernel; only
  ``engine`` runs the hand-written walk.

The ``engine`` backend implements the *canonical uniform dense family*:
every stage is :func:`dense_stage` (``tanh(x @ w + b)``, square ``(D, D)``
weights), the loss is :func:`mse_loss`, and every microbatch is a
``(Bt, D)`` slab.  ``_engine_family`` discovers the capability from the
arguments — anything else raises :class:`~repro_torch.core.BackendUnsupported`
instead of silently computing the wrong family.

Both entry points take ``device`` (``cuda`` unless the caller asks for the
CPU; without a card they raise) and move the parameters and microbatches
there; ``pipeline.convert.pipeline_inputs`` turns the reference's numpy
inputs into the port's float32 tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import torch
from torch.func import vjp
from torch.utils._pytree import tree_map

from repro_torch import engine, resolve_device
from repro_torch.core import (BackendUnsupported, BatchSpec, EngineHooks,
                              get_backend, run_plan)

from .qsched_pipeline import B, F, U, PipelineSchedule, lower_pipeline_plan


def dense_stage(p, x):
    """The canonical uniform dense pipeline stage: ``tanh(x @ w + b)``.
    This is the stage family the engine walk implements in its kernel;
    passing it (by identity) is what makes a pipeline engine-eligible."""
    return torch.tanh(x @ p["w"] + p["b"])


def mse_loss(y, mb):
    """Canonical microbatch loss: ``mean((y - mb['y'])**2)``."""
    return torch.mean((y - mb["y"]) ** 2)


def _on(tree, device: torch.device):
    """``tree``'s leaves as tensors on ``device`` (no copy where they are
    there already)."""
    return tree_map(lambda v: torch.as_tensor(v, device=device), tree)


class _PipeRunner:
    """Holds pipeline state and executes F/B task bodies by (stage, micro)."""

    def __init__(self, stage_fns: Sequence[Callable], loss_fn: Callable,
                 stage_params: Sequence[Any], microbatches: Sequence[Any]):
        self.stage_fns = stage_fns
        self.loss_fn = loss_fn
        self.params = stage_params
        self.micro = microbatches
        self.S = len(stage_fns)
        self.M = len(microbatches)
        self.acts: Dict[Tuple[int, int], Any] = {}   # (stage, micro) -> input
        self.vjps: Dict[Tuple[int, int], Any] = {}
        self.cots: Dict[Tuple[int, int], Any] = {}   # cotangent flowing back
        self.grads: List[Any] = [tree_map(torch.zeros_like, p)
                                 for p in stage_params]
        self.losses: List[Any] = []

    def forward(self, k: int, m: int) -> None:
        x = self.micro[m]["x"] if k == 0 else self.acts[k, m]
        y, pull = vjp(self.stage_fns[k], self.params[k], x)
        self.vjps[k, m] = pull
        if k + 1 < self.S:
            self.acts[k + 1, m] = y
        else:
            loss, loss_pull = vjp(
                lambda yy: self.loss_fn(yy, self.micro[m]), y)
            self.losses.append(loss)
            self.cots[k, m] = loss_pull(torch.ones_like(loss))[0]

    def backward(self, k: int, m: int) -> None:
        # the closure is used once: dropping it frees the saved activations
        gp, gx = self.vjps.pop((k, m))(self.cots[k, m])
        # conflict-protected accumulation (any order)
        self.grads[k] = tree_map(torch.add, self.grads[k], gp)
        if k > 0:
            self.cots[k - 1, m] = gx

    def finish(self) -> Tuple[torch.Tensor, List[Any]]:
        loss = sum(self.losses) / self.M
        grads = [tree_map(lambda g: g / self.M, gk) for gk in self.grads]
        return loss, grads

    def registry(self) -> Mapping[int, BatchSpec]:
        """BatchSpecs for the F/B/U family: host bodies (``run_one``) plus
        the device descriptor encoders (``encode``) the engine backend
        lowers through.  Rows: [etype, stage, micro, in_slot, out_slot,
        first, last] — slots are flat stage·M + micro indices into the
        stacked activation/cotangent slabs; ``in_slot`` points at the
        previous stage's slab and degrades to the row's own (safe) slot on
        stage 0, where the walk reads ``x[m]`` instead."""
        S, M = self.S, self.M

        def enc_f(tid, d):
            _, k, m = d
            return [(engine.PIPE_F, k, m,
                     (k - 1) * M + m if k > 0 else k * M + m, k * M + m,
                     1 if k == 0 else 0, 1 if k == S - 1 else 0)]

        def enc_b(tid, d):
            _, k, m = d
            return [(engine.PIPE_B, k, m,
                     (k - 1) * M + m if k > 0 else k * M + m, k * M + m,
                     1 if k == 0 else 0, 0)]

        def enc_u(tid, d):
            return [(engine.PIPE_U, d[1], 0, 0, 0, 0, 0)]

        return {
            F: BatchSpec(run_one=lambda tid, d: self.forward(d[1], d[2]),
                         encode=enc_f),
            B: BatchSpec(run_one=lambda tid, d: self.backward(d[1], d[2]),
                         encode=enc_b),
            # U applies the optimizer — the CALLER's contract (see
            # pipelined_value_and_grad); on the host it is a no-op, in the
            # engine its rows perform the 1/M microbatch averaging.
            U: BatchSpec(run_one=lambda tid, d: None, encode=enc_u),
        }


def pipelined_value_and_grad(
        stage_fns: Sequence[Callable],
        loss_fn: Callable,
        stage_params: Sequence[Any],
        microbatches: Sequence[Any],
        schedule: PipelineSchedule,
        device=None,
) -> Tuple[torch.Tensor, List[Any]]:
    """stage_fns[k](params_k, x) -> y;  loss_fn(y_last, micro_batch) -> loss
    (mean-reduced over the microbatch).  Returns (total loss, grads per
    stage averaged over microbatches), on ``device``.

    Event-kind contract: ``"F"`` and ``"B"`` execute the forward/backward
    bodies; ``"U"`` (weight update) is a deliberate no-op here — this
    function computes value-and-grad only, and *applying* the returned
    gradients (optimizer step) is the caller's responsibility.  Any other
    event kind is a schedule-synthesis bug and raises ``ValueError``
    instead of being silently skipped."""
    S, M = schedule.n_stages, schedule.n_micro
    if len(stage_fns) != S or len(microbatches) != M:
        raise ValueError(f"{len(stage_fns)} stages and {len(microbatches)} "
                         f"microbatches for a ({S}, {M}) schedule")
    dev = resolve_device(device)
    runner = _PipeRunner(stage_fns, loss_fn, _on(list(stage_params), dev),
                         _on(list(microbatches), dev))

    # merge lanes into global time order (the schedule's interleaving)
    events = []
    for lane in schedule.lanes:
        events.extend(lane)
    events.sort(key=lambda e: (e[3], e[1]))

    for kind, k, m, t0, t1 in events:
        if kind == "F":
            runner.forward(k, m)
        elif kind == "B":
            runner.backward(k, m)
        elif kind != "U":
            raise ValueError(
                f"unknown pipeline event kind {kind!r} (expected F/B/U)")
    return runner.finish()


def _engine_family(stage_fns, loss_fn, stage_params, microbatches):
    """Return (S, M, Bt, D) when the canonical dense family applies —
    every stage IS ``dense_stage``, the loss IS ``mse_loss``, and all
    parameter/microbatch shapes are uniform — else None.  This is the
    capability probe behind the ``engine`` path."""
    if not stage_fns or not microbatches:
        return None
    if len(stage_params) != len(stage_fns):
        return None
    if any(f is not dense_stage for f in stage_fns) or loss_fn is not mse_loss:
        return None
    try:
        pshapes = [(tuple(p["w"].shape), tuple(p["b"].shape))
                   for p in stage_params]
        mshapes = [(tuple(mb["x"].shape), tuple(mb["y"].shape))
                   for mb in microbatches]
    except (TypeError, KeyError, AttributeError):
        return None
    dim = pshapes[0][0][-1]
    if any(w != (dim, dim) or b != (dim,) for w, b in pshapes):
        return None
    bt = mshapes[0][0][0]
    if any(x != (bt, dim) or y != (bt, dim) for x, y in mshapes):
        return None
    return len(stage_fns), len(microbatches), bt, dim


def _engine_hooks(stage_params, microbatches, fam, out_box,
                  device: torch.device) -> EngineHooks:
    """EngineHooks for the canonical dense pipeline family: stack the
    stage parameters and microbatches as float32 statics on ``device``,
    allocate the walk's activation/cotangent/grad/loss slabs, and on
    writeback deliver ``(loss, grads)`` — the U rows already applied the
    1/M averaging, so writeback only sums the per-micro losses."""
    S, M, bt, dim = fam

    def stack(trees, key):
        return torch.stack([torch.as_tensor(t[key], device=device)
                            for t in trees]).float().contiguous()

    def statics():
        return (stack(stage_params, "w"), stack(stage_params, "b"),
                stack(microbatches, "x"), stack(microbatches, "y"))

    def buffers():
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return (zeros(S * M, bt, dim), zeros(S * M, bt, dim),
                zeros(S, dim, dim), zeros(S, dim), zeros(M, 1))

    def writeback(out):
        _acts, _cots, gw, gb, loss = out
        out_box["loss"] = loss.sum() / M
        out_box["grads"] = [{"w": gw[k], "b": gb[k]} for k in range(S)]

    return EngineHooks(
        arg_width=engine.PIPE_ARG_WIDTH,
        round_fn=engine.pipe_round_fn(1.0 / M), statics=statics,
        buffers=buffers, writeback=writeback,
        row_access=engine.pipe_row_access)


def pipelined_value_and_grad_plan(
        stage_fns: Sequence[Callable],
        loss_fn: Callable,
        stage_params: Sequence[Any],
        microbatches: Sequence[Any],
        fwd_cost: float = 1.0,
        bwd_cost: float = 2.0,
        upd_cost: float = 0.5,
        per_stage_window: bool = True,
        mode: str = "rounds",
        device=None,
) -> Tuple[torch.Tensor, List[Any]]:
    """Same computation, driven by the shared ExecutionPlan lowering on
    any registered execution backend (``mode``) on ``device``.
    ``rounds``: each plan round is one bulk-synchronous pipeline step.
    ``engine``: the whole value-and-grad step is the K9 walk over the
    lowered table (canonical dense family only — see module docstring);
    gradients and the microbatch-averaged loss come back from the walk's
    grad slabs."""
    dev = resolve_device(device)
    stage_params = _on(list(stage_params), dev)
    microbatches = _on(list(microbatches), dev)
    runner = _PipeRunner(stage_fns, loss_fn, stage_params, microbatches)
    sched, _meta, plan = lower_pipeline_plan(
        runner.S, runner.M, fwd_cost, bwd_cost, upd_cost,
        per_stage_window=per_stage_window)
    registry = runner.registry()
    if get_backend(mode).device_resident:
        fam = _engine_family(stage_fns, loss_fn, stage_params, microbatches)
        if fam is None:
            raise BackendUnsupported(
                "the engine backend implements the canonical dense pipeline "
                "family only: dense_stage stages, mse_loss loss, uniform "
                "(Bt, D) microbatches and (D, D) stage weights")
        box: Dict[str, Any] = {}
        run_plan(sched, registry, mode, nr_workers=runner.S,
                 engine=_engine_hooks(stage_params, microbatches, fam, box,
                                      dev),
                 plan=plan)
        return box["loss"], box["grads"]
    run_plan(sched, registry, mode, nr_workers=runner.S, plan=plan)
    return runner.finish()
