"""Step builders: train / prefill / decode.  The port of
``repro/trainer/steps.py``.

``make_train_step`` closes over the optimizer; the returned function has
signature ``(params, opt_state, batch) -> (params, opt_state, metrics)``:
the loss and its gradients (``loss_and_grads``, ``torch.autograd.grad``
over every parameter leaf), the clip by global norm, then the optimizer.
The reference's jitted step donates ``(params, opt_state)``; the port's
updates them in place and returns the same trees, and drops the
gradients once the update is done.  Metrics are 0-d tensors on the
parameters' device (reading one synchronises).

Every step also runs on DTensors (the trees placed with
``dist.sharding``): each runs under DTensor's implicit replication, so a
plain tensor the model makes on the way (positions, masks) counts as
replicated over the mesh.  On plain tensors that changes nothing.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
# Imported here, before any model exists: torch.utils.checkpoint imports it
# at its first call, and that import leaves a reference cycle through the
# calling frames, so the first training step's tensors (a whole model at
# full width) would stay on the card until the cycle collector ran.
import torch._dynamo  # noqa: F401
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import lm, serving
from repro_torch.optim import (clip_by_global_norm, cosine_schedule,
                               default_optimizer_for, make_optimizer)
from repro_torch.optim.tree import leaves, unflatten_like

Pytree = Any


def loss_and_grads(params: Pytree, cfg, batch: Dict[str, torch.Tensor]):
    """``(loss, metrics, grads)``: the port's ``jax.value_and_grad(
    lm.loss_fn, has_aux=True)``.  ``grads`` has ``params``' structure and
    dtypes; ``params`` come back as they went in (no ``requires_grad``)."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        with implicit_replication():
            loss, metrics = lm.loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, flat)
            # a DTensor gradient may come back a pending (partial) sum or in
            # another layout: reduce it into its parameter's layout
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if isinstance(g, DTensor) else g
                     for g, p in zip(grads, flat)]
    finally:
        for p in flat:
            p.requires_grad_(False)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten_like(params, list(grads))


def make_train_step(cfg, optimizer: str = "auto", lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000,
                    grad_clip: float = 1.0):
    """Returns (train_step, opt_init).  ``train_step(..., mark=f)`` calls
    ``f("grads")``, ``f("clip")`` and ``f("update")`` as each part is
    issued (a timer's hook; nothing is synchronised)."""
    if optimizer == "auto":
        optimizer = default_optimizer_for(cfg)
    sched = cosine_schedule(lr, warmup, total_steps)
    opt_init, opt_update = make_optimizer(optimizer, sched)

    def train_step(params: Pytree, opt_state, batch: Dict[str, torch.Tensor],
                   mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda _: None)
        with implicit_replication():
            loss, metrics, grads = loss_and_grads(params, cfg, batch)
            mark("grads")
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            mark("clip")
            params, opt_state = opt_update(grads, opt_state, params)
            del grads
            mark("update")
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step, opt_init


def make_prefill_step(cfg):
    """``prefill_step(params, batch)``: the batch's tokens and, as
    ``extra``, every other entry (the modality inputs)."""

    def prefill_step(params, batch):
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        with implicit_replication():
            logits, cache, pos = serving.prefill(params, cfg, batch["tokens"],
                                                 extra=extra)
        return logits, cache, pos

    return prefill_step


def make_serve_step(cfg):
    """One-token decode; the cache is updated in place."""

    def serve_step(params, cache, tokens, pos):
        with implicit_replication():
            logits, cache = serving.decode_step(params, cfg, cache, tokens,
                                                pos)
        return logits, cache

    return serve_step


def init_train_state(cfg, gen: torch.Generator, optimizer: str = "auto"):
    """Parameters drawn with ``gen`` on its device, and their optimizer
    state."""
    if optimizer == "auto":
        optimizer = default_optimizer_for(cfg)
    opt_init, _ = make_optimizer(optimizer, 1e-4)
    params = lm.init_params(gen, cfg)
    return params, opt_init(params)
