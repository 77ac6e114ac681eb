"""Optimizers (no external deps): AdamW and Adafactor over trees of
tensors.  The port of ``repro/optim/optimizers.py``.

Adafactor (factored second moment) is selected automatically for the
≥600 B-parameter MoEs: full Adam moments for a 1 T-param model are 8 TB of
fp32, while factored moments are ~O(rows+cols).

The reference's leaf semantics hold on the stacked layout: a leaf is a
whole ``(L, ...)`` stack, so Adafactor factors the last two axes of every
leaf with ``ndim >= 2`` (a ``(L, d)`` stack of norm scales too) and takes
its update RMS over the whole stack.  Precision is the reference's: the
moments are float32, the parameters stay in their own dtype (the update is
computed in float32 and cast back, no master copy), the step counter is
int32 and ``lr(step)`` and the bias corrections are float32 functions of
``step + 1``, computed on the step counter's device.

Changes from the reference: the updates work in place.  JAX donates
``(params, opt_state)`` to the jitted step; here ``adamw_update`` and
``adafactor_update`` write the new parameters and moments into the
tensors they were given (under ``torch.no_grad``) and return the same
trees, so a full-width step holds no second copy of either;
``clip_by_global_norm`` scales the gradients in place.  Each in-place
operation rounds as the reference's out-of-place expression does.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from .tree import leaves, tree_map

Pytree = Any


class OptState(NamedTuple):
    step: torch.Tensor          # int32, 0-d, on the parameters' device
    inner: Pytree


def _device(params: Pytree) -> torch.device:
    flat = leaves(params)
    return flat[0].device if flat else torch.device("cpu")


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# --- utils --------------------------------------------------------------------

def global_norm(tree: Pytree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def clip_by_global_norm(grads: Pytree, max_norm: float
                        ) -> Tuple[Pytree, torch.Tensor]:
    """Scales ``grads`` in place by ``min(1, max_norm / norm)``; returns
    them with the norm before the scaling."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def _lr_at(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def _write_back(p: torch.Tensor, p32: torch.Tensor, u: torch.Tensor,
                lr_t) -> None:
    """``p ← (p32 − lr_t·u)`` in ``p``'s dtype; ``u`` is scratch."""
    u.mul_(lr_t)
    if p.dtype == torch.float32:
        p.sub_(u)                      # p32 is p itself
    else:
        p.copy_(p32.sub_(u))           # p32 is a float32 copy


# --- AdamW -----------------------------------------------------------------------

def adamw_init(params: Pytree) -> OptState:
    return OptState(torch.zeros((), dtype=torch.int32,
                                device=_device(params)),
                    {"m": tree_map(_zeros_f32, params),
                     "v": tree_map(_zeros_f32, params)})


@torch.no_grad()
def adamw_update(grads: Pytree, state: OptState, params: Pytree,
                 lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, wd: float = 0.1) -> Tuple[Pytree, OptState]:
    step = state.step + 1
    lr_t = _lr_at(lr, step)
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    flat_p = leaves(params)
    for g, m, v, p in zip(leaves(grads), leaves(state.inner["m"]),
                          leaves(state.inner["v"]), flat_p, strict=True):
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))                  # b1·m + (1−b1)·g
        v.mul_(b2).add_(g * (1 - b2) * g)              # b2·v + (1−b2)·g·g
        u = m / bc1
        u.div_((v / bc2).sqrt_().add_(eps))            # (m/bc1)/(√(v/bc2)+ε)
        p32 = p.float()
        u.add_(wd * p32)
        _write_back(p, p32, u, lr_t)
    return params, OptState(step, state.inner)


# --- Adafactor -----------------------------------------------------------------------

def adafactor_init(params: Pytree) -> OptState:
    def init_leaf(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": _zeros_f32(p)}
    return OptState(torch.zeros((), dtype=torch.int32,
                                device=_device(params)),
                    _map_params(init_leaf, params))


def _map_params(fn, params):
    """``fn`` over the parameter leaves, where a result may be a dict (so
    the moment tree has one more level than ``params``)."""
    if isinstance(params, dict):
        return {k: _map_params(fn, v) for k, v in params.items()}
    return fn(params)


def _moment_leaves(inner, params, out=None):
    """Each parameter's moment dict, in ``leaves(params)`` order."""
    out = [] if out is None else out
    if isinstance(params, dict):
        for k in sorted(params):
            _moment_leaves(inner[k], params[k], out)
    else:
        out.append(inner)
    return out


@torch.no_grad()
def adafactor_update(grads: Pytree, state: OptState, params: Pytree,
                     lr, decay: float = 0.99, eps: float = 1e-30,
                     clip_thresh: float = 1.0, wd: float = 0.0
                     ) -> Tuple[Pytree, OptState]:
    step = state.step + 1
    lr_t = _lr_at(lr, step)
    for g, s, p in zip(leaves(grads), _moment_leaves(state.inner, params),
                       leaves(params), strict=True):
        g = g.float()
        g2 = (g * g).add_(eps)
        if p.dim() >= 2:
            vr, vc = s["vr"], s["vc"]
            vr.mul_(decay).add_(torch.mean(g2, dim=-1) * (1 - decay))
            vc.mul_(decay).add_(torch.mean(g2, dim=-2) * (1 - decay))
            del g2
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=eps)
            v_hat = (vr[..., None] * vc[..., None, :]).div_(denom[..., None])
            u = g * torch.rsqrt(v_hat.clamp_(min=eps))
            del v_hat
        else:
            v = s["v"]
            v.mul_(decay).add_(g2 * (1 - decay))
            del g2
            u = g * torch.rsqrt(torch.clamp(v, min=eps))
        # update clipping (RMS-based)
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u.div_(torch.clamp(rms / clip_thresh, min=1.0))
        p32 = p.float()
        u.add_(wd * p32)
        _write_back(p, p32, u, lr_t)
    return params, OptState(step, state.inner)


# --- factory -----------------------------------------------------------------------

def make_optimizer(name: str, lr, **kw):
    """Returns (init_fn, update_fn(grads, state, params) -> (params, state))."""
    if name == "adamw":
        return adamw_init, functools.partial(adamw_update, lr=lr, **kw)
    if name == "adafactor":
        return adafactor_init, functools.partial(adafactor_update, lr=lr, **kw)
    raise ValueError(name)


def default_optimizer_for(cfg) -> str:
    """Adafactor for the ≥600B MoEs (memory fit), AdamW else."""
    return "adafactor" if cfg.param_count() > 3e11 else "adamw"
