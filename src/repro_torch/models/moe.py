"""Mixture-of-Experts layer: top-k routing with capacity-bounded sort-based
dispatch plus always-on shared experts (DeepSeek-V3 / Kimi-K2 style).  The
port of ``repro/models/moe.py``.

Compute scales with E·C ≈ T·topk·capacity_factor — i.e. with *active*
experts only.  Tokens past an expert's capacity C are dropped exactly as in
the reference: the entries are sorted stably by expert, and an entry whose
rank within its expert is C or more contributes nothing.

Changes from the reference:

* no ``constrain``: the reference imports it here and calls it nowhere
  (constraining the dispatch buffers did not pay off there);
* no host sync in the dispatch — no boolean-mask indexing, ``nonzero`` or
  ``.item()``: a dropped entry is routed to a spare row of the dispatch
  buffer that no expert reads;
* a combine that is deterministic on the card: the reference scatter-adds
  each entry into its token (``.at[tok].add``), which on the card means
  atomics in a varying order.  Every token has exactly k entries, so they
  go back to a ``(T, k, d)`` buffer by the inverse of the sort and are
  summed over k.

On DTensors (``dist``) the routing, dispatch and combine run whole on
every device (``dist.act_sharding.on_shards`` with every input
replicated: the capacity and the sort are over all T tokens, as the
reference's are), and the expert products are DTensor products over the
experts' own placements.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.act_sharding import batched_linear, on_shards
from repro_torch.dist.sharding import reshape

from .layers import dense_init, mlp, mlp_init, torch_dtype

Params = Dict[str, object]


def moe_init(gen: torch.Generator, cfg, lead: Tuple[int, ...] = ()) -> Params:
    """Router float32 ``(d, E)``; experts ``w_gate``, ``w_up`` ``(E, d, f)``
    and ``w_down`` ``(E, f, d)`` in ``cfg.dtype``; the shared experts as one
    MLP of width ``f · n_shared``.  ``lead`` stacks every leaf."""
    d, f, e, dt = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, torch_dtype(cfg)
    p = {
        "router": dense_init(gen, lead + (d, e), torch.float32),
        "w_gate": dense_init(gen, lead + (e, d, f), dt),
        "w_up": dense_init(gen, lead + (e, d, f), dt),
        "w_down": dense_init(gen, lead + (e, f, d), dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, f * cfg.n_shared_experts, dt, lead)
    return p


def _capacity(t: int, k: int, e: int, factor: float) -> int:
    c = int(t * k * factor / e) + 1
    c = max(4, min(c, t))
    if c > 256:
        c = -(-c // 256) * 256   # round up, as the reference does
    return c


def _route(p: Params, cfg, xt: torch.Tensor):
    """float32 router → (probs (T,E), renormalised gates (T,k), experts
    (T,k))."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    gate_vals, idx = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, idx


def moe_apply(p: Params, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) → (out (B,S,d), aux load-balance loss scalar)."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_tok, cfg.n_experts
    c = _capacity(t, k, e, cfg.capacity_factor)
    xt = reshape(x, t, d)
    whole = (None, None)
    buf, slot, keep, order, gate_vals, aux = on_shards(
        functools.partial(_dispatch, cfg=cfg, c=c), (xt, p["router"]),
        (whole, whole), (whole, (None,), (None,), (None,), whole, ()), {})
    buf = buf[:e * c].view(e, c, d)

    # --- expert compute (E,C,d) @ (E,d,f) -----------------------------------
    h = (F.silu(batched_linear(buf, p["w_gate"]))
         * batched_linear(buf, p["w_up"]))
    y = reshape(batched_linear(h, p["w_down"]), e * c, d)      # (E*C, d)

    out = on_shards(functools.partial(_combine, k=k, dtype=x.dtype),
                    (y, slot, keep, order, gate_vals),
                    (whole, (None,), (None,), (None,), whole), whole, {})
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xt)
    return reshape(out, b, s, d), aux


def _dispatch(xt: torch.Tensor, router: torch.Tensor, cfg, c: int):
    """The routing, the aux loss and the sort-based capacity dispatch of
    all T tokens: (buf (E·C+1, d), slot, keep, order (T·k,), gates (T,k),
    aux)."""
    t, d = xt.shape
    k, e = cfg.experts_per_tok, cfg.n_experts
    dev = xt.device
    probs, gate_vals, idx = _route({"router": router}, cfg, xt)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = (idx[:, :1] == torch.arange(e, device=dev)).float().mean(dim=0)
    aux = e * (me * ce).sum()

    # --- sort-based capacity dispatch -------------------------------------
    flat_e = idx.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)                 # by expert
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    rank = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = rank < c
    tok = order // k                                           # source token
    # row e·C + rank of the flat buffer; a dropped entry goes to the spare
    # row e·C, which no expert reads
    slot = torch.where(keep, sorted_e * c + rank,
                       torch.full_like(rank, e * c))
    buf = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=dev)
    buf[slot] = xt[tok]
    return buf, slot, keep, order, gate_vals, aux


def _combine(y, slot, keep, order, gate_vals, k: int,
             dtype: torch.dtype) -> torch.Tensor:
    """Each entry back to its (token, k) place, weighted by its gate and
    summed over k: (T, d)."""
    gath = y[torch.where(keep, slot, torch.zeros_like(slot))]
    gath = torch.where(keep[:, None], gath, torch.zeros((), dtype=y.dtype,
                                                        device=y.device))
    gsort = gate_vals.reshape(-1)[order]
    contrib = gath.float() * gsort[:, None]
    per_tok = torch.empty_like(contrib)
    per_tok[order] = contrib
    return per_tok.view(-1, k, contrib.shape[-1]).sum(dim=1).to(dtype)


def moe_apply_dense_ref(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Oracle: every expert on every token, masked by the top-k gates — the
    capacity-free semantics the dispatch must match when nothing is dropped
    (tests only)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    _, gate_vals, idx = _route(p, cfg, xt)
    gates = torch.zeros((t, cfg.n_experts), dtype=torch.float32,
                        device=x.device).scatter_(1, idx, gate_vals)
    h = (F.silu(torch.einsum("td,edf->tef", xt, p["w_gate"]))
         * torch.einsum("td,edf->tef", xt, p["w_up"]))
    y = torch.einsum("tef,efd->ted", h, p["w_down"])
    out = torch.einsum("ted,te->td", y.float(), gates).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xt)
    return out.reshape(b, s, d)
