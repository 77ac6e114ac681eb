"""LM assembly for the dense, MoE and SSM families: init / forward /
logits / loss.  The port of ``repro/models/lm.py``'s dense, MoE and SSM
parts.

Layer stacks keep the reference's parameter-stacked layout (a leading L
axis on every leaf of ``params["layers"]``, or of ``params["dense_layers"]``
and ``params["moe_layers"]`` for the MoE family); the reference's
``lax.scan`` over them (``models/scan_util.py``) is a Python loop over
:func:`layers_of`, whose layers are ``unbind`` views of each stack, so
the backward pass stacks a leaf's per-layer gradients once.  Attention is
GQA or, where ``cfg.mla``, MLA (``mla.py``); the FFN is the SwiGLU MLP or,
on MoE layers, ``moe.py``.  An SSM layer (falcon-mamba) is ``h +
mamba1_apply(norm(h))`` (``ssm.py``), its stack ``{"norm", "mamba"}`` under
``params["layers"]``.  With ``cfg.remat`` and gradients enabled each
block runs under ``torch.utils.checkpoint`` (the reference's per-layer
``jax.checkpoint``): only its input is kept, and the backward pass runs
it again; serving (no gradients) never pays for it.  ``init_params`` draws
every weight with the caller's ``torch.Generator``, on the generator's
device and in ``cfg.dtype``, so a full-width model is never built on the
host and copied.

Other families (hybrid, enc-dec, VLM) raise a ``ValueError`` naming the
slice that brings them (:func:`check_family`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (attention, attention_init, dense_init, mlp, mlp_init,
                     rmsnorm, rmsnorm_init, torch_dtype)

Params = Dict[str, object]

FAMILIES = ("dense", "moe", "ssm")
# the ROADMAP slice that ports each family the port does not run yet
LATER_SLICES = {
    "hybrid": "the hybrid/enc-dec/VLM model slice",
    "encdec": "the hybrid/enc-dec/VLM model slice",
    "vlm": "the hybrid/enc-dec/VLM model slice",
}


def check_family(cfg, what: str) -> None:
    """Raise unless ``cfg`` is of a family the port runs (dense, MoE with
    GQA or MLA attention, or SSM), naming the slice that ports it."""
    if cfg.family not in FAMILIES:
        later = LATER_SLICES.get(cfg.family, "a later slice")
        raise ValueError(
            f"{what}: the port runs the families {FAMILIES}; {cfg.name!r} "
            f"is {cfg.family!r}, which comes with {later} (ROADMAP.md, "
            f"Queue 1)")


def _unbind(stack: Params) -> List[Params]:
    """Every layer of a parameter-stacked tree, as views: one ``unbind``
    a leaf, whose backward stacks the layers' gradients in one pass."""
    per_key = {k: (_unbind(v) if isinstance(v, dict) else v.unbind(0))
               for k, v in stack.items()}
    n = len(next(iter(per_key.values())))
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def layers_of(params: Params) -> List[Tuple[Params, bool]]:
    """``(layer params, is_moe)`` for every layer in order: the dense (or
    SSM) stack, or the MoE family's leading dense layers then its MoE
    layers."""
    out = []
    for key, is_moe in (("layers", False), ("dense_layers", False),
                        ("moe_layers", True)):
        if key in params:
            out += [(lp, is_moe) for lp in _unbind(params[key])]
    return out


# =============================================================================
# init
# =============================================================================

def _attn_init(gen: torch.Generator, cfg, lead: Tuple[int, ...]) -> Params:
    return (mla_mod.mla_init(gen, cfg, lead) if cfg.mla
            else attention_init(gen, cfg, lead))


def _layer_stack_init(gen: torch.Generator, cfg, n: int,
                      moe: bool) -> Params:
    d, dev, lead = cfg.d_model, gen.device, (n,)
    p = {"attn_norm": rmsnorm_init(d, lead, dev),
         "attn": _attn_init(gen, cfg, lead),
         "mlp_norm": rmsnorm_init(d, lead, dev)}
    if moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, lead)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, torch_dtype(cfg), lead)
    return p


def _ssm_layer_init(gen: torch.Generator, cfg, n: int) -> Params:
    return {"norm": rmsnorm_init(cfg.d_model, (n,), gen.device),
            "mamba": ssm_mod.mamba1_init(gen, cfg, (n,))}


def init_params(gen: torch.Generator, cfg) -> Params:
    """Random weights for ``cfg`` on ``gen``'s device, in ``cfg.dtype``
    (norm scales and the MoE router float32), in the reference's layout.
    The draws differ from the reference's ``jax.random`` ones; a test that
    compares the two converts the reference's parameters instead
    (``models.convert``)."""
    check_family(cfg, "init_params")
    dt, d, dev = torch_dtype(cfg), cfg.d_model, gen.device
    embed = {"tok": torch.randn((cfg.vocab, d), generator=gen, device=dev,
                                dtype=torch.float32).mul_(d ** -0.5).to(dt)}
    if not cfg.tie_embeddings:
        embed["head"] = dense_init(gen, (d, cfg.vocab), dt)
    p = {"embed": embed, "final_norm": rmsnorm_init(d, (), dev)}
    if cfg.family == "dense":
        p["layers"] = _layer_stack_init(gen, cfg, cfg.n_layers, moe=False)
    elif cfg.family == "ssm":
        p["layers"] = _ssm_layer_init(gen, cfg, cfg.n_layers)
    else:
        nd = cfg.first_dense_layers
        if nd:
            p["dense_layers"] = _layer_stack_init(gen, cfg, nd, moe=False)
        p["moe_layers"] = _layer_stack_init(gen, cfg, cfg.n_layers - nd,
                                            moe=True)
    return p


# =============================================================================
# forward
# =============================================================================

def attend(p: Params, cfg, hn: torch.Tensor, positions: torch.Tensor,
           return_cache: bool = False):
    """Pre-normed causal self-attention of one layer, GQA or MLA; with
    ``return_cache`` also its cache entries (``{k, v}`` or ``{c_kv,
    k_rope}``, the layout of ``serving.init_cache``)."""
    if cfg.mla:
        a, (c_kv, k_rope) = mla_mod.mla_attention(p, cfg, hn, positions,
                                                  return_latent=True)
        kv = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        a, (k, v) = attention(p, cfg, hn, positions, return_kv=True)
        kv = {"k": k, "v": v}
    return (a, kv) if return_cache else a


def ffn(p: Params, cfg, hn: torch.Tensor,
        is_moe: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The SwiGLU MLP or, on a MoE layer, the experts: (out, the MoE aux
    loss, None on a dense layer)."""
    if is_moe:
        return moe_mod.moe_apply(p["moe"], cfg, hn)
    return mlp(p["mlp"], hn), None


def _block(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
           is_moe: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    x = x + attend(p["attn"], cfg, rmsnorm(p["attn_norm"], x, cfg.norm_eps),
                   positions)
    y, aux = ffn(p, cfg, rmsnorm(p["mlp_norm"], x, cfg.norm_eps), is_moe)
    return x + y, aux


def _ssm_block(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    return x + ssm_mod.mamba1_apply(p["mamba"], cfg,
                                    rmsnorm(p["norm"], x, cfg.norm_eps))


def forward(params: Params, cfg,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) → (hidden (B,S,d), the MoE layers' summed aux loss)."""
    check_family(cfg, "forward")
    x = params["embed"]["tok"][tokens.long()]
    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2])
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp, is_moe in layers_of(params):
        if cfg.family == "ssm":
            x = (checkpoint(_ssm_block, lp, cfg, x, use_reentrant=False)
                 if remat else _ssm_block(lp, cfg, x))
            continue
        if remat:
            x, a = checkpoint(_block, lp, cfg, x, positions, is_moe,
                              use_reentrant=False)
        else:
            x, a = _block(lp, cfg, x, positions, is_moe)
        if a is not None:
            aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def logits_fn(params: Params, cfg, hidden: torch.Tensor) -> torch.Tensor:
    head = (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["embed"]["head"])
    return hidden @ head


def loss_fn(params: Params, cfg, batch: Dict[str, torch.Tensor],
            aux_coef: float = 0.01) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (+ MoE aux, + z-loss).  batch: tokens (B,S),
    loss_mask (B,S) optional.  The logits are computed in ``cfg.dtype`` and
    then cast to float32, as the reference's."""
    check_family(cfg, "loss_fn")
    tokens = batch["tokens"]
    hidden, aux = forward(params, cfg, tokens)
    logits = logits_fn(params, cfg, hidden).float()
    targets = torch.roll(tokens.long(), -1, dims=1)
    ones = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask = batch.get("loss_mask", ones)
    last = torch.cat([ones[:, :-1], torch.zeros_like(ones[:, :1])], dim=1)
    mask = mask * last
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (lse - tgt) * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    ce = torch.sum(nll) / denom
    z_loss = 1e-4 * torch.sum((lse * mask) ** 2) / denom
    loss = ce + aux_coef * aux + z_loss
    return loss, {"ce": ce, "aux": aux, "z": z_loss, "ntok": torch.sum(mask)}
