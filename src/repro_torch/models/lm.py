"""LM assembly for the dense family: init / forward / logits.  The port of
``repro/models/lm.py``'s dense parts.

Layer stacks keep the reference's parameter-stacked layout (a leading L
axis on every leaf of ``params["layers"]``); the reference's ``lax.scan``
over them (``models/scan_util.py``) is a Python loop over
:func:`layer_params` here.  No remat: the port serves, it does not train
yet.  ``init_params`` draws every weight with the caller's
``torch.Generator``, on the generator's device and in ``cfg.dtype``, so a
full-width model is never built on the host and copied.

Other families (MoE and MLA, SSM, hybrid, enc-dec, VLM) raise a
``ValueError`` naming the slice that brings them (:func:`check_family`);
they never run the dense code.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .layers import (attention, attention_init, dense_init, mlp, mlp_init,
                     rmsnorm, rmsnorm_init, torch_dtype)

Params = Dict[str, object]

# the ROADMAP slice that ports each family the port does not run yet
LATER_SLICES = {
    "moe": "the MoE+MLA serving slice (with K11)",
    "mla": "the MoE+MLA serving slice (with K11)",
    "ssm": "the SSM/hybrid/enc-dec/VLM model slice",
    "hybrid": "the SSM/hybrid/enc-dec/VLM model slice",
    "encdec": "the SSM/hybrid/enc-dec/VLM model slice",
    "vlm": "the SSM/hybrid/enc-dec/VLM model slice",
}


def check_family(cfg, what: str) -> None:
    """Raise unless ``cfg`` is the dense (non-MLA) family, naming the
    slice that ports it."""
    fam = "mla" if cfg.mla else cfg.family
    if fam != "dense":
        later = LATER_SLICES.get(fam, "a later slice")
        raise ValueError(
            f"{what}: the port runs the dense family only; {cfg.name!r} is "
            f"{fam!r}, which comes with {later} (ROADMAP.md, Queue 1)")


def layer_params(stack: Params, i: int) -> Params:
    """Layer ``i`` of a parameter-stacked tree, as views."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stack.items()}


def n_layers(stack: Params) -> int:
    leaf = stack
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def layers_of(params: Params):
    """The per-layer parameter views of the dense stack, in order."""
    stack = params["layers"]
    return [layer_params(stack, i) for i in range(n_layers(stack))]


# =============================================================================
# init
# =============================================================================

def init_params(gen: torch.Generator, cfg) -> Params:
    """Random weights for ``cfg`` on ``gen``'s device, in ``cfg.dtype``
    (norm scales float32), in the reference's layout.  The draws differ
    from the reference's ``jax.random`` ones; a test that compares the two
    converts the reference's parameters instead (``models.convert``)."""
    check_family(cfg, "init_params")
    dt, d, dev = torch_dtype(cfg), cfg.d_model, gen.device
    lead = (cfg.n_layers,)
    embed = {"tok": torch.randn((cfg.vocab, d), generator=gen, device=dev,
                                dtype=torch.float32).mul_(d ** -0.5).to(dt)}
    if not cfg.tie_embeddings:
        embed["head"] = dense_init(gen, (d, cfg.vocab), dt)
    return {
        "embed": embed,
        "final_norm": rmsnorm_init(d, (), dev),
        "layers": {
            "attn_norm": rmsnorm_init(d, lead, dev),
            "attn": attention_init(gen, cfg, lead),
            "mlp_norm": rmsnorm_init(d, lead, dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, dt, lead),
        },
    }


# =============================================================================
# forward
# =============================================================================

def _dense_block(p: Params, cfg, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    x = x + attention(p["attn"], cfg,
                      rmsnorm(p["attn_norm"], x, cfg.norm_eps), positions)
    return x + mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps))


def forward(params: Params, cfg,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) → (hidden (B,S,d), aux loss 0)."""
    check_family(cfg, "forward")
    x = params["embed"]["tok"][tokens.long()]
    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2])
    for lp in layers_of(params):
        x = _dense_block(lp, cfg, x, positions)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), device=x.device)


def logits_fn(params: Params, cfg, hidden: torch.Tensor) -> torch.Tensor:
    head = (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["embed"]["head"])
    return hidden @ head
