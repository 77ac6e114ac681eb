"""LM assembly for every family of the reference: init / forward / logits
/ loss.  The port of ``repro/models/lm.py``.

Families:

* dense — pre-norm GQA + SwiGLU (phi4 / starcoder2 / granite / qwen3);
* moe — GQA or MLA attention (``mla.py``) + routed experts (``moe.py``)
  (kimi-k2 / deepseek-v3);
* ssm — a Mamba1 trunk (falcon-mamba): ``h + mamba1_apply(norm(h))``
  (``ssm.py``), its stack ``{"norm", "mamba"}`` under ``params["layers"]``;
* hybrid — a Mamba2 trunk with shared attention blocks (zamba2): after
  every ``shared_attn_every`` trunk layers a shared block
  ``shared[site % n_shared_blocks]`` runs on ``cat([h, emb0])`` (width
  2d, ``emb0`` the embedding output) and adds its output projected back
  to d by ``site_proj[site]``; the layers past the last site form a tail
  (:func:`hybrid_site_after`);
* encdec — the Whisper backbone: stub frame embeddings plus
  ``sinusoidal_pos`` feed the encoder (causal self-attention with RoPE,
  full attention whatever ``attn_chunk``, as the reference has it), and
  each decoder layer adds cross attention on the encoder output;
* vlm — the InternVL backbone: stub patch embeddings (``extra
  ["vis_embeds"]``) prepended to the token embeddings, then dense layers;
  the loss drops the visual positions.

Layer stacks keep the reference's parameter-stacked layout (a leading L
axis on every leaf of a stack); the reference's ``lax.scan`` over them
(``models/scan_util.py``) is a Python loop over :func:`layers_of` (or
``_unbind`` of a stack), whose layers are ``unbind`` views of each
stack, so the backward pass stacks a leaf's per-layer gradients once.
With ``cfg.remat`` and gradients enabled each block runs under
``torch.utils.checkpoint`` (the reference's per-layer
``jax.checkpoint``; the hybrid trunk's Mamba2 layers and its shared
blocks each, as the reference's two): only its input is kept, and the
backward pass runs it again; serving (no gradients) never pays for it.
``init_params`` draws every weight with the caller's
``torch.Generator``, on the generator's device and in ``cfg.dtype``, so
a full-width model is never built on the host and copied.  A family the
reference does not know raises a ``ValueError`` (:func:`check_family`).

Activation-sharding constraints (``dist.constrain``) sit at the
reference's sites: the embedding output, the residual stream before each
layer of a stack (sequence-parallel ``("dp", "tp", None)``, the MoE
layers' ``("dp", None, None)``) and the logits.  They act only on
DTensors inside ``dist.activation_sharding``; on plain tensors the forward
is what it was.  A layer stack whose leading (layer) dim is sharded is
gathered along it before it is sliced into layers (``dist.sharding.
unshard_dim``), as slicing a DTensor along a sharded dim needs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.act_sharding import constrain, linear, lookup, on_shards
from repro_torch.dist.sharding import unshard_dim

from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (attention, attention_init, cross_attention, dense_init,
                     mlp, mlp_init, rmsnorm, rmsnorm_init, sinusoidal_pos,
                     torch_dtype)

Params = Dict[str, object]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_family(cfg, what: str) -> None:
    """Raise unless ``cfg`` is of a family the reference knows."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{what}: {cfg.name!r} is of the unknown family "
                         f"{cfg.family!r}; the families are {FAMILIES}")


def _unbind(stack: Params) -> List[Params]:
    """Every layer of a parameter-stacked tree, as views: one ``unbind``
    a leaf, whose backward stacks the layers' gradients in one pass."""
    per_key = {k: (_unbind(v) if isinstance(v, dict)
                   else unshard_dim(v, 0).unbind(0))
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
    """A Mamba1 (SSM family) or Mamba2 (hybrid trunk) layer stack."""
    init = (ssm_mod.mamba2_init if cfg.family == "hybrid"
            else ssm_mod.mamba1_init)
    return {"norm": rmsnorm_init(cfg.d_model, (n,), gen.device),
            "mamba": init(gen, cfg, (n,))}


def shared_cfg(cfg):
    """The zamba2 shared block's configuration: it runs on the concat
    width 2d, its heads ``2d // n_heads`` wide."""
    d2 = 2 * cfg.d_model
    return dataclasses.replace(cfg, d_model=d2, head_dim=d2 // cfg.n_heads)


def n_sites(cfg) -> int:
    """The hybrid trunk's shared-block sites: one after every
    ``shared_attn_every`` layers, none in the tail."""
    return cfg.n_layers // cfg.shared_attn_every


def hybrid_site_after(cfg, i: int) -> Optional[int]:
    """The site whose shared block runs after trunk layer ``i``, or None."""
    every = cfg.shared_attn_every
    return (i + 1) // every - 1 if (i + 1) % every == 0 else None


def _shared_block_init(gen: torch.Generator, cfg, n: int) -> Params:
    scfg, dev = shared_cfg(cfg), gen.device
    d2, lead = scfg.d_model, (n,)
    return {"norm": rmsnorm_init(d2, lead, dev),
            "attn": attention_init(gen, scfg, lead),
            "mlp_norm": rmsnorm_init(d2, lead, dev),
            "mlp": mlp_init(gen, d2, cfg.d_ff, torch_dtype(cfg), lead)}


def _encdec_layer_init(gen: torch.Generator, cfg, n: int,
                       cross: bool) -> Params:
    p = _layer_stack_init(gen, cfg, n, moe=False)
    if cross:
        p["cross_norm"] = rmsnorm_init(cfg.d_model, (n,), gen.device)
        p["cross"] = attention_init(gen, cfg, (n,))
    return p


class _MetaGenerator(torch.Generator):
    """A host generator that reports the ``meta`` device, so
    :func:`init_params` builds every leaf on ``meta`` (a draw on ``meta``
    allocates nothing and reads no generator state)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_shapes(cfg) -> Params:
    """``cfg``'s parameter tree on the ``meta`` device: the shapes and
    dtypes of :func:`init_params`, nothing allocated (the reference's
    ``jax.eval_shape(init_params)``)."""
    return init_params(_MetaGenerator(), cfg)


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
    fam = cfg.family
    if fam in ("dense", "vlm"):
        p["layers"] = _layer_stack_init(gen, cfg, cfg.n_layers, moe=False)
    elif fam == "ssm":
        p["layers"] = _ssm_layer_init(gen, cfg, cfg.n_layers)
    elif fam == "hybrid":
        p["layers"] = _ssm_layer_init(gen, cfg, cfg.n_layers)
        p["shared"] = _shared_block_init(gen, cfg, cfg.n_shared_blocks)
        p["site_proj"] = dense_init(gen, (n_sites(cfg), 2 * d, d), dt)
    elif fam == "encdec":
        p["enc_layers"] = _encdec_layer_init(gen, cfg, cfg.enc_layers,
                                             cross=False)
        p["dec_layers"] = _encdec_layer_init(gen, cfg, cfg.n_layers,
                                             cross=True)
        p["enc_norm"] = rmsnorm_init(d, (), dev)
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


def _remat(remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat``."""
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def _ssm_block(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    return x + ssm_mod.mamba1_apply(p["mamba"], cfg,
                                    rmsnorm(p["norm"], x, cfg.norm_eps))


def mamba2_block(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """One hybrid trunk layer: ``h + mamba2_apply(norm(h))``."""
    return x + ssm_mod.mamba2_apply(p["mamba"], cfg,
                                    rmsnorm(p["norm"], x, cfg.norm_eps))


def shared_block(sp: Params, site_proj: torch.Tensor, cfg, h: torch.Tensor,
                 emb0: torch.Tensor, attend_fn):
    """A zamba2 shared block at one site: ``u = cat([h, emb0])``, pre-norm
    attention and MLP at width 2d, then ``h + u @ site_proj``.
    ``attend_fn(attn params, shared cfg, normed u)`` is the attention
    (``(out, cache entries)``: the forward's, the prefill's or the
    decode's).  Returns ``(h', cache entries)``."""
    cat = torch.cat([h, emb0], dim=-1)                     # (B,S,2d)
    a, kv = attend_fn(sp["attn"], shared_cfg(cfg),
                      rmsnorm(sp["norm"], cat, cfg.norm_eps))
    u = cat + a
    u = u + mlp(sp["mlp"], rmsnorm(sp["mlp_norm"], u, cfg.norm_eps))
    return h + linear(u, site_proj), kv


def _shared_fwd(sp, site_proj, cfg, h, emb0, positions):
    return shared_block(sp, site_proj, cfg, h, emb0,
                        lambda p, c, u: (attention(p, c, u, positions),
                                         None))[0]


def _hybrid_trunk(params: Params, cfg, x: torch.Tensor,
                  positions: torch.Tensor, remat: bool) -> torch.Tensor:
    emb0 = x
    shared = _unbind(params["shared"])
    site_proj = params["site_proj"].unbind(0)
    for i, lp in enumerate(_unbind(params["layers"])):
        x = _remat(remat, mamba2_block, lp, cfg, x)
        site = hybrid_site_after(cfg, i)
        if site is not None:
            x = _remat(remat, _shared_fwd, shared[site % cfg.n_shared_blocks],
                       site_proj[site], cfg, x, emb0, positions)
    return x


def _enc_block(p: Params, cfg, h: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = h + attention(p["attn"], cfg, rmsnorm(p["attn_norm"], h, cfg.norm_eps),
                      positions)
    return h + mlp(p["mlp"], rmsnorm(p["mlp_norm"], h, cfg.norm_eps))


def encode(params: Params, cfg, frames: torch.Tensor, dtype: torch.dtype,
           remat: bool = False) -> torch.Tensor:
    """The enc-dec encoder: ``frames`` (B,F,d) in ``dtype`` plus
    ``sinusoidal_pos``, the encoder layers (causal, with RoPE, full
    attention: ``attn_chunk`` 0) and ``enc_norm``."""
    frames = frames.to(dtype)
    b, f, d = frames.shape
    e = frames + sinusoidal_pos(f, d, device=frames.device).to(dtype)
    ecfg = dataclasses.replace(cfg, attn_chunk=0)
    positions = torch.arange(f, device=e.device).expand(b, f)
    for lp in _unbind(params["enc_layers"]):
        e = constrain(e, "dp", "tp", None)
        e = _remat(remat, _enc_block, lp, ecfg, e, positions)
    return rmsnorm(params["enc_norm"], e, cfg.norm_eps)


def _dec_block(p: Params, cfg, h: torch.Tensor, positions: torch.Tensor,
               e: torch.Tensor) -> torch.Tensor:
    h = h + attention(p["attn"], cfg, rmsnorm(p["attn_norm"], h, cfg.norm_eps),
                      positions)
    h = h + cross_attention(p["cross"], cfg,
                            rmsnorm(p["cross_norm"], h, cfg.norm_eps), e)
    return h + mlp(p["mlp"], rmsnorm(p["mlp_norm"], h, cfg.norm_eps))


def stub_inputs(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    """The family's stub modality inputs, zeros in ``cfg.dtype`` (what the
    reference's launcher and trainer feed): the VLM family's patch
    embeddings ``vis_embeds`` (B, V, d), the enc-dec family's encoder
    frames ``frames`` (B, enc_seq, d); none for the other families."""
    rows = {"vlm": ("vis_embeds", cfg.n_vis_tokens),
            "encdec": ("frames", cfg.enc_seq)}.get(cfg.family)
    if rows is None:
        return {}
    return {rows[0]: torch.zeros((batch, rows[1], cfg.d_model),
                                 dtype=torch_dtype(cfg), device=device)}


def embed_inputs(params: Params, cfg, tokens: torch.Tensor,
                 extra: Dict[str, torch.Tensor]):
    """The token embeddings, with the VLM family's patch embeddings
    prepended (cast to the embeddings' dtype), and their positions
    (B, S'), S' = V + S for the VLM family, else S."""
    x = constrain(lookup(params["embed"]["tok"], tokens.long()),
                  "dp", None, None)
    if cfg.family == "vlm":
        x = torch.cat([extra["vis_embeds"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2])
    return x, positions


def forward(params: Params, cfg, tokens: torch.Tensor,
            extra: Optional[Dict[str, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) → (hidden (B,S',d), the MoE layers' summed aux loss).
    For the VLM family S' = V + S (``extra["vis_embeds"]`` (B,V,d)); for
    the enc-dec family the tokens are the decoder's and
    ``extra["frames"]`` (B,F,d) feeds the encoder."""
    check_family(cfg, "forward")
    extra = extra or {}
    x, positions = embed_inputs(params, cfg, tokens, extra)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    if cfg.family == "hybrid":
        x = _hybrid_trunk(params, cfg, x, positions, remat)
    elif cfg.family == "encdec":
        e = encode(params, cfg, extra["frames"], x.dtype, remat)
        x = x + sinusoidal_pos(x.shape[1], cfg.d_model,
                               device=x.device).to(x.dtype)
        for lp in _unbind(params["dec_layers"]):
            x = constrain(x, "dp", "tp", None)
            x = _remat(remat, _dec_block, lp, cfg, x, positions, e)
    else:
        for lp, is_moe in layers_of(params):
            # sequence-parallel residual between layers; the MoE layers'
            # stays whole over "tp", as the reference's
            x = constrain(x, "dp", None if is_moe else "tp", None)
            if cfg.family == "ssm":
                x = _remat(remat, _ssm_block, lp, cfg, x)
                continue
            x, a = _remat(remat, _block, lp, cfg, x, positions, is_moe)
            if a is not None:
                aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def logits_fn(params: Params, cfg, hidden: torch.Tensor) -> torch.Tensor:
    head = (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["embed"]["head"])
    return linear(hidden, head)


def _next_tokens(tokens: torch.Tensor) -> torch.Tensor:
    return torch.roll(tokens, -1, dims=1)


def loss_fn(params: Params, cfg, batch: Dict[str, torch.Tensor],
            aux_coef: float = 0.01) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (+ MoE aux, + z-loss).  batch: tokens (B,S),
    loss_mask (B,S) optional, plus the modality extras (``vis_embeds``,
    ``frames``).  The VLM family's visual positions are dropped.  The
    logits are computed in ``cfg.dtype`` and then cast to float32, as the
    reference's."""
    check_family(cfg, "loss_fn")
    tokens = batch["tokens"]
    hidden, aux = forward(params, cfg, tokens, extra=batch)
    if cfg.family == "vlm":
        hidden = hidden[:, cfg.n_vis_tokens:]
    logits = constrain(logits_fn(params, cfg, hidden),
                       "dp", None, "tp").float()
    targets = on_shards(_next_tokens, (tokens.long(),), (("dp", None),),
                        ("dp", None), {"dp": tokens.shape[0]})
    ones = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask = batch.get("loss_mask", ones)
    last = torch.cat([ones[:, :-1], torch.zeros_like(ones[:, :1])], dim=1)
    mask = mask * last
    lse = torch.logsumexp(logits, dim=-1)
    # the target logits keep their trailing axis until the subtraction: on
    # vocab-sharded DTensor logits the gather's masked partial sum can be
    # reduced only at its own rank
    tgt = torch.gather(logits, -1, targets[..., None])
    nll = (lse[..., None] - tgt)[..., 0] * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    ce = torch.sum(nll) / denom
    z_loss = 1e-4 * torch.sum((lse * mask) ** 2) / denom
    loss = ce + aux_coef * aux + z_loss
    return loss, {"ce": ce, "aux": aux, "z": z_loss, "ntok": torch.sum(mask)}
