"""Multi-head Latent Attention (DeepSeek-V3).  The port of
``repro/models/mla.py``.

Q and KV pass through low-rank bottlenecks; the decode cache stores only
the compressed latent (``kv_lora_rank``) plus the shared RoPE key.  The
decode path uses the *weight-absorbed* form: scores are computed directly
against the compressed cache (q absorbed through W_uk), and the context is
re-expanded through W_uv after the softmax.

The reference's dtype steps are kept, since the bf16 results depend on
where the rounding happens: ``q_eff`` comes out in the model dtype, scores
are float32, the softmax weights are cast to the activations' dtype before
the product with the latent.  ``mla_decode`` writes the new latent into
its cache in place (the reference returned an updated copy).  On
DTensors the heads' assembly and the decode's scores and mix run on each
device's shards (``dist.act_sharding.on_shards``: batch over the
data-parallel axes, heads over "model"), the latent cache whole.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.dist.act_sharding import linear, on_shards
from repro_torch.dist.sharding import reshape, write_rows

from .layers import (HEADS, dense_init, rmsnorm, rmsnorm_init, rope,
                     sdpa_chunked, sdpa_full, torch_dtype)

Params = Dict[str, object]


def mla_init(gen: torch.Generator, cfg, lead: Tuple[int, ...] = ()) -> Params:
    d, h, dt, dev = cfg.d_model, cfg.n_heads, torch_dtype(cfg), gen.device
    qk_hd = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq_a": dense_init(gen, lead + (d, cfg.q_lora_rank), dt),
        "q_norm": rmsnorm_init(cfg.q_lora_rank, lead, dev),
        "wq_b": dense_init(gen, lead + (cfg.q_lora_rank, h * qk_hd), dt),
        "wkv_a": dense_init(gen, lead + (d, cfg.kv_lora_rank
                                         + cfg.qk_rope_dim), dt),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, lead, dev),
        "wkv_b": dense_init(gen, lead + (cfg.kv_lora_rank,
                                         h * (cfg.qk_nope_dim
                                              + cfg.v_head_dim)), dt),
        "wo": dense_init(gen, lead + (h * cfg.v_head_dim, d), dt),
    }


def _mla_q(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope) with RoPE applied)."""
    b, s, _ = x.shape
    qk_hd = cfg.qk_nope_dim + cfg.qk_rope_dim
    cq = rmsnorm(p["q_norm"], linear(x, p["wq_a"]), cfg.norm_eps)
    q = reshape(linear(cq, p["wq_b"]), b, s, cfg.n_heads, qk_hd)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_kv_latent(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """(c_kv (B,S,lat), k_rope (B,S,rope)): the latent and the RoPE key
    shared by every head."""
    kv_a = linear(x, p["wkv_a"])
    c_kv = rmsnorm(p["kv_norm"], kv_a[..., :cfg.kv_lora_rank], cfg.norm_eps)
    k_rope = rope(kv_a[..., cfg.kv_lora_rank:][:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def absorbed_weights(p: Params, cfg):
    """``wkv_b`` split per head: (w_uk (lat,H,nope), w_uv (lat,H,vd))."""
    return _split_heads(p["wkv_b"], cfg)


def _split_heads(wkv_b: torch.Tensor, cfg):
    nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
    w = wkv_b.reshape(cfg.kv_lora_rank, -1, nope + vd)
    return w[..., :nope], w[..., nope:]


def mla_attention(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
                  return_latent: bool = False):
    """Full-sequence causal MLA (prefill math).  The value width (v_head_dim)
    differs from the query/key width (nope + rope); the scale is the
    latter's."""
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_kv_latent(p, cfg, x, positions)
    kv = reshape(linear(c_kv, p["wkv_b"]), b, s, h,
                 cfg.qk_nope_dim + cfg.v_head_dim)
    q, k, v = on_shards(functools.partial(_mla_heads, nope=cfg.qk_nope_dim),
                        (q_nope, q_rope, kv, k_rope),
                        (HEADS, HEADS, HEADS, ("dp", None, None)),
                        (HEADS,) * 3, {"dp": b, "tp": h})
    if cfg.attn_chunk and s > cfg.attn_chunk and s % cfg.attn_chunk == 0:
        o = sdpa_chunked(q, k, v, cfg.attn_chunk)
    else:
        o = sdpa_full(q, k, v)
    out = linear(reshape(o, b, s, -1), p["wo"])
    if return_latent:
        return out, (c_kv, k_rope)
    return out


def _mla_heads(q_nope, q_rope, kv, k_rope, nope: int):
    """(q, k, v) per head: the queries' halves joined, the keys' no-RoPE
    half beside the RoPE key shared by every head."""
    b, s, h, _ = kv.shape
    k = torch.cat([kv[..., :nope], k_rope[:, :, None, :].expand(
        b, s, h, k_rope.shape[-1])], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, kv[..., nope:]


def mla_init_cache(cfg, batch: int, max_seq: int,
                   device: torch.device) -> Params:
    dt = torch_dtype(cfg)
    return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                                dtype=dt, device=device),
            "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_dim),
                                  dtype=dt, device=device)}


def mla_prefill_cache(p: Params, cfg, x: torch.Tensor,
                      positions: torch.Tensor):
    """Latents for the whole prompt (stored compressed)."""
    return _mla_kv_latent(p, cfg, x, positions)


def mla_decode(p: Params, cfg, x: torch.Tensor, cache: Params,
               pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Weight-absorbed single-token decode.  x (B,1,d), cache ``{c_kv
    (B,S,lat), k_rope (B,S,rope)}``, pos (B,).  Writes the new latent and
    RoPE key at ``pos`` in place and returns (out (B,1,d), cache)."""
    b = x.shape[0]
    pos = pos.long()
    q_nope, q_rope = _mla_q(p, cfg, x, pos[:, None])          # (B,1,H,·)
    c_new, r_new = _mla_kv_latent(p, cfg, x, pos[:, None])
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    write_rows(c_kv, pos, c_new[:, 0])
    write_rows(k_rope, pos, r_new[:, 0])
    o = on_shards(functools.partial(_mla_decode_attend, cfg=cfg),
                  (q_nope, q_rope, c_kv, k_rope, pos, p["wkv_b"]),
                  (HEADS, HEADS, ("dp", None, None), ("dp", None, None),
                   ("dp",), (None, "tp")),
                  HEADS, {"dp": b, "tp": cfg.n_heads})
    return linear(reshape(o, b, 1, -1), p["wo"]), cache


def _mla_decode_attend(q_nope, q_rope, c_kv, k_rope, pos, wkv_b, cfg):
    """The weight-absorbed scores against the latent cache up to ``pos``,
    the softmax, and the context re-expanded through W_uv."""
    w_uk, w_uv = _split_heads(wkv_b, cfg)
    q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope, w_uk)      # (B,1,H,lat)
    scores = (torch.einsum("bqhl,bsl->bhqs", q_eff.float(), c_kv.float())
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             k_rope.float()))
    scores = scores * (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    mask = torch.arange(c_kv.shape[1], device=c_kv.device)[None, :] \
        <= pos[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q_nope.dtype)
    ctx = torch.einsum("bhqs,bsl->bqhl", w, c_kv)              # (B,1,H,lat)
    return torch.einsum("bqhl,lhv->bqhv", ctx, w_uv)           # (B,1,H,vd)
