"""Serving paths of the dense family: cache init, prefill, single-token
decode against a contiguous cache or straight against the paged block
pool, and token selection.  The port of ``repro/models/serving.py``'s
dense parts.

Cache layout (L = layers, B = batch, S = max_seq): ``k``, ``v`` each
``(L, B, S, Hkv, hd)``.  The pool leaves of ``serve.BlockPool`` are the same
cache evaluated at ``batch = n_pages, max_seq = page_size``, so their
second axis is the page id.

Decode updates its cache in place: the contiguous path writes the new
K/V at ``pos``, the paged path has K10 write the new cell of the pool.
Other families raise (``lm.check_family``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.paged_attention import ops as paged_ops

from .layers import _qkv, attention, attention_decode, mlp, rmsnorm, torch_dtype
from .lm import check_family, layers_of, logits_fn

Params = Dict[str, object]


# =============================================================================
# cache init
# =============================================================================

def init_cache(cfg, batch: int, max_seq: int,
               device: torch.device) -> Params:
    check_family(cfg, "init_cache")
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# =============================================================================
# prefill — forward over the prompt, emitting the cache
# =============================================================================

def prefill(params: Params, cfg, tokens: torch.Tensor):
    """tokens (B,S) → (last-token logits (B,V), cache
    ``{k, v: (L,B,S,Hkv,hd)}``, next_pos (B,) int32)."""
    check_family(cfg, "prefill")
    b, s = tokens.shape
    x = params["embed"]["tok"][tokens.long()]
    positions = torch.arange(s, device=x.device).expand(b, s)
    ks, vs = [], []
    for lp in layers_of(params):
        hn = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        a, (k, v) = attention(lp["attn"], cfg, hn, positions, return_kv=True)
        x = x + a
        x = x + mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], x, cfg.norm_eps))
        ks.append(k)
        vs.append(v)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_fn(params, cfg, x[:, -1])
    next_pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}, next_pos


# =============================================================================
# decode — one token against the cache
# =============================================================================

def decode_step(params: Params, cfg, cache: Params, tokens: torch.Tensor,
                pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """tokens (B,1), pos (B,) → (logits (B,V), cache).  Writes each
    layer's new K/V into ``cache`` at ``pos`` in place."""
    check_family(cfg, "decode_step")
    x = params["embed"]["tok"][tokens.long()]
    for i, lp in enumerate(layers_of(params)):
        hn = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        a, _ = attention_decode(lp["attn"], cfg, hn,
                                (cache["k"][i], cache["v"][i]), pos)
        x = x + a
        x = x + mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], x, cfg.norm_eps))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x[:, 0]), cache


def decode_step_paged(params: Params, cfg, leaves: Params,
                      page_rows: torch.Tensor, tokens: torch.Tensor,
                      pos: torch.Tensor, *,
                      page_size: int) -> Tuple[torch.Tensor, Params]:
    """One decode step straight against the block pool: tokens (B,1),
    page_rows (B, max_pages), pos (B,) → (logits (B,V), leaves).  Per
    layer, K10 (``kernels/paged_attention``) walks each slot's pages and
    writes the new token's K/V into its ``(page, offset)`` cell in place —
    no gather, no scatter.  The non-cache halves are those of
    :func:`decode_step`."""
    check_family(cfg, "decode_step_paged")
    x = params["embed"]["tok"][tokens.long()]
    page_rows = page_rows.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    for i, lp in enumerate(layers_of(params)):
        x = _paged_decode_block(lp, cfg, x, leaves["k"][i], leaves["v"][i],
                                page_rows, pos, page_size)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x[:, 0]), leaves


def _paged_decode_block(lp: Params, cfg, h: torch.Tensor,
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        page_rows: torch.Tensor, pos: torch.Tensor,
                        page_size: int) -> torch.Tensor:
    """One decoder layer against its pool slices ``(P, ps, Hkv, hd)`` —
    the paged twin of a :func:`decode_step` layer."""
    b = h.shape[0]
    hn = rmsnorm(lp["attn_norm"], h, cfg.norm_eps)
    p = lp["attn"]
    q, k, v = _qkv(p, cfg, hn, pos[:, None])
    o, _, _ = paged_ops.paged_gqa_decode(
        q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
        k_pool, v_pool, page_rows, pos, page_size=page_size)
    h = h + o.to(h.dtype).reshape(b, 1, -1) @ p["wo"]
    return h + mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], h, cfg.norm_eps))


# =============================================================================
# token selection
# =============================================================================

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer on int64 tensors holding values in
    [0, 2^32).  Both multipliers are below 2^31, so no product leaves
    int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seed: int, rids: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Standard Gumbel noise (B, vocab) in float64, a stateless function of
    ``(seed, rid, position, token id)``: the same request draws the same
    noise at the same position whatever else is in the batch."""
    dev = rids.device
    base = _mix32(torch.full_like(rids, int(seed) & _M32, dtype=torch.int64))
    base = _mix32(base ^ (rids.long() & _M32))
    base = _mix32(base ^ (positions.long() & _M32))
    tok = _mix32(torch.arange(vocab, dtype=torch.int64, device=dev)
                 ^ 0x9E3779B9)
    bits = _mix32(base[:, None] ^ tok[None, :])
    u = (bits.double() + 0.5) / 2.0 ** 32                 # in (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, temperature: float, top_k: int,
                  seed: int, rids: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Next-token selection for the serving tier: greedy argmax when
    ``temperature == 0`` (the conformance oracle), otherwise temperature
    and optional top-k sampling by Gumbel-max with :func:`gumbel_noise`
    keyed by each row's request id and the position of the token it
    draws.  The reference drew with threefry keys split per token; those
    bits cannot be reproduced here, so the port's streams differ from the
    reference's but keep its properties: deterministic under a seed and
    independent of batch composition.  Returns tokens (B,) int32."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1]
        scaled = scaled.masked_fill(scaled < kth[:, None], float("-inf"))
    g = gumbel_noise(seed, rids, positions, logits.shape[-1])
    return torch.argmax(scaled.double() + g, dim=-1).to(torch.int32)
