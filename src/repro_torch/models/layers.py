"""Core transformer layers, dense parts: RMSNorm, RoPE, GQA attention (full
/ chunked / decode-with-cache) and the SwiGLU MLP.  The port of
``repro/models/layers.py``: plain functions over explicit parameter
dictionaries of tensors, in the reference's layouts (activations
``(B, S, H, hd)``, weights ``(d_in, d_out)``), so the tests compare like
with like.

Changes from the reference:

* on DTensors (``dist``) the attention cores (``_repeat_kv``,
  ``sdpa_full``, ``sdpa_chunked``, the decode's scores and mix) run on
  each device's shards (``dist.act_sharding.on_shards``): batch over the
  data-parallel axes, heads over "model" where it divides them.  That is
  where the reference's constraints inside the chunked attention (its
  scores, running max, sum and accumulator) put each (batch, head) block:
  on the device that holds its queries.  ``sdpa_chunked`` constrains its
  inputs as the reference's does; on plain tensors every one of these is
  the plain call;
* ``attention_decode`` writes the new K/V into the cache in place (the
  reference returned an updated copy);
* attention outside the paged decode kernel stays plain ``torch.matmul``
  and softmax, as the reference left it to XLA; the fused library
  attention waits for K12's slice;
* ``dense_init`` draws a stack larger than ``DRAW_CHUNK`` float32 values
  in slices of whole matrices, so a full-width expert stack (256 x 7168 x
  2048) never has its float32 draw resident at once.

Scores and softmax are float32 whatever the storage type, as the
reference's ``preferred_element_type=float32``; matrix products of bf16
operands are bf16 (PyTorch accumulates them in float32).  The SSM, MLA,
MoE layers are ``mla.py`` and ``moe.py``, the SSM layers ``ssm.py``.
``cross_attention`` and ``sinusoidal_pos`` serve the enc-dec family
(whisper): the decoder's attention on the encoder output, and the
position embedding of the encoder frames and of the decoder tokens.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.act_sharding import (constrain, linear, on_shards,
                                           sharded)
from repro_torch.dist.sharding import reshape, write_rows

Params = Dict[str, object]


def torch_dtype(cfg) -> torch.dtype:
    """The storage type named by ``cfg.dtype`` ("bfloat16", "float32")."""
    return getattr(torch, cfg.dtype)


# --- init: every draw on the generator's device, stacked over ``lead`` ----------

# float32 values drawn at once (4 GiB): a larger stack is drawn in slices.
# Every stack of qwen3-1.7b and deepseek-v3-671b's dense layers is smaller
# and is drawn whole; a full-width expert stack (3.8e9 values) is not.
DRAW_CHUNK = 1 << 30


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/d_in) weights of ``shape (..., d_in, d_out)``, drawn in float32
    on ``gen``'s device and stored in ``dtype``.  A stack of matrices with
    more than ``DRAW_CHUNK`` values is drawn a slice of whole matrices at a
    time into the ``dtype`` result, so the float32 draw never needs more
    than ``DRAW_CHUNK`` values (one matrix at least)."""
    scale = (1.0 / shape[-2]) ** 0.5
    if len(shape) < 3 or math.prod(shape) <= DRAW_CHUNK:
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    mats = out.view(-1, shape[-2], shape[-1])
    step = max(1, DRAW_CHUNK // (shape[-2] * shape[-1]))
    for i in range(0, mats.shape[0], step):
        part = mats[i:i + step]
        part.copy_(torch.randn(part.shape, generator=gen, device=gen.device,
                               dtype=torch.float32).mul_(scale))
    return out


def rmsnorm_init(d: int, lead: Tuple[int, ...], device) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=torch.float32,
                                device=device)}


def attention_init(gen: torch.Generator, cfg,
                   lead: Tuple[int, ...] = ()) -> Params:
    d, hd, dt = cfg.d_model, cfg.hd, torch_dtype(cfg)
    p = {
        "wq": dense_init(gen, lead + (d, cfg.n_heads * hd), dt),
        "wk": dense_init(gen, lead + (d, cfg.n_kv_heads * hd), dt),
        "wv": dense_init(gen, lead + (d, cfg.n_kv_heads * hd), dt),
        "wo": dense_init(gen, lead + (cfg.n_heads * hd, d), dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, lead, gen.device)
        p["k_norm"] = rmsnorm_init(hd, lead, gen.device)
    return p


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype,
             lead: Tuple[int, ...] = ()) -> Params:
    return {"w_gate": dense_init(gen, lead + (d, d_ff), dtype),
            "w_up": dense_init(gen, lead + (d, d_ff), dtype),
            "w_down": dense_init(gen, lead + (d_ff, d), dtype)}


# --- RMSNorm ------------------------------------------------------------------

def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["scale"]).to(x.dtype)


# --- rotary embeddings ----------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd), positions: (..., S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    """(seq, d) float32: sin on the even columns, cos on the odd, at
    positions ``offset .. offset + seq - 1``."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[:, None]
    return _sin_cos(pos, d)


def _sin_cos(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(N, 1) float32 positions → (N, d): sin(pos·div) on the even columns,
    cos on the odd, ``div`` computed in float32 as the reference does."""
    scale = torch.log(torch.tensor(10000.0, device=pos.device)) / d
    div = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=pos.device) * scale)[None, :]
    ang = pos * div
    # (N, d/2, 2) → (N, d): the columns interleave sin and cos (``d`` even)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        pos.shape[0], d)


# --- GQA attention ------------------------------------------------------------

def _qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.hd
    q = reshape(linear(x, p["wq"]), b, s, cfg.n_heads, hd)
    k = reshape(linear(x, p["wk"]), b, s, cfg.n_kv_heads, hd)
    v = reshape(linear(x, p["wv"]), b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


# the per-shard layout of (B, S, H, hd) activations in the attention cores
HEADS = ("dp", None, "tp", None)


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,Hkv,hd) → (B,S,H,hd) by repeating each kv head."""
    hkv = k.shape[2]
    if hkv == n_heads:
        return k
    if not sharded(k):
        return torch.repeat_interleave(k, n_heads // hkv, dim=2)
    rep = functools.partial(torch.repeat_interleave, repeats=n_heads // hkv,
                            dim=2)
    return on_shards(rep, (k,), (HEADS,), HEADS,
                     {"dp": k.shape[0], "tp": hkv})


def sdpa_full(q, k, v, causal: bool = True,
              q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Sk,H,hd).  fp32 softmax."""
    if not sharded(q, k, v):
        return _sdpa_full(q, k, v, causal, q_offset)
    fn = functools.partial(_sdpa_full, causal=causal, q_offset=q_offset)
    return on_shards(fn, (q, k, v), (HEADS,) * 3, HEADS,
                     {"dp": q.shape[0], "tp": q.shape[2]})


def _sdpa_full(q, k, v, causal: bool, q_offset: int) -> torch.Tensor:
    hd = q.shape[-1]
    scale = hd ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        kj = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(qi < kj, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def sdpa_chunked(q, k, v, chunk: int, causal: bool = True) -> torch.Tensor:
    """Online-softmax over KV chunks (flash-attention math, plain torch).
    Requires Sk % chunk == 0.  Same-length causal self-attention."""
    if k.shape[1] % chunk:
        raise ValueError(f"sequence {k.shape[1]} is not a multiple of "
                         f"chunk {chunk}")
    if not sharded(q, k, v):
        return _sdpa_chunked(q, k, v, chunk, causal)
    q = constrain(q, "dp", None, "tp", None)
    k = constrain(k, "dp", None, "tp", None)
    v = constrain(v, "dp", None, "tp", None)
    fn = functools.partial(_sdpa_chunked, chunk=chunk, causal=causal)
    return on_shards(fn, (q, k, v), (HEADS,) * 3, HEADS,
                     {"dp": q.shape[0], "tp": q.shape[2]})


def _sdpa_chunked(q, k, v, chunk: int, causal: bool) -> torch.Tensor:
    b, sq, h, hd = q.shape
    vd = v.shape[-1]
    sk = k.shape[1]
    scale = hd ** -0.5
    qi = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, sq, h, vd), device=q.device)
    qf = q.float()
    for c in range(sk // chunk):
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        if causal:
            kj = c * chunk + torch.arange(chunk, device=q.device)[None, :]
            s = s.masked_fill(qi < kj, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) → nan
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros((), device=q.device))
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros((), device=q.device))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros((), device=q.device))
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr.permute(0, 2, 1)[..., None]
               + torch.einsum("bhqk,bkhd->bqhd", p, vb.float()))
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (acc / l.permute(0, 2, 1)[..., None]).to(q.dtype)


def attention(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
              return_kv: bool = False):
    """Causal self-attention over (B,S,d).  ``return_kv`` also returns the
    pre-repeat (B,S,Hkv,hd) keys/values for prefill cache construction."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    kf = _repeat_kv(k, cfg.n_heads)
    vf = _repeat_kv(v, cfg.n_heads)
    if cfg.attn_chunk and s > cfg.attn_chunk and s % cfg.attn_chunk == 0:
        o = sdpa_chunked(q, kf, vf, cfg.attn_chunk)
    else:
        o = sdpa_full(q, kf, vf)
    out = linear(reshape(o, b, s, -1), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p: Params, cfg, x: torch.Tensor,
                     cache: Tuple[torch.Tensor, torch.Tensor],
                     pos: torch.Tensor):
    """One-token decode: x (B,1,d), cache = (k,v) each (B,Smax,Hkv,hd),
    pos (B,) current index.  Writes the new K/V at ``pos`` in place and
    returns (out (B,1,d), cache)."""
    b = x.shape[0]
    ck, cv = cache
    pos = pos.long()
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    write_rows(ck, pos, k[:, 0])
    write_rows(cv, pos, v[:, 0])
    o = on_shards(functools.partial(_decode_attend, scale=cfg.hd ** -0.5),
                  (q, ck, cv, pos), (HEADS, HEADS, HEADS, ("dp",)), HEADS,
                  {"dp": b, "tp": cfg.n_kv_heads})
    return linear(reshape(o, b, 1, -1), p["wo"]), (ck, cv)


def _decode_attend(q, ck, cv, pos, scale: float) -> torch.Tensor:
    """One query a row against the cache rows up to ``pos``."""
    kf = _repeat_kv(ck, q.shape[2])
    vf = _repeat_kv(cv, q.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) * scale
    mask = torch.arange(ck.shape[1], device=q.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf)


def cross_kv(p: Params, cfg, kv_src: torch.Tensor):
    """The cross-attention keys and values of ``kv_src`` (B,F,d): each
    (B,F,Hkv,hd), no RoPE (the enc-dec cache's ``cross`` entries)."""
    b, f, _ = kv_src.shape
    k = reshape(linear(kv_src, p["wk"]), b, f, cfg.n_kv_heads, cfg.hd)
    v = reshape(linear(kv_src, p["wv"]), b, f, cfg.n_kv_heads, cfg.hd)
    return k, v


def cross_attend(p: Params, cfg, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Cross attention of ``x`` (B,S,d) on precomputed keys and values
    (B,F,Hkv,hd): no RoPE, no mask."""
    b, s, _ = x.shape
    q = reshape(linear(x, p["wq"]), b, s, cfg.n_heads, cfg.hd)
    o = sdpa_full(q, _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads),
                  causal=False)
    return linear(reshape(o, b, s, -1), p["wo"])


def cross_attention(p: Params, cfg, x: torch.Tensor,
                    kv_src: torch.Tensor) -> torch.Tensor:
    """Encoder-decoder cross attention (no RoPE, no mask): queries from
    ``x`` (B,S,d), keys and values from ``kv_src`` (B,F,d)."""
    return cross_attend(p, cfg, x, *cross_kv(p, cfg, kv_src))


# --- SwiGLU MLP ------------------------------------------------------------------

def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"]),
                  p["w_down"])
