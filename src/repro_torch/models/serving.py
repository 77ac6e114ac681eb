"""Serving paths of every family: cache init, prefill, single-token
decode against a contiguous cache or straight against the paged block
pool, and token selection.  The port of ``repro/models/serving.py``.

Cache layout (L = layers, B = batch, S = max_seq):

* GQA (dense, VLM, and MoE with GQA): ``k``, ``v`` each
  ``(L, B, S, Hkv, hd)``; the VLM family's S counts the visual positions;
* MLA (deepseek): ``c_kv`` ``(L, B, S, lat)`` and ``k_rope``
  ``(L, B, S, rope)`` — the compressed latent and the shared RoPE key;
* SSM (falcon-mamba): ``conv`` ``(L, B, K-1, dI)`` and ``h``
  ``(L, B, dI, N)``, float32 — the conv window and the recurrent state,
  O(1) in the sequence (``max_seq`` is not used, ``pad_seq`` leaves it);
* hybrid (zamba2): the Mamba2 trunk's ``conv_x`` ``(L, B, K-1, dI)``,
  ``conv_b``/``conv_c`` ``(L, B, K-1, N)`` and ``h`` ``(L, B, H, P, N)``,
  float32 and O(1) in the sequence, beside ``shared: {k, v}``, each
  ``(n_sites, B, S, Hkv, 2d // n_heads)``, one KV cache a site;
* enc-dec (whisper): ``self: {k, v}`` ``(L, B, S, Hkv, hd)`` and
  ``cross: {k, v}`` ``(L, B, enc_seq, Hkv, hd)``, the decoder's cross
  keys and values, computed from the encoder output once at prefill and
  only read by decode (``pad_seq`` never pads them: their axis is the
  encoder's frames).

The pool leaves of ``serve.BlockPool`` are the same cache evaluated at
``batch = n_pages, max_seq = page_size``, so their second axis is the page
id (for the SSM family a "page" is a whole state slot).  Layers run in
order over ``lm.layers_of`` (the MoE family's leading dense layers, then
its MoE layers); cache index ``i`` is layer ``i``.

Decode updates its cache in place: the contiguous path writes the new
attention entries at ``pos`` (or the SSM and hybrid trunks' new state over
the old), the paged path has the kernel (K10 for GQA, K11 for MLA) write
the new cell of the pool.  The paged path takes the attention families
(dense, MoE, VLM) only, as the reference's.  ``prefill`` and
``decode_step`` take the reference's ``extra`` inputs: ``vis_embeds``
(B, V, d) for the VLM family, ``frames`` (B, F, d) for the enc-dec
family's prefill.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.dist.act_sharding import lookup
from repro_torch.kernels.paged_attention import ops as paged_ops

from . import mla as mla_mod
from . import ssm as ssm_mod
from . import lm
from .layers import (_qkv, _sin_cos, attention, attention_decode,
                     cross_attend, cross_kv, mlp, rmsnorm, sinusoidal_pos,
                     torch_dtype)
from .lm import attend, check_family, ffn, layers_of, logits_fn

Params = Dict[str, object]


def _layer(cache: Params, i: int) -> Params:
    return {k: v[i] for k, v in cache.items()}


# =============================================================================
# cache init
# =============================================================================

def _stack(caches) -> Params:
    """Per-layer caches (dicts of tensors, possibly nested) stacked on a
    new leading axis: a copy, never a view of a layer's tensors."""
    return {k: (_stack([c[k] for c in caches])
                if isinstance(caches[0][k], dict)
                else torch.stack([c[k] for c in caches]))
            for k in caches[0]}


def init_cache(cfg, batch: int, max_seq: int,
               device: torch.device) -> Params:
    check_family(cfg, "init_cache")
    L, dt = cfg.n_layers, torch_dtype(cfg)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(layers, heads, hd, seq):
        return {"k": zeros(layers, batch, seq, heads, hd, dtype=dt),
                "v": zeros(layers, batch, seq, heads, hd, dtype=dt)}

    if cfg.family == "ssm":
        return {"conv": zeros(L, batch, cfg.d_conv - 1, cfg.d_inner),
                "h": zeros(L, batch, cfg.d_inner, cfg.ssm_state)}
    if cfg.family == "hybrid":
        k, n, scfg = cfg.d_conv - 1, cfg.ssm_state, lm.shared_cfg(cfg)
        return {"conv_x": zeros(L, batch, k, cfg.d_inner),
                "conv_b": zeros(L, batch, k, n),
                "conv_c": zeros(L, batch, k, n),
                "h": zeros(L, batch, cfg.n_ssm_heads, cfg.ssm_headdim, n),
                "shared": kv(lm.n_sites(cfg), scfg.n_kv_heads, scfg.hd,
                             max_seq)}
    if cfg.family == "encdec":
        return {"self": kv(L, cfg.n_kv_heads, cfg.hd, max_seq),
                "cross": kv(L, cfg.n_kv_heads, cfg.hd, cfg.enc_seq)}
    if cfg.mla:
        return {k: zeros(L, batch, max_seq, w, dtype=dt)
                for k, w in (("c_kv", cfg.kv_lora_rank),
                             ("k_rope", cfg.qk_rope_dim))}
    return kv(L, cfg.n_kv_heads, cfg.hd, max_seq)


# the cache leaves with a sequence axis, and the nested caches that hold
# them; the SSM states have none, and the enc-dec ``cross`` K/V's axis is
# the encoder's frames, fixed at prefill
SEQ_LEAVES = ("k", "v", "c_kv", "k_rope")
SEQ_NESTS = ("shared", "self")


def pad_seq(cache: Params, extra: int) -> Params:
    """Each sequence leaf ``(L, B, S, ...)`` padded with ``extra`` zero
    positions on the sequence axis, at the top level and inside the
    hybrid ``shared`` and the enc-dec ``self`` caches; the SSM states,
    O(1) in the sequence, and the enc-dec ``cross`` cache are returned as
    they are."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = pad_seq(v, extra) if k in SEQ_NESTS else v
        elif k in SEQ_LEAVES:
            out[k] = torch.nn.functional.pad(v, [0, 0] * (v.dim() - 3)
                                             + [0, extra])
        else:
            out[k] = v
    return out


# =============================================================================
# prefill — forward over the prompt, emitting the cache
# =============================================================================

def prefill(params: Params, cfg, tokens: torch.Tensor,
            extra: Optional[Dict[str, torch.Tensor]] = None):
    """tokens (B,S) → (last-token logits (B,V), the cache of
    :func:`init_cache`'s layout at ``max_seq = S'``, next_pos (B,) int32
    = S').  S' = V + S for the VLM family (``extra["vis_embeds"]``), else
    S; the enc-dec family's encoder reads ``extra["frames"]``."""
    check_family(cfg, "prefill")
    extra = extra or {}
    x, positions = lm.embed_inputs(params, cfg, tokens, extra)
    if cfg.family == "hybrid":
        x, cache = _hybrid_prefill(params, cfg, x, positions)
    elif cfg.family == "encdec":
        x, cache = _encdec_prefill(params, cfg, x, positions, extra)
    else:
        caches = []
        for lp, is_moe in layers_of(params):
            if cfg.family == "ssm":
                y, st = ssm_mod.mamba1_apply(
                    lp["mamba"], cfg, rmsnorm(lp["norm"], x, cfg.norm_eps),
                    return_state=True)
                x = x + y
                caches.append(st)
                continue
            a, kv = attend(lp["attn"], cfg,
                           rmsnorm(lp["attn_norm"], x, cfg.norm_eps),
                           positions, return_cache=True)
            x = x + a
            y, _ = ffn(lp, cfg, rmsnorm(lp["mlp_norm"], x, cfg.norm_eps),
                       is_moe)
            x = x + y
            caches.append(kv)
        cache = _stack(caches)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_fn(params, cfg, x[:, -1])
    next_pos = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                          device=x.device)
    return logits, cache, next_pos


def _hybrid_prefill(params: Params, cfg, x: torch.Tensor,
                    positions: torch.Tensor):
    """The hybrid trunk of ``lm.forward`` emitting each layer's Mamba2
    state and each site's shared-attention K/V."""
    emb0 = x
    shared = lm._unbind(params["shared"])
    site_proj = params["site_proj"].unbind(0)
    trunk, kvs = [], []

    def attend_kv(p, c, u):
        a, (k, v) = attention(p, c, u, positions, return_kv=True)
        return a, {"k": k, "v": v}

    for i, lp in enumerate(lm._unbind(params["layers"])):
        y, st = ssm_mod.mamba2_apply(lp["mamba"], cfg,
                                     rmsnorm(lp["norm"], x, cfg.norm_eps),
                                     return_state=True)
        x = x + y
        trunk.append(st)
        site = lm.hybrid_site_after(cfg, i)
        if site is not None:
            x, kv = lm.shared_block(shared[site % cfg.n_shared_blocks],
                                    site_proj[site], cfg, x, emb0, attend_kv)
            kvs.append(kv)
    cache = _stack(trunk)
    cache["shared"] = _stack(kvs)
    return x, cache


def _encdec_prefill(params: Params, cfg, x: torch.Tensor,
                    positions: torch.Tensor, extra: Dict[str, torch.Tensor]):
    """The encoder once, then the decoder over the prompt emitting each
    layer's self-attention K/V and its cross K/V of the encoder output
    (computed here once; decode only reads them)."""
    e = lm.encode(params, cfg, extra["frames"], x.dtype)
    x = x + sinusoidal_pos(x.shape[1], cfg.d_model,
                           device=x.device).to(x.dtype)
    selfs, crosses = [], []
    for lp in lm._unbind(params["dec_layers"]):
        a, (k, v) = attention(lp["attn"], cfg,
                              rmsnorm(lp["attn_norm"], x, cfg.norm_eps),
                              positions, return_kv=True)
        x = x + a
        ck, cv = cross_kv(lp["cross"], cfg, e)
        x = x + cross_attend(lp["cross"], cfg,
                             rmsnorm(lp["cross_norm"], x, cfg.norm_eps),
                             ck, cv)
        x = x + mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], x, cfg.norm_eps))
        selfs.append({"k": k, "v": v})
        crosses.append({"k": ck, "v": cv})
    return x, {"self": _stack(selfs), "cross": _stack(crosses)}


# =============================================================================
# decode — one token against the cache
# =============================================================================

def decode_step(params: Params, cfg, cache: Params, tokens: torch.Tensor,
                pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """tokens (B,1), pos (B,) → (logits (B,V), cache).  Writes each
    layer's new cache entries at ``pos`` in place (the SSM and hybrid
    trunks: their new conv windows and states over the old; the enc-dec
    ``cross`` cache is only read)."""
    check_family(cfg, "decode_step")
    x = lookup(params["embed"]["tok"], tokens.long())
    if cfg.family == "hybrid":
        x = _decode_hybrid(params, cfg, cache, x, pos)
    elif cfg.family == "encdec":
        x = _decode_encdec(params, cfg, cache, x, pos)
    else:
        for i, (lp, is_moe) in enumerate(layers_of(params)):
            if cfg.family == "ssm":
                cl = _layer(cache, i)
                y, st = ssm_mod.mamba1_decode(
                    lp["mamba"], cfg, rmsnorm(lp["norm"], x, cfg.norm_eps),
                    cl)
                for k, v in st.items():
                    cl[k].copy_(v)
                x = x + y
                continue
            hn = rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
            cl = _layer(cache, i)
            if cfg.mla:
                a, _ = mla_mod.mla_decode(lp["attn"], cfg, hn, cl, pos)
            else:
                a, _ = attention_decode(lp["attn"], cfg, hn,
                                        (cl["k"], cl["v"]), pos)
            x = x + a
            y, _ = ffn(lp, cfg, rmsnorm(lp["mlp_norm"], x, cfg.norm_eps),
                       is_moe)
            x = x + y
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x[:, 0]), cache


TRUNK_LEAVES = ("conv_x", "conv_b", "conv_c", "h")


def _decode_hybrid(params: Params, cfg, cache: Params, x: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    emb0 = x
    shared = lm._unbind(params["shared"])
    site_proj = params["site_proj"].unbind(0)
    for i, lp in enumerate(lm._unbind(params["layers"])):
        cl = {k: cache[k][i] for k in TRUNK_LEAVES}
        y, st = ssm_mod.mamba2_decode(lp["mamba"], cfg,
                                      rmsnorm(lp["norm"], x, cfg.norm_eps),
                                      cl)
        for k, v in st.items():
            cl[k].copy_(v)
        x = x + y
        site = lm.hybrid_site_after(cfg, i)
        if site is None:
            continue
        kv = _layer(cache["shared"], site)
        x, _ = lm.shared_block(
            shared[site % cfg.n_shared_blocks], site_proj[site], cfg, x,
            emb0, lambda p, c, u: attention_decode(p, c, u, (kv["k"],
                                                             kv["v"]), pos))
    return x


def _sin_pos_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embedding at per-row positions: (B,) → (B,1,d)."""
    return _sin_cos(pos[:, None].float(), d)[:, None]


def _decode_encdec(params: Params, cfg, cache: Params, x: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    x = x + _sin_pos_at(pos, cfg.d_model).to(x.dtype)
    for i, lp in enumerate(lm._unbind(params["dec_layers"])):
        cs, cc = _layer(cache["self"], i), _layer(cache["cross"], i)
        a, _ = attention_decode(lp["attn"], cfg,
                                rmsnorm(lp["attn_norm"], x, cfg.norm_eps),
                                (cs["k"], cs["v"]), pos)
        x = x + a
        # cross attention against the prefill's encoder K/V
        x = x + cross_attend(lp["cross"], cfg,
                             rmsnorm(lp["cross_norm"], x, cfg.norm_eps),
                             cc["k"], cc["v"])
        x = x + mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], x, cfg.norm_eps))
    return x


def decode_step_paged(params: Params, cfg, leaves: Params,
                      page_rows: torch.Tensor, tokens: torch.Tensor,
                      pos: torch.Tensor, *,
                      page_size: int) -> Tuple[torch.Tensor, Params]:
    """One decode step straight against the block pool: tokens (B,1),
    page_rows (B, max_pages), pos (B,) → (logits (B,V), leaves).  Per
    layer, the paged-attention kernel (``kernels/paged_attention``: K10
    for GQA, K11 for MLA) walks each slot's pages and writes the new
    token's cache cell into its ``(page, offset)`` place in place — no
    gather, no scatter.  The non-cache halves are those of
    :func:`decode_step`."""
    check_family(cfg, "decode_step_paged")
    if cfg.family in ("hybrid", "encdec"):
        raise ValueError(f"decode_step_paged supports attention families, "
                         f"not {cfg.family!r} ({cfg.name})")
    if cfg.family == "ssm":
        raise ValueError(
            f"decode_step_paged: {cfg.name!r} is an SSM, whose O(1) state "
            f"is not paged (the reference has no paged SSM path); decode "
            f"it with decode_step")
    x = params["embed"]["tok"][tokens.long()]
    page_rows = page_rows.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    for i, (lp, is_moe) in enumerate(layers_of(params)):
        x = _paged_decode_block(lp, cfg, x, _layer(leaves, i), page_rows,
                                pos, page_size, is_moe)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x[:, 0]), leaves


def _paged_decode_block(lp: Params, cfg, h: torch.Tensor, leaf: Params,
                        page_rows: torch.Tensor, pos: torch.Tensor,
                        page_size: int, is_moe: bool) -> torch.Tensor:
    """One decoder layer against its pool slices (``(P, ps, Hkv, hd)`` or
    ``(P, ps, lat)`` / ``(P, ps, rope)``) — the paged twin of a
    :func:`decode_step` layer."""
    b = h.shape[0]
    hn = rmsnorm(lp["attn_norm"], h, cfg.norm_eps)
    p = lp["attn"]
    if cfg.mla:
        q_nope, q_rope = mla_mod._mla_q(p, cfg, hn, pos[:, None])
        c_new, r_new = mla_mod._mla_kv_latent(p, cfg, hn, pos[:, None])
        w_uk, w_uv = mla_mod.absorbed_weights(p, cfg)
        q_eff = torch.einsum("bqhn,lhn->bqhl", q_nope, w_uk)
        ctx, _, _ = paged_ops.paged_mla_decode(
            q_eff[:, 0].contiguous(), q_rope[:, 0].contiguous(),
            c_new[:, 0].contiguous(), r_new[:, 0].contiguous(),
            leaf["c_kv"], leaf["k_rope"], page_rows, pos,
            page_size=page_size,
            scale=(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
        o = torch.einsum("bhl,lhv->bhv", ctx.to(h.dtype), w_uv)
    else:
        q, k, v = _qkv(p, cfg, hn, pos[:, None])
        o, _, _ = paged_ops.paged_gqa_decode(
            q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
            leaf["k"], leaf["v"], page_rows, pos, page_size=page_size)
    h = h + o.to(h.dtype).reshape(b, 1, -1) @ p["wo"]
    y, _ = ffn(lp, cfg, rmsnorm(lp["mlp_norm"], h, cfg.norm_eps), is_moe)
    return h + y


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
