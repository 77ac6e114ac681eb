"""Parameters and optimizer state from the reference's layout to the
port's.

``params_from_reference(tree, cfg)`` takes the reference's parameter tree
(``repro.models.lm.init_params`` for every family: dense, MoE with GQA
or MLA, SSM, hybrid, enc-dec and VLM, with every leaf turned into a
numpy array by the caller) and returns
the port's tree of tensors: the same nested keys, the same stacked
``(L, ...)`` layout, the same dtypes.  ``opt_state_from_reference`` does
the same for the reference's ``OptState`` (AdamW's ``m``, ``v``;
Adafactor's ``vr``, ``vc`` or ``v`` a leaf).  This module imports nothing
of ``repro`` or jax: the tests hand it numpy arrays, so the port and the
reference run on identical weights and state.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.optim import OptState

from .lm import check_family, n_sites, shared_cfg


def _tensor(a: Any, device) -> torch.Tensor:
    a = np.array(a)                   # a writable copy
    if a.dtype.name == "bfloat16":    # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _convert(tree: Mapping, device) -> Dict:
    return {k: (_convert(v, device) if isinstance(v, Mapping)
                else _tensor(v, device)) for k, v in tree.items()}


def _prefixed(prefix: str, shapes: Dict[str, tuple],
              lead: tuple = ()) -> Dict[str, tuple]:
    return {f"{prefix}/{k}": lead + v for k, v in shapes.items()}


def _attn_shapes(cfg) -> Dict[str, tuple]:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    if cfg.mla:
        lat, qk = cfg.kv_lora_rank, cfg.qk_nope_dim + cfg.qk_rope_dim
        return {"wq_a": (d, cfg.q_lora_rank),
                "q_norm/scale": (cfg.q_lora_rank,),
                "wq_b": (cfg.q_lora_rank, h * qk),
                "wkv_a": (d, lat + cfg.qk_rope_dim),
                "kv_norm/scale": (lat,),
                "wkv_b": (lat, h * (cfg.qk_nope_dim + cfg.v_head_dim)),
                "wo": (h * cfg.v_head_dim, d)}
    shapes = {"wq": (d, h * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (h * hd, d)}
    if cfg.qk_norm:
        shapes.update({"q_norm/scale": (hd,), "k_norm/scale": (hd,)})
    return shapes


def _layer_shapes(cfg, moe: bool) -> Dict[str, tuple]:
    d, f = cfg.d_model, cfg.moe_d_ff
    shapes = {"attn_norm/scale": (d,), "mlp_norm/scale": (d,)}
    shapes.update(_prefixed("attn", _attn_shapes(cfg)))
    if not moe:
        ffn = {"mlp/w_gate": (d, cfg.d_ff), "mlp/w_up": (d, cfg.d_ff),
               "mlp/w_down": (cfg.d_ff, d)}
    else:
        e, fs = cfg.n_experts, f * cfg.n_shared_experts
        ffn = {"moe/router": (d, e), "moe/w_gate": (e, d, f),
               "moe/w_up": (e, d, f), "moe/w_down": (e, f, d)}
        if cfg.n_shared_experts:
            ffn.update({"moe/shared/w_gate": (d, fs),
                        "moe/shared/w_up": (d, fs),
                        "moe/shared/w_down": (fs, d)})
    shapes.update(ffn)
    return shapes


def _ssm_layer_shapes(cfg) -> Dict[str, tuple]:
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dtr
    mamba = {"in_proj": (d, 2 * di), "conv_w": (di, cfg.d_conv),
             "conv_b": (di,), "x_proj": (di, dtr + 2 * n),
             "dt_proj": (dtr, di), "dt_bias": (di,), "a_log": (di, n),
             "d_skip": (di,), "out_proj": (di, d)}
    return {"norm/scale": (d,), **_prefixed("mamba", mamba)}


def _hybrid_layer_shapes(cfg) -> Dict[str, tuple]:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    k = cfg.d_conv
    mamba = {"in_z": (d, di), "in_x": (d, di), "in_b": (d, n),
             "in_c": (d, n), "in_dt": (d, h), "conv_w_x": (di, k),
             "conv_b_x": (di,), "conv_w_b": (n, k), "conv_b_b": (n,),
             "conv_w_c": (n, k), "conv_b_c": (n,), "dt_bias": (h,),
             "a_log": (h,), "d_skip": (h,), "norm/scale": (di,),
             "out_proj": (di, d)}
    return {"norm/scale": (d,), **_prefixed("mamba", mamba)}


def _shared_block_shapes(cfg) -> Dict[str, tuple]:
    scfg = shared_cfg(cfg)
    d2 = scfg.d_model
    return {"norm/scale": (d2,), "mlp_norm/scale": (d2,),
            **_prefixed("attn", _attn_shapes(scfg)),
            "mlp/w_gate": (d2, cfg.d_ff), "mlp/w_up": (d2, cfg.d_ff),
            "mlp/w_down": (cfg.d_ff, d2)}


def _expected_shapes(cfg) -> Dict[str, tuple]:
    d = cfg.d_model
    shapes = {"embed/tok": (cfg.vocab, d), "final_norm/scale": (d,)}
    if not cfg.tie_embeddings:
        shapes["embed/head"] = (d, cfg.vocab)
    fam, L = cfg.family, cfg.n_layers
    if fam == "ssm":
        shapes.update(_prefixed("layers", _ssm_layer_shapes(cfg), (L,)))
        return shapes
    if fam == "hybrid":
        shapes.update(_prefixed("layers", _hybrid_layer_shapes(cfg), (L,)))
        shapes.update(_prefixed("shared", _shared_block_shapes(cfg),
                                (cfg.n_shared_blocks,)))
        shapes["site_proj"] = (n_sites(cfg), 2 * d, d)
        return shapes
    if fam == "encdec":
        layer = _layer_shapes(cfg, False)
        cross = {"cross_norm/scale": (d,),
                 **_prefixed("cross", _attn_shapes(cfg))}
        shapes.update(_prefixed("enc_layers", layer, (cfg.enc_layers,)))
        shapes.update(_prefixed("dec_layers", {**layer, **cross}, (L,)))
        shapes["enc_norm/scale"] = (d,)
        return shapes
    if fam in ("dense", "vlm"):
        stacks = (("layers", L, False),)
    else:
        nd = cfg.first_dense_layers
        stacks = ((("dense_layers", nd, False),) if nd else ()) + (
            ("moe_layers", L - nd, True),)
    for key, n, moe in stacks:
        shapes.update(_prefixed(key, _layer_shapes(cfg, moe), (n,)))
    return shapes


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_reference(tree: Mapping, cfg,
                          device: Optional[torch.device] = None) -> Dict:
    """The reference's parameter tree (numpy leaves) as the port's
    tensors on ``device`` (the CPU by default).  Raises if a key or a
    shape differs from what ``cfg`` implies."""
    check_family(cfg, "params_from_reference")
    params = _convert(tree, torch.device("cpu") if device is None
                      else device)
    _check({k: tuple(v.shape) for k, v in _flat(params).items()},
           _expected_shapes(cfg), f"parameter tree does not match {cfg.name}")
    return params


def _check(got: Dict[str, tuple], want: Dict[str, tuple], what: str) -> None:
    if got != want:
        raise ValueError(f"{what}: missing {sorted(set(want) - set(got))}, "
                         f"extra {sorted(set(got) - set(want))}, shapes "
                         f"{ {k: (got[k], want[k]) for k in got if k in want and got[k] != want[k]} }")


def _moment_shapes(cfg, optimizer: str) -> Dict[str, tuple]:
    params = _expected_shapes(cfg)
    if optimizer == "adamw":
        return {f"{m}/{k}": v for m in ("m", "v") for k, v in params.items()}
    out = {}
    for k, v in params.items():
        if len(v) >= 2:
            out[f"{k}/vr"] = v[:-1]
            out[f"{k}/vc"] = v[:-2] + v[-1:]
        else:
            out[f"{k}/v"] = v
    return out


def opt_state_from_reference(opt_state: Any, cfg,
                             device: Optional[torch.device] = None
                             ) -> OptState:
    """The reference's ``OptState(step, inner)`` (numpy leaves) as the
    port's: an int32 step and float32 moments on ``device`` (the CPU by
    default).  AdamW's state is told from Adafactor's by its ``inner``
    keys (``m``, ``v``).  Raises if a key or a shape differs from what
    ``cfg`` implies for that optimizer."""
    check_family(cfg, "opt_state_from_reference")
    dev = torch.device("cpu") if device is None else device
    step, inner = opt_state
    optimizer = ("adamw" if isinstance(inner, Mapping)
                 and set(inner) == {"m", "v"} else "adafactor")
    moments = _convert(inner, dev)
    flat = _flat(moments)
    _check({k: tuple(v.shape) for k, v in flat.items()},
           _moment_shapes(cfg, optimizer),
           f"{optimizer} state does not match {cfg.name}")
    bad = sorted(k for k, v in flat.items() if v.dtype != torch.float32)
    if bad:
        raise ValueError(f"moments must be float32: {bad}")
    return OptState(_tensor(np.asarray(step, np.int32), dev), moments)
