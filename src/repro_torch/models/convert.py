"""Parameters from the reference's layout to the port's.

``params_from_reference(tree, cfg)`` takes the reference's parameter tree
(``repro.models.lm.init_params`` for the dense family, with every leaf
turned into a numpy array by the caller) and returns the port's tree of
tensors: the same nested keys, the same stacked ``(L, ...)`` layout, the
same dtypes.  This module imports nothing of ``repro`` or jax: the tests
hand it numpy arrays, so the port and the reference run on identical
weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .lm import check_family


def _tensor(a: Any, device) -> torch.Tensor:
    a = np.array(a)                   # a writable copy
    if a.dtype.name == "bfloat16":    # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _convert(tree: Mapping, device) -> Dict:
    return {k: (_convert(v, device) if isinstance(v, Mapping)
                else _tensor(v, device)) for k, v in tree.items()}


def _expected_shapes(cfg) -> Dict[str, tuple]:
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers
    shapes = {"embed/tok": (cfg.vocab, d), "final_norm/scale": (d,),
              "layers/attn_norm/scale": (L, d),
              "layers/attn/wq": (L, d, cfg.n_heads * hd),
              "layers/attn/wk": (L, d, cfg.n_kv_heads * hd),
              "layers/attn/wv": (L, d, cfg.n_kv_heads * hd),
              "layers/attn/wo": (L, cfg.n_heads * hd, d),
              "layers/mlp_norm/scale": (L, d),
              "layers/mlp/w_gate": (L, d, cfg.d_ff),
              "layers/mlp/w_up": (L, d, cfg.d_ff),
              "layers/mlp/w_down": (L, cfg.d_ff, d)}
    if not cfg.tie_embeddings:
        shapes["embed/head"] = (d, cfg.vocab)
    if cfg.qk_norm:
        shapes["layers/attn/q_norm/scale"] = (L, hd)
        shapes["layers/attn/k_norm/scale"] = (L, hd)
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
    """The reference's dense parameter tree (numpy leaves) as the port's
    tensors on ``device`` (the CPU by default).  Raises if a key or a
    shape differs from what ``cfg`` implies."""
    check_family(cfg, "params_from_reference")
    params = _convert(tree, torch.device("cpu") if device is None
                      else device)
    got = {k: tuple(v.shape) for k, v in _flat(params).items()}
    want = _expected_shapes(cfg)
    if got != want:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"missing {sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}, shapes "
                         f"{ {k: (got[k], want[k]) for k in got if k in want and got[k] != want[k]} }")
    return params
