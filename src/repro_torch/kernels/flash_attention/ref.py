"""Plain version of the flash-attention kernel: the port of
``repro/kernels/flash_attention/ref.py``, softmax attention over
(BH, S, hd) with an optional causal mask (aligned at the top left), the
scores and the softmax in float32.  On the CPU it is what the kernel's
wrapper runs; on the card ``chip_smoke.py`` holds the CUDA kernel against
it."""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, hd); k,v: (BH, Sk, hd) → (BH, Sq, hd) in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask[None], float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
