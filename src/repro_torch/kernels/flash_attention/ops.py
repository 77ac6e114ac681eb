"""Public op: the model-layout wrapper of the flash-attention kernel, the
port of ``repro/kernels/flash_attention/ops.py``.

Accepts (B, S, H, hd) like the model's sdpa paths, pads S to block
multiples, flattens (B, H) into the kernel's grid.  CPU tensors take the
plain version (``kernel.flash_attention`` counts it in ``PLAIN_CALLS``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel, ref


def _to_bh(x: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = x.shape
    return x.transpose(1, 2).reshape(b * h, s, hd)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, block_q: int = 128,
                         block_k: int = 128) -> torch.Tensor:
    """q,k,v: (B, S, H, hd) → (B, S, H, hd)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qf, kf, vf = _to_bh(q), _to_bh(k), _to_bh(v)
    pq = (-sq) % block_q
    pk = (-sk) % block_k
    if pq:
        qf = F.pad(qf, (0, 0, 0, pq))
    if pk:
        # zero keys past Sk lie right of every real query row, so the causal
        # mask hides them; without the mask nothing would, so a ragged Sk
        # needs causal attention (as the reference asserts)
        if not causal:
            raise ValueError("non-causal requires Sk % block_k == 0")
        kf = F.pad(kf, (0, 0, 0, pk))
        vf = F.pad(vf, (0, 0, 0, pk))
    o = kernel.flash_attention(qf, kf, vf, causal=causal, block_q=block_q,
                               block_k=block_k)
    o = o[:, :sq]
    return o.reshape(b, h, sq, hd).transpose(1, 2)


def attention_ref_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True) -> torch.Tensor:
    b, sq, h, hd = q.shape
    o = ref.attention_ref(_to_bh(q), _to_bh(k), _to_bh(v), causal=causal)
    return o.reshape(b, h, sq, hd).transpose(1, 2)
