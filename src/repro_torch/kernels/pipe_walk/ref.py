"""Plain PyTorch versions of the pipeline walk's three row bodies: the
port of the ``fwd`` / ``bwd`` / ``upd`` branches of
``repro/engine/megakernel.py::_pipe_kernel`` (the canonical uniform dense
stage ``tanh(x @ w + b)`` with the mean-squared-error loss).

``engine.megakernel.pipe_walk_plain`` applies them row by row to the
walk's state; on CPU tensors that is what the engine runs, and on the card
``chip_smoke.py`` holds the CUDA walk against it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def fwd_ref(inp: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """F: the stage output ``h = tanh(inp @ w + b)`` of a (Bt, D) input."""
    return torch.tanh(inp @ w + b[None])


def loss_seed_ref(h: torch.Tensor, y: torch.Tensor,
                  inv_numel: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """F on the last stage: the microbatch loss ``mean((h - y)^2)`` (as the
    sum times ``inv_numel`` = 1/(Bt·D)) and the cotangent it seeds,
    ``(2/numel)(h - y)``."""
    diff = h - y
    return (diff * diff).sum() * inv_numel, (2.0 * inv_numel) * diff


def bwd_ref(inp: torch.Tensor, h: torch.Tensor, cot: torch.Tensor,
            w: torch.Tensor, first: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """B: with ``g = cot * (1 - h^2)`` (tanh' of the stored output), the
    row's additions to the stage gradients, ``inpᵀ g`` and ``Σ_rows g``,
    and the cotangent ``g wᵀ`` that flows to the previous stage (none on
    the first stage)."""
    g = cot * (1.0 - h * h)
    cot_in = None if first else g @ w.T
    return inp.T @ g, g.sum(0), cot_in


def upd_ref(gw: torch.Tensor, gb: torch.Tensor,
            inv_m: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """U: the microbatch average of a stage's gradients (the optimizer
    step is the caller's)."""
    return gw * inv_m, gb * inv_m
