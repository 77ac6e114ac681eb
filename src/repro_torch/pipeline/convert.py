"""Carry the reference's pipeline inputs across: its stage parameters
(``[{"w": (D, D), "b": (D,)}, ...]``) and microbatches (``[{"x": (Bt, D),
"y": (Bt, D)}, ...]``), given as numpy arrays (or anything ``np.asarray``
takes), become the port's float32 tensors on one device, so that both
packages compute the same value-and-grad (``tests/test_torch_pipeline.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def _tensors(tree: Mapping[str, Any], dev: torch.device
             ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in tree.items()}


def pipeline_inputs(stage_params: Sequence[Mapping[str, Any]],
                    microbatches: Sequence[Mapping[str, Any]], device=None
                    ) -> Tuple[List[Dict[str, torch.Tensor]],
                               List[Dict[str, torch.Tensor]]]:
    """The stage parameters and microbatches as float32 tensors on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return ([_tensors(p, dev) for p in stage_params],
            [_tensors(mb, dev) for mb in microbatches])
