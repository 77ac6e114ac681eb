"""``lax.scan`` over a layer stack, as a Python loop.  The port of
``repro/models/scan_util.py``.

The reference unrolls when ``cfg.scan_layers=False`` (the dry run's depth
probes: XLA counts a scanned body once); eager PyTorch has no scan, so
both settings run the same loop, and every layer is counted.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim.tree import leaves, tree_map


def scan_layers(cfg, f: Callable, init, xs):
    """Semantics of ``jax.lax.scan(f, init, xs)`` (xs stacked on axis 0):
    ``(carry, ys)`` with ``ys`` stacked on a new axis 0, or None when
    ``f`` returns no ``y``."""
    del cfg
    n = leaves(xs)[0].shape[0]
    carry = init
    ys = []
    for i in range(n):
        carry, y = f(carry, tree_map(lambda a: a[i], xs))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *zs: torch.stack(zs), *ys)
