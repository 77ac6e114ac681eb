"""Topological ordering, cycle detection and critical-path weights (paper §3.1).

``weight_i = cost_i + max_{j in unlocks_i} weight_j``

computed by traversing the DAG in *reverse* topological order (Kahn 1962),
O(V+E).  The weight of a task is the total cost of the critical path that
starts at it; queues prioritise the largest weight first.

Port note: a copy of ``repro.core.weights`` (pure Python).  ``repro_torch``
imports nothing of ``repro``, so it keeps its own copy.
"""

from __future__ import annotations

from collections import deque
from typing import List, Sequence, Tuple


def toposort(n: int, unlocks: Sequence[Sequence[int]]) -> List[int]:
    """Kahn's algorithm over the ``unlocks`` adjacency (A unlocks B == B
    depends on A).  Returns task ids in topological order.  Raises
    ``ValueError`` on a dependency cycle."""
    indeg = [0] * n
    for src in range(n):
        for dst in unlocks[src]:
            indeg[dst] += 1
    q = deque(i for i in range(n) if indeg[i] == 0)
    order: List[int] = []
    while q:
        i = q.popleft()
        order.append(i)
        for j in unlocks[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                q.append(j)
    if len(order) != n:
        cyclic = [i for i in range(n) if indeg[i] > 0]
        raise ValueError(
            f"dependency cycle detected involving {len(cyclic)} tasks "
            f"(e.g. ids {cyclic[:8]})"
        )
    return order


def critical_path_weights(
    n: int, unlocks: Sequence[Sequence[int]], costs: Sequence[float]
) -> Tuple[List[float], List[int]]:
    """Return (weights, toposort order).  weights follow the paper's
    recurrence; the order is reused by callers (e.g. wait-counter init)."""
    order = toposort(n, unlocks)
    weights = [0.0] * n
    for i in reversed(order):
        w = 0.0
        for j in unlocks[i]:
            if weights[j] > w:
                w = weights[j]
        weights[i] = costs[i] + w
    return weights, order


def critical_path_length(
    n: int, unlocks: Sequence[Sequence[int]], costs: Sequence[float]
) -> float:
    """Length of the longest cost-weighted path in the DAG — the lower bound
    on makespan for any number of workers."""
    if n == 0:
        return 0.0
    weights, _ = critical_path_weights(n, unlocks, costs)
    return max(weights)
