"""Array-native compiled task-graph representation (numpy struct-of-arrays).

``QSched`` accumulates the graph as flat COO edge lists during construction
(cheap ``list.append`` per call, no per-task objects); ``prepare()`` compiles
them into this CSR form once per structural version.  Everything downstream
— the vectorized Kahn toposort, the critical-path sweep, wait-counter
initialisation, and the ``ExecutionPlan`` lowering — runs over these arrays
instead of walking per-task Python objects.

The toposort processes the DAG level-by-level: each iteration gathers the
out-edges of the whole frontier with one CSR multi-slice (``csr_gather``),
decrements in-degrees with ``bincount``, and emits the next frontier with
``flatnonzero``.  The level structure is kept (``level_ptr``) so the
critical-path sweep can run one vectorized segment-max per level in reverse.
The float operations per task are identical to the reference implementation
in ``weights.py`` (``cost[i] + max(weight[succ])``), so the weights agree
bitwise — property-tested in ``tests/test_plan.py``.

Port note: a copy of ``repro.core.arrays``.  ``repro_torch`` imports nothing of
``repro`` (not even its jax-free modules), so it keeps its own copy.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def coo_to_csr(n: int, src: Sequence[int], dst: Sequence[int],
               sort_cols: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Compile COO edge lists into CSR (indptr, indices).

    Insertion order is preserved within a row (stable sort) unless
    ``sort_cols`` is set, which additionally sorts each row's columns
    ascending — used for lock lists (paper §3.3 deadlock-avoidance order).
    """
    s = np.asarray(src, dtype=np.int64)
    d = np.asarray(dst, dtype=np.int64)
    if sort_cols and s.size:
        perm = np.lexsort((d, s))
    elif s.size:
        perm = np.argsort(s, kind="stable")
    else:
        perm = np.empty(0, dtype=np.int64)
    indices = d[perm] if perm.size else d
    counts = np.bincount(s, minlength=n) if s.size else np.zeros(n, np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices


def csr_gather(indptr: np.ndarray, indices: np.ndarray,
               nodes: np.ndarray) -> np.ndarray:
    """Concatenate ``indices[indptr[i]:indptr[i+1]]`` for every i in
    ``nodes``, fully vectorized.  Output stays grouped by node (segments in
    ``nodes`` order), which ``np.maximum.reduceat`` relies on."""
    deg = indptr[nodes + 1] - indptr[nodes]
    total = int(deg.sum())
    if total == 0:
        return indices[:0]
    cum = np.cumsum(deg)
    pos = (np.repeat(indptr[nodes] - (cum - deg), deg)
           + np.arange(total, dtype=np.int64))
    return indices[pos]


def toposort_levels(n: int, indptr: np.ndarray, indices: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Vectorized Kahn's algorithm.  Returns (order, level_ptr, level_succ)
    where ``order[level_ptr[k]:level_ptr[k+1]]`` is the k-th dependency
    level and ``level_succ[k]`` is the gathered successor array of that
    level (kept for the critical-path sweep, which re-walks the same
    frontiers).  Raises ``ValueError`` on a cycle (same contract as
    ``weights.toposort``)."""
    indeg = (np.bincount(indices, minlength=n).astype(np.int64)
             if indices.size else np.zeros(n, np.int64))
    frontier = np.flatnonzero(indeg == 0)
    order = np.empty(n, dtype=np.int64)
    level_ptr = [0]
    level_succ: List[np.ndarray] = []
    filled = 0
    while frontier.size:
        order[filled:filled + frontier.size] = frontier
        filled += frontier.size
        level_ptr.append(filled)
        succ = csr_gather(indptr, indices, frontier)
        level_succ.append(succ)
        if succ.size == 0:
            break
        dec = np.bincount(succ, minlength=n)
        indeg -= dec
        frontier = np.flatnonzero((indeg == 0) & (dec > 0))
    if filled != n:
        cyclic = np.flatnonzero(indeg > 0)
        raise ValueError(
            f"dependency cycle detected involving {cyclic.size} tasks "
            f"(e.g. ids {cyclic[:8].tolist()})"
        )
    return order, np.asarray(level_ptr, dtype=np.int64), level_succ


def critical_path_sweep(n: int, indptr: np.ndarray, indices: np.ndarray,
                        cost: np.ndarray, order: np.ndarray,
                        level_ptr: np.ndarray,
                        level_succ: List[np.ndarray]) -> np.ndarray:
    """Paper §3.1 recurrence ``w_i = cost_i + max_j∈unlocks(i) w_j`` as one
    vectorized segment-max per level, deepest level first, reusing the
    successor gathers recorded by ``toposort_levels``."""
    weight = np.zeros(n, dtype=np.float64)
    for lv in range(len(level_ptr) - 2, -1, -1):
        nodes = order[level_ptr[lv]:level_ptr[lv + 1]]
        succ = (level_succ[lv] if lv < len(level_succ)
                else indices[:0])
        best = np.zeros(nodes.size, dtype=np.float64)
        if succ.size:
            deg = indptr[nodes + 1] - indptr[nodes]
            nz = deg > 0
            # segment starts within the gathered array: zero-degree nodes
            # contribute no elements, so the starts of the nonzero-degree
            # nodes partition it exactly.
            cum = np.cumsum(deg)
            starts = (cum - deg)[nz]
            best[nz] = np.maximum.reduceat(weight[succ], starts)
        weight[nodes] = cost[nodes] + best
    return weight


def _split_rows(indptr: np.ndarray, indices: np.ndarray) -> List[List[int]]:
    flat = indices.tolist()
    ip = indptr.tolist()
    return [flat[a:b] for a, b in zip(ip, ip[1:])]


class CompiledGraph:
    """Immutable CSR snapshot of a QSched graph's *structure* (edges, locks,
    uses, in-degrees, topo levels).  Weights live on the scheduler — they
    change with costs without invalidating the structure.  The lists-of-lists
    mirrors (``unlocks_list`` …) are built lazily for the per-task hot loops
    (lock attempts, dependency release) that stay in Python."""

    __slots__ = ("version", "n", "nres",
                 "unlocks_indptr", "unlocks_indices",
                 "locks_indptr", "locks_indices",
                 "uses_indptr", "uses_indices",
                 "wait0", "order", "level_ptr", "level_succ",
                 "_unlocks_list", "_locks_list", "_uses_list")

    def __init__(self, version: int, n: int, nres: int,
                 dep_src: Sequence[int], dep_dst: Sequence[int],
                 lock_t: Sequence[int], lock_r: Sequence[int],
                 use_t: Sequence[int], use_r: Sequence[int]):
        self.version = version
        self.n = n
        self.nres = nres
        self.unlocks_indptr, self.unlocks_indices = coo_to_csr(
            n, dep_src, dep_dst)
        self.locks_indptr, self.locks_indices = coo_to_csr(
            n, lock_t, lock_r, sort_cols=True)
        self.uses_indptr, self.uses_indices = coo_to_csr(n, use_t, use_r)
        self.wait0 = (np.bincount(self.unlocks_indices, minlength=n)
                      .astype(np.int64)
                      if self.unlocks_indices.size else np.zeros(n, np.int64))
        self.order, self.level_ptr, self.level_succ = toposort_levels(
            n, self.unlocks_indptr, self.unlocks_indices)
        self._unlocks_list = None
        self._locks_list = None
        self._uses_list = None

    def weights(self, cost: np.ndarray) -> np.ndarray:
        return critical_path_sweep(self.n, self.unlocks_indptr,
                                   self.unlocks_indices, cost,
                                   self.order, self.level_ptr,
                                   self.level_succ)

    @property
    def unlocks_list(self) -> List[List[int]]:
        if self._unlocks_list is None:
            self._unlocks_list = _split_rows(self.unlocks_indptr,
                                             self.unlocks_indices)
        return self._unlocks_list

    @property
    def locks_list(self) -> List[List[int]]:
        if self._locks_list is None:
            self._locks_list = _split_rows(self.locks_indptr,
                                           self.locks_indices)
        return self._locks_list

    @property
    def uses_list(self) -> List[List[int]]:
        if self._uses_list is None:
            self._uses_list = _split_rows(self.uses_indptr, self.uses_indices)
        return self._uses_list
