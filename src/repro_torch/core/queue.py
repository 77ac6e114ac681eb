"""Max-heap task queue (paper §3.3).

Tasks are kept in a binary max-heap keyed by task weight.  ``get`` walks the
heap array *in index order* (the paper's compromise: the k-th entry of n is
heavier than at least floor(n/k)-1 others) and returns the first task whose
resources can all be locked.  Removal restores the heap invariant with a
sift-down *and* sift-up (the paper only trickles down; sifting both ways
keeps the invariant exact at the same O(log n) cost — noted in DESIGN.md).

Port note: a copy of ``repro.core.queue``.  ``repro_torch`` imports nothing of
``repro`` (not even its jax-free modules), so it keeps its own copy.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional


class TaskQueue:
    def __init__(self, weights: List[float], threaded: bool = False):
        self._weights = weights  # shared, indexed by task id
        self._heap: List[int] = []
        self._mutex = threading.Lock() if threaded else None

    def __len__(self) -> int:
        return len(self._heap)

    # -- heap plumbing ------------------------------------------------------
    def _sift_up(self, k: int) -> int:
        h, w = self._heap, self._weights
        while k > 0:
            p = (k - 1) >> 1
            if w[h[p]] >= w[h[k]]:
                break
            h[p], h[k] = h[k], h[p]
            k = p
        return k

    def _sift_down(self, k: int) -> int:
        h, w = self._heap, self._weights
        n = len(h)
        while True:
            l, r = 2 * k + 1, 2 * k + 2
            big = k
            if l < n and w[h[l]] > w[h[big]]:
                big = l
            if r < n and w[h[r]] > w[h[big]]:
                big = r
            if big == k:
                return k
            h[big], h[k] = h[k], h[big]
            k = big

    # -- queue API (paper queue_put / queue_get) ----------------------------
    def put(self, tid: int) -> None:
        if self._mutex:
            with self._mutex:
                self._heap.append(tid)
                self._sift_up(len(self._heap) - 1)
        else:
            self._heap.append(tid)
            self._sift_up(len(self._heap) - 1)

    def get(self, try_lock: Callable[[int], bool]) -> Optional[int]:
        """Scan the heap in index order; ``try_lock(tid)`` attempts to lock
        the task's resources (all-or-nothing).  Returns the first lockable
        task id, removing it from the heap, or None."""
        if self._mutex:
            with self._mutex:
                return self._get(try_lock)
        return self._get(try_lock)

    def _get(self, try_lock: Callable[[int], bool]) -> Optional[int]:
        h = self._heap
        for k in range(len(h)):
            tid = h[k]
            if try_lock(tid):
                last = h.pop()
                if k < len(h):
                    h[k] = last
                    if self._sift_down(k) == k:
                        self._sift_up(k)
                return tid
        return None

    def peek_weights(self) -> List[float]:
        return [self._weights[t] for t in self._heap]

    def check_heap(self) -> bool:
        h, w = self._heap, self._weights
        return all(
            w[h[(k - 1) >> 1]] >= w[h[k]] for k in range(1, len(h))
        )
