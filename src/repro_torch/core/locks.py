"""Hierarchical resource lock/hold protocol (paper §3.2).

A resource may be *locked* (exclusive) or *held* (one of its descendants is
locked).  Locking a resource requires (a) the resource itself not being held
or locked and (b) *holding* every ancestor up to the root.  A held resource
cannot be locked; a locked resource cannot be held.  This is what lets a
conflict between tasks be expressed at any level of a resource hierarchy
(e.g. octree cells).

Two lock managers share the protocol:

* ``SeqLockManager`` — plain integers, for the discrete-event simulator and
  the static scheduler (single control thread, no races possible).
* ``ThreadedLockManager`` — emulates the paper's ``atomic_cas`` /
  ``atomic_inc`` with a per-resource mutex guarding only the atomic ops, for
  the host-side threaded executor.  The *protocol* (including the paper's
  re-check of ``hold`` after acquiring ``lock`` to close the hold/lock race)
  is identical in both.

Port note: a copy of ``repro.core.locks``.  ``repro_torch`` imports nothing of
``repro`` (not even its jax-free modules), so it keeps its own copy.
"""

from __future__ import annotations

import threading
from typing import List, Optional


class _ResourceState:
    __slots__ = ("lock", "hold", "mutex")

    def __init__(self, threaded: bool):
        self.lock = 0
        self.hold = 0
        self.mutex = threading.Lock() if threaded else None


class BaseLockManager:
    """Shared lock/hold protocol over a resource forest.

    ``parents[r]`` is the parent resource id of ``r`` or -1.
    """

    threaded = False

    def __init__(self, parents: List[int]):
        self.parents = parents
        self.state = [_ResourceState(self.threaded) for _ in parents]

    # -- atomic primitives (overridden for the threaded manager) ----------
    def _cas_lock(self, s: _ResourceState) -> bool:
        if s.lock == 0:
            s.lock = 1
            return True
        return False

    def _inc_hold(self, s: _ResourceState) -> None:
        s.hold += 1

    def _dec_hold(self, s: _ResourceState) -> None:
        s.hold -= 1

    # -- protocol (paper §3.2) --------------------------------------------
    def try_hold(self, r: int) -> bool:
        """resource_hold: momentarily lock ``r`` to bump its hold counter."""
        s = self.state[r]
        if not self._cas_lock(s):
            return False
        self._inc_hold(s)
        s.lock = 0
        return True

    def try_lock(self, r: int) -> bool:
        """resource_lock: exclusive-lock ``r`` and hold all its ancestors."""
        s = self.state[r]
        if s.hold != 0:
            return False
        if not self._cas_lock(s):
            return False
        if s.hold != 0:  # re-check: a try_hold may have raced us
            s.lock = 0
            return False
        # Walk up the hierarchy holding each ancestor.
        held: List[int] = []
        up: int = self.parents[r]
        ok = True
        while up != -1:
            if not self.try_hold(up):
                ok = False
                break
            held.append(up)
            up = self.parents[up]
        if ok:
            return True
        for a in held:  # undo partial holds, release the lock
            self._dec_hold(self.state[a])
        s.lock = 0
        return False

    def unlock(self, r: int) -> None:
        s = self.state[r]
        assert s.lock == 1, f"unlock of unlocked resource {r}"
        s.lock = 0
        up = self.parents[r]
        while up != -1:
            self._dec_hold(self.state[up])
            up = self.parents[up]

    def lock_all(self, resources: List[int]) -> bool:
        """Try to lock a sorted list of resources; all-or-nothing.

        Resources must be pre-sorted by id (paper §3.3: global ordering
        avoids the dining-philosophers livelock).
        """
        for i, r in enumerate(resources):
            if not self.try_lock(r):
                for j in range(i - 1, -1, -1):
                    self.unlock(resources[j])
                return False
        return True

    def unlock_all(self, resources: List[int]) -> None:
        for r in resources:
            self.unlock(r)

    # -- introspection ------------------------------------------------------
    def is_locked(self, r: int) -> bool:
        return self.state[r].lock == 1

    def hold_count(self, r: int) -> int:
        return self.state[r].hold

    def all_free(self) -> bool:
        return all(s.lock == 0 and s.hold == 0 for s in self.state)


class SeqLockManager(BaseLockManager):
    threaded = False


class ThreadedLockManager(BaseLockManager):
    """Per-resource mutexes emulate atomic_cas/atomic_inc of the paper."""

    threaded = True

    def _cas_lock(self, s: _ResourceState) -> bool:
        with s.mutex:
            if s.lock == 0:
                s.lock = 1
                return True
            return False

    def _inc_hold(self, s: _ResourceState) -> None:
        with s.mutex:
            s.hold += 1

    def _dec_hold(self, s: _ResourceState) -> None:
        with s.mutex:
            s.hold -= 1


def make_lock_manager(parents: List[int], threaded: bool) -> BaseLockManager:
    return (ThreadedLockManager if threaded else SeqLockManager)(parents)
