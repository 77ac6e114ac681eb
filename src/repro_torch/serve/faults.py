"""Deterministic chaos injection for the serving tier.

Fault tolerance that is only exercised by real failures is fault
tolerance that has never been tested.  This module makes every failure
path in :class:`~repro.serve.service.GenerateService` *reproducibly*
reachable: a :class:`FaultPlan` is a static, seeded schedule of
:class:`FaultEvent`\\ s keyed by service tick, and the service consumes it
at the top of every :meth:`step` — no wall-clock randomness, no
monkeypatching, the same plan against the same trace fires the same
faults at the same points in the request stream every run (the
conformance suite in ``tests/test_faults.py`` depends on exactly this to
assert that *unaffected* requests' token streams are bitwise-identical
to a fault-free replay).

Four fault kinds, one per recovery path (DESIGN.md §Robustness):

* ``nan_decode`` — NaN-poison a decode round's logits for one victim
  slot (``sticky`` consecutive decode executions, retries included).
  ``sticky=1`` models a transient compute fault: the post-round
  finiteness guard trips, the in-tick retry on the ``gather`` reference
  round function recomputes cleanly, the stream is unharmed.
  ``sticky>=2`` poisons the retry too, forcing preemption: pages are
  reclaimed and the request is re-admitted through the normal prefill
  family — order-safe because conflicting tasks may run in any order,
  just not concurrently (the paper's central invariant).
* ``admission_fail`` — the next admission attempt fails *after* pages
  and slots are assigned, exercising the rollback path (pages freed,
  slots returned, requests requeued in arrival order, conservation
  asserted).
* ``drop_prefill`` — drop the prefill entry-point cache (the service's
  compiled-module registry), exercising cold re-specialization
  mid-stream.
* ``stall`` — jump the service's virtual clock by ``skew_s`` seconds,
  as if a tick stalled that long: every in-flight deadline that the jump
  passes expires on the next sweep (``DEADLINE_EXCEEDED``), without the
  test suite ever sleeping.

Injection is honest: ``nan_decode`` plants real NaNs in the logits
*inside* the jitted round function (via the poison lane of the guard
flags buffer), so detection flows through the same finiteness check that
would catch an organic NaN — the harness never short-circuits the guard
it is testing.

Port note: a copy of ``repro.serve.faults`` (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("nan_decode", "admission_fail", "drop_prefill", "stall")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``tick`` is the service step counter value
    at which it fires.  ``victim`` selects the target of a ``nan_decode``
    as an index into the sorted active slots at fire time (taken modulo
    the number of active slots, so seeded plans need no knowledge of the
    admission trajectory); ``sticky`` is how many consecutive decode
    executions of that slot stay poisoned (in-tick retries count — 1
    recovers via retry, >=2 forces preemption).  ``skew_s`` is the
    virtual-clock jump of a ``stall``."""
    tick: int
    kind: str
    victim: int = 0
    sticky: int = 1
    skew_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.tick < 0 or self.sticky < 1 or self.skew_s < 0:
            raise ValueError(f"malformed fault event {self!r}")


class FaultPlan:
    """An immutable schedule of fault events, indexable by tick.

    Build one explicitly from events (tests pin exact scenarios) or with
    :meth:`seeded` (CI chaos smoke: a Poisson sprinkling of every kind,
    deterministic per seed).  The service records what actually fired in
    ``GenerateService.faults_fired`` — a plan is a *schedule*, and e.g. a
    ``nan_decode`` scheduled while no slot is active fires as a no-op."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        evs = sorted(events, key=lambda e: (e.tick, e.kind, e.victim))
        self.events: Tuple[FaultEvent, ...] = tuple(evs)
        self._by_tick: Dict[int, List[FaultEvent]] = {}
        for e in self.events:
            self._by_tick.setdefault(e.tick, []).append(e)

    def __len__(self) -> int:
        return len(self.events)

    def events_at(self, tick: int) -> Tuple[FaultEvent, ...]:
        return tuple(self._by_tick.get(tick, ()))

    @property
    def last_tick(self) -> int:
        return self.events[-1].tick if self.events else -1

    def summary(self) -> Dict[str, int]:
        out = {k: 0 for k in FAULT_KINDS}
        for e in self.events:
            out[e.kind] += 1
        return out

    @classmethod
    def seeded(cls, seed: int, n_ticks: int, *,
               p_nan: float = 0.08, p_admission: float = 0.04,
               p_drop: float = 0.02, p_stall: float = 0.0,
               stall_skew_s: float = 0.0,
               sticky_choices: Sequence[int] = (1, 1, 3)) -> "FaultPlan":
        """Draw an independent Bernoulli per kind per tick (deterministic
        per seed).  ``sticky_choices`` biases ``nan_decode`` toward
        transient faults (retry recovers) with an occasional persistent
        one (preemption + re-admission).  ``p_stall`` only matters with a
        positive ``stall_skew_s`` and deadlines configured."""
        if n_ticks < 1:
            raise ValueError("n_ticks must be >= 1")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for t in range(n_ticks):
            if rng.random() < p_nan:
                events.append(FaultEvent(
                    t, "nan_decode", victim=int(rng.integers(0, 1 << 16)),
                    sticky=int(rng.choice(np.asarray(sticky_choices)))))
            if rng.random() < p_admission:
                events.append(FaultEvent(t, "admission_fail"))
            if rng.random() < p_drop:
                events.append(FaultEvent(t, "drop_prefill"))
            if p_stall > 0 and stall_skew_s > 0 and rng.random() < p_stall:
                events.append(FaultEvent(t, "stall", skew_s=stall_skew_s))
        return cls(events)
