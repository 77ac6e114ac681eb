"""Paged KV-cache block pool: cache pages as lockable QuickSched resources.

The serving tier's memory is a fixed pool of ``n_pages`` cache pages, each
holding ``page_size`` token positions of every layer's KV state (attention
families) or one request's whole recurrent state (SSM — O(1) in sequence
length, one "page" per live request).  Requests own disjoint page sets
tracked by a free-list allocator; pages return to the free list at
retirement and are reused by later requests (the exllamav3 block-pool
idiom).  Stale contents of a reused page are harmless by construction:
decode masks every position strictly beyond ``pos``, so a page is
overwritten before it is ever read (asserted bit-exactly in
``tests/test_serve.py``).

Admission *is* a QuickSched conflict problem (DESIGN.md §Serving).  Every
page is registered as a hierarchical resource — root → bank → page — in a
persistent ``core.graph.QSched`` forest, and each admission batch lowers
through ``core.plan.lower`` as one task per request locking its assigned
pages.  A correct allocator yields a single conflict-free round; a
double-assigned page makes two tasks lock the same resource and the
planner is *forced* to split them into separate rounds, which
:meth:`BlockPool.plan_admission` reports as :class:`AdmissionConflict`.
The write-coloring pass (``core.plan.color_phases``) over the physical
page-id write sets is the independent safety proof: a conflict-free
admission round colors to exactly one phase.

So the plan cache can serve as the compiled-module registry (identical
batch shapes must produce identical structural hashes), admission graphs
are built over *canonical* resources: physical page ids are relabelled in
first-use order.  Relabelling is injective on distinct pages, so a
double assignment still collides after relabelling — canonicalisation
never masks a real conflict (property-tested in
``tests/test_blockpool_properties.py``).

Port note: a copy of ``repro.serve.blockpool`` on the port's ``core``.
The leaves are tensors on the pool's ``device`` (the service's), updated
in place by prefill and decode; the dense and MoE families (GQA or MLA
leaves) are paged, the SSM family's state slots are not (the service
serves no other family, as the reference's).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch import resolve_device
from repro_torch.core.graph import QSched
from repro_torch.core.plan import ExecutionPlan, color_phases, lower

# Task type used for admission/prefill tasks in the serving registry
# (``serve.service`` executes them through the ``rounds`` backend).
TT_PREFILL = 0


class AdmissionConflict(RuntimeError):
    """The planner refused to admit a batch in one conflict-free round —
    i.e. the allocator handed the same page to two live requests."""


class BlockPool:
    """Free-list page allocator over a paged device cache.

    ``cfg`` is optional: without it the pool is a pure allocator +
    admission planner (what the property suite drives); with it the pool
    also owns the paged cache leaves — ``serving.init_cache`` evaluated at
    ``batch=n_pages, max_seq=page_size`` on ``device`` (``cuda`` unless
    the caller asks for the CPU, as at every entry point of the port;
    without a card it raises), so every leaf's second axis is the page id:

    * attention families (dense/moe incl. MLA): seq-paged leaves
      ``(L, n_pages, page_size, ...)``;
    * ssm: per-request state leaves ``(L, n_pages, ...)`` — a "page" is a
      whole state slot and every request holds exactly one.
    """

    def __init__(self, n_pages: int, page_size: int, cfg: Any = None,
                 bank_size: int = 8, device: Any = None):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        self.n_pages = n_pages
        self.page_size = page_size
        self.cfg = cfg
        self.paged = cfg is None or cfg.family != "ssm"
        self.leaves: Optional[Dict[str, Any]] = None
        if cfg is not None:
            from repro_torch.models import serving
            self.leaves = serving.init_cache(cfg, batch=n_pages,
                                             max_seq=page_size,
                                             device=resolve_device(device))

        # persistent hierarchical resource forest (paper §3.2): pool root
        # → banks → pages.  ``page_res[p]`` is page p's resource id; the
        # forest is what tests/DESIGN point at when they say "pages are
        # resources", and bank-level locks are where whole-region
        # operations (defrag/flush) would attach.
        self.sched = QSched()
        self.root_res = self.sched.addres()
        self.bank_res: List[int] = []
        self.page_res: List[int] = []
        for p in range(n_pages):
            if p % bank_size == 0:
                self.bank_res.append(self.sched.addres(parent=self.root_res))
            self.page_res.append(self.sched.addres(parent=self.bank_res[-1]))

        # LIFO free list: most-recently-freed pages are re-allocated first
        # (hottest reuse), owners maps page -> live owner key
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._owner: List[Optional[Any]] = [None] * n_pages

    # -- free-list allocator -------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> int:
        return self.n_pages - len(self._free)

    def owner_of(self, page: int) -> Optional[Any]:
        return self._owner[page]

    def pages_needed(self, n_positions: int) -> int:
        """Pages one request needs for ``n_positions`` cache positions —
        ``ceil(n/page_size)`` for seq-paged families, always 1 for O(1)
        recurrent state."""
        if not self.paged:
            return 1
        return max(1, -(-int(n_positions) // self.page_size))

    def can_admit(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    def alloc(self, n_pages: int, owner: Any) -> List[int]:
        """Pop ``n_pages`` pages off the free list for ``owner``."""
        if owner is None:
            raise ValueError("alloc: owner must not be None")
        if n_pages > len(self._free):
            raise MemoryError(
                f"block pool exhausted: want {n_pages} pages, "
                f"{len(self._free)} free of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n_pages)]
        for p in pages:
            self._owner[p] = owner
        return pages

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the free list (request retirement/eviction)."""
        for p in pages:
            if self._owner[p] is None:
                raise ValueError(f"free: page {p} is not allocated")
            self._owner[p] = None
            self._free.append(p)

    def check_invariants(self) -> None:
        """Free-list conservation + ownership disjointness — the pool's
        corruption tripwire (the hypothesis suite calls this after every
        operation)."""
        if self.allocated + self.free_count != self.n_pages:
            raise AssertionError(
                f"page conservation violated: {self.allocated} allocated + "
                f"{self.free_count} free != {self.n_pages}")
        if len(set(self._free)) != len(self._free):
            raise AssertionError("free list holds a duplicate page")
        for p in self._free:
            if self._owner[p] is not None:
                raise AssertionError(f"page {p} is free but owned")

    # -- admission as a conflict problem -------------------------------------
    def admission_sched(self, assignments: Sequence[Sequence[int]],
                        task_type: int = TT_PREFILL,
                        datas: Optional[Sequence[Any]] = None,
                        ) -> Tuple[QSched, List[Tuple[Tuple, Tuple]]]:
        """Build the admission graph for one batch: task ``i`` locks the
        canonical resources of ``assignments[i]`` (physical page ids
        relabelled in first-use order under a root resource, so equal batch
        shapes hash equally and the plan cache hits).  Also returns the
        physical ``(reads, writes)`` access list for ``color_phases`` —
        the write sets are the *un*-relabelled page ids, keeping the
        coloring proof independent of the canonicalisation."""
        s = QSched()
        root = s.addres()
        canon: Dict[int, int] = {}
        accesses: List[Tuple[Tuple, Tuple]] = []
        for i, pages in enumerate(assignments):
            tid = s.addtask(type=task_type,
                            data=None if datas is None else datas[i])
            for p in pages:
                rid = canon.get(p)
                if rid is None:
                    rid = canon[p] = s.addres(parent=root)
                s.addlock(tid, rid)
            accesses.append(((), tuple(pages)))
        return s, accesses

    def plan_admission(self, assignments: Sequence[Sequence[int]],
                       task_type: int = TT_PREFILL,
                       datas: Optional[Sequence[Any]] = None,
                       nr_lanes: int = 1,
                       ) -> Tuple[QSched, ExecutionPlan]:
        """Lower one admission batch and prove it safe: the plan must be a
        single conflict-free round AND the write coloring over physical
        page ids must produce at most one phase.  Raises
        :class:`AdmissionConflict` otherwise (an allocator bug — never
        reachable through :meth:`alloc`, property-tested)."""
        sched, accesses = self.admission_sched(assignments, task_type, datas)
        plan = lower(sched, nr_lanes)
        if plan.nr_rounds != 1:
            raise AdmissionConflict(
                f"admission batch needs {plan.nr_rounds} rounds — a page is "
                f"assigned to two requests")
        bounds = color_phases(accesses)
        if len(bounds) - 1 > 1:
            raise AdmissionConflict(
                f"write coloring split the admission round into "
                f"{len(bounds) - 1} phases — overlapping page write sets")
        return sched, plan
