"""Continuous-batching generate service on the device-resident scheduler.

The port of ``repro/serve/service.py``: as the reference's, it serves the
attention families (dense GQA, and MoE with GQA or MLA attention) and the
SSM family, and refuses the hybrid, enc-dec and VLM families.  A persistent
service: an
admission queue feeding a fixed set of batch slots, requests joining and
leaving mid-stream.  The QuickSched machinery *is*
the serving path:

* **Admission is a conflict round.**  Arriving requests take pages from
  the :class:`~repro_torch.serve.blockpool.BlockPool` free list; the batch
  lowers through ``core.plan.lower`` as one PREFILL task per request
  locking its pages, must prove conflict-free (single round, one
  write-coloring phase), and then executes through the ``rounds`` backend,
  whose ``BatchSpec(TT_PREFILL)`` runs the prefill and writes the prompt
  K/V into the request's pages.
* **Decode is an engine task family.**  Each tick lowers the active slots
  as DECODE tasks (one locked state resource per slot) and runs them
  through the ``engine`` backend: ``BatchSpec.encode`` emits
  ``[DECODE, slot, pos]`` descriptor rows and the family's
  :class:`~repro_torch.core.backends.EngineHooks` round function decodes
  every slot.  Which round function ``decode_path="auto"`` takes depends
  on the service's device:

  - ``kernel`` — the paged decode kernel (``kernels/paged_attention``:
    K10 for GQA, K11 for MLA) walks each slot's page table in-kernel with
    an online softmax over only the pages the slot occupies and writes the
    new cache cell in place — no gather, no scatter.  Always the path on
    the card (it raises on a card the kernels are not built for); on the
    CPU the op runs its plain version;
  - ``bounded`` — the gather path bounded to the
    ``max(pos)//page_size + 1`` pages the round walks (the CPU default);
  - ``gather`` — the full ``max_seq`` window: the conformance oracle the
    other two are held against token for token.

* **Sampling.**  Greedy argmax is the default and the oracle;
  :class:`SamplingParams` with ``temperature > 0`` (and optional top-k)
  samples by Gumbel-max with noise that is a stateless function of
  ``(seed, request id, position)`` (``models.serving.sample_tokens``), so
  a request's stream is deterministic under a fixed seed however requests
  interleave.  The reference threaded one threefry key per slot through
  the engine buffers; the port keeps each slot's request id instead.

**Robustness** as in the reference (DESIGN.md §Robustness): deadlines and
:meth:`GenerateService.cancel` evict through :meth:`_preempt`; with
``guard=True`` every decode round writes a per-slot finiteness flag, a
slot that trips it is retried once in-tick on the ``gather`` round
function, a slot whose retry trips too is preempted and re-admitted, and
repeated faults degrade the round function down the ladder
(kernel → bounded → gather) with exponential backoff.  A seeded
:class:`~repro_torch.serve.faults.FaultPlan` makes every path reachable.
The ladder answers non-finite logits only: a K10 or K11 build or launch
error raises out of :meth:`step`, it is never degraded around.  Nor is a
kernel round on the card whose logits turn non-finite without an injected
fault: the kernel reports a bad position or page id by writing NaN, so the
service raises :class:`KernelFault` there instead of recomputing the slot
on the plain path.  Each degrade on the card is logged as a warning.

What the port changes:

* the slot state (page table, last token, position, request id, guard
  flag) and the pool leaves are device tensors updated in place by the
  round functions, prefill and :meth:`_preempt` (the reference rebuilt
  immutable arrays);
* so the in-tick retry restores a faulted slot from *clones* taken before
  the round (the reference's pre-round arrays were immutable snapshots);
* no jit: "entry points" are the prefill closures per (prompt length,
  batch size), kept as the registry ``compiled_entry_points`` reports and
  the ``drop_prefill`` fault clears;
* the service runs on ``device`` — ``cuda`` unless the caller asks for the
  CPU, and it raises without a card rather than run on the CPU quietly.

The dense and MoE families are served (the pool leaves, the gather and
scatter of the reference paths and preemption are the same for either
cache layout), and the SSM family as the reference serves it: its state is
O(1) in the sequence, so nothing is paged (``paged`` is False, a "page"
is one request's whole state slot, ``max_seq`` does not bound a request)
and the decode path is ``gather`` on every device — no kernel exists for
it, so K10/K11 never launch.  The hybrid, enc-dec and VLM families raise
a ``ValueError``, as in the reference (their per-request extra inputs and
the trunk+shared cache split are not wired into the service); they serve
through ``models.serving`` on the static path.
"""

from __future__ import annotations

import functools
import weakref
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.backends import EngineHooks, run_plan
from repro_torch.core.graph import QSched
from repro_torch.core.plan import BatchSpec, lower
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import serving as serving_mod
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import MetricsRegistry

from .blockpool import AdmissionConflict, TT_PREFILL, BlockPool
from .faults import FaultPlan

TT_DECODE = 1       # task type of the decode family
ENG_DECODE = 1      # engine descriptor row etype for a decode item

# the reference's service's families (its own tuple, not ``lm.FAMILIES``:
# the hybrid, enc-dec and VLM families run through ``models.serving`` but
# not through the service, in either package)
SUPPORTED_FAMILIES = ("dense", "moe", "ssm")
DECODE_PATHS = ("auto", "kernel", "bounded", "gather")
# capability ladder, fastest first — the degrade walk moves right
DECODE_LADDER = ("kernel", "bounded", "gather")

# guard-flag lane values (one int32 per slot in the engine buffers)
FLAG_OK = 0         # round produced finite logits
FLAG_FAULT = 1      # finiteness check tripped
FLAG_POISON = 2     # armed by chaos injection: round NaNs this slot's logits

# terminal request states (Request.status; "queued"/"active" are transient)
ST_DONE = "done"
ST_CANCELLED = "cancelled"
ST_DEADLINE = "deadline_exceeded"
TERMINAL_STATES = (ST_DONE, ST_CANCELLED, ST_DEADLINE)


class QueueFull(RuntimeError):
    """``submit()`` refused: the admission queue is at ``max_queue``."""

    def __init__(self, msg: str, *, queue_depth: int, max_queue: int):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.max_queue = max_queue


class KernelFault(RuntimeError):
    """A kernel round (K10 or K11) on the card gave non-finite logits for
    slots no fault was injected into: a bad position or page id, or a
    non-finite model.  Raised instead of recomputing the slots on the plain
    path."""

    def __init__(self, msg: str, *, slots: Sequence[int]):
        super().__init__(msg)
        self.slots = list(slots)


class ServiceStalled(RuntimeError):
    """``run_until_complete`` exhausted its step budget with requests
    still in flight.  Carries the diagnostic snapshot (queue depth,
    active slots, last tick that made progress) instead of failing
    silently."""

    def __init__(self, msg: str, *, queue_depth: int, active_slots: int,
                 last_progress_tick: int, steps: int):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.active_slots = active_slots
        self.last_progress_tick = last_progress_tick
        self.steps = steps


@dataclass(frozen=True)
class SamplingParams:
    """How next tokens are chosen from decode logits.  The default
    (``temperature == 0``) is greedy argmax — the conformance oracle.
    ``temperature > 0`` samples from the (optionally top-k-truncated)
    tempered distribution; ``seed`` plus the request id fully determine a
    request's stream."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


@dataclass
class Request:
    """One generation request moving through the service.  The ``t_*``
    timestamps (submit → admit → first token → complete, on the service's
    virtual clock) feed the TTFT/latency histograms and the lifecycle
    spans.  ``status`` walks queued → active → one of
    :data:`TERMINAL_STATES` (a preempted request goes back to queued);
    ``deadline_s`` is absolute on the service clock, ``None`` = none."""
    rid: int
    prompt: np.ndarray                 # (plen,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    pages: List[int] = field(default_factory=list)
    slot: int = -1
    pos: int = 0
    done: bool = False
    status: str = "queued"
    deadline_s: Optional[float] = None
    preemptions: int = 0
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def tokens(self) -> List[int]:
        return list(self.generated)

    @property
    def ttft_s(self) -> float:
        """Submit → first token (0.0 until the first token exists)."""
        return self.t_first - self.t_submit if self.t_first else 0.0

    @property
    def latency_s(self) -> float:
        """Submit → retire (0.0 until the request completes)."""
        return self.t_done - self.t_submit if self.t_done else 0.0

    def feed_tokens(self) -> np.ndarray:
        """What (re-)admission prefills: the prompt plus every token
        generated so far — a preempted request's prefix is recomputed
        through the normal prefill family."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def total_positions(self) -> int:
        """Cache positions the request can ever touch (constant across
        preemptions: generated tokens move from budget to feed)."""
        return int(self.prompt.size) + self.max_new_tokens - 1


def _decode_row_access(row: Sequence[int]) -> Tuple[Tuple, Tuple]:
    """A decode item reads and writes only its own slot's pages/state, so
    the slot id is the state-row key: distinct slots never collide and
    every decode round colors to one phase."""
    key = ("slot", int(row[1]))
    return ((key,), (key,))


def _desc_columns(desc: torch.Tensor):
    """(slots, positions) of a decode table, as int64 device tensors."""
    return desc[:, 1].long(), desc[:, 2].long()


def _finish_decode(buffers: Tuple, slots: torch.Tensor, p_b: torch.Tensor,
                   logits: torch.Tensor, sampling: SamplingParams,
                   guard: bool) -> Tuple:
    """Common decode-round tail: pick next tokens and advance the slot
    state, in place.  With ``guard`` the tail also honours the chaos
    poison lane (a slot whose flag was armed to :data:`FLAG_POISON` gets
    NaN logits here, so injected faults flow through the same detection
    an organic NaN would) and writes the per-slot finiteness verdict into
    the flags buffer, which the service reads once per tick."""
    tok, pos, rid, flags = buffers[1:5]
    if guard:
        poisoned = flags[slots] == FLAG_POISON
        logits = logits.float().masked_fill(poisoned[:, None], float("nan"))
        ok = torch.isfinite(logits).all(dim=-1)
        flags[slots] = torch.where(ok, FLAG_OK, FLAG_FAULT).to(flags.dtype)
    nxt = serving_mod.sample_tokens(logits, sampling.temperature,
                                    sampling.top_k, sampling.seed,
                                    rid[slots], p_b + 1)
    tok[slots] = nxt
    pos[slots] = (p_b + 1).to(pos.dtype)
    return buffers


def _scatter_cells(leaves: Dict, cache: Dict, rows: torch.Tensor,
                   p_b: torch.Tensor, page_size: int) -> None:
    """The decode step wrote exactly position ``p_b`` of each slot's
    gathered cache: copy that one (page, offset) cell of every layer back
    into the pool, in place.  No other cell of the pool changes."""
    page_ids = rows.gather(1, (p_b // page_size)[:, None])[:, 0]
    off = p_b % page_size
    bidx = torch.arange(rows.shape[0], device=rows.device)
    for k, leaf in leaves.items():
        leaf[:, page_ids, off] = cache[k][:, bidx, p_b]


def _gather_window(leaves: Dict, rows: torch.Tensor,
                   page_size: int) -> Dict:
    """A contiguous cache (L, bs, n * page_size, ...) copied from the
    pages ``rows`` (bs, n) of the pool, whatever the leaf's cell shape."""
    bs, n = rows.shape
    return {k: leaf[:, rows].reshape((leaf.shape[0], bs, n * page_size)
                                     + leaf.shape[3:])
            for k, leaf in leaves.items()}


def _weak(method: Callable) -> Callable:
    """``method`` (bound to a service) called through a weak reference:
    the registry and engine hooks a service keeps then refer back to it
    without a cycle, so a dropped service — and the model and pool it
    holds — is freed at once, not when the cycle collector next runs."""
    ref = weakref.WeakMethod(method)

    def call(*args, **kwargs):
        return ref()(*args, **kwargs)

    return call


def _make_decode_round_fn(cfg, page_size: int, sampling: SamplingParams,
                          guard: bool, paged: bool = True) -> Callable:
    """The full-window gather round function — the conformance oracle
    (``decode_path="gather"``), the retry/degrade floor of the ladder, and
    the only path of the unpaged SSM family, whose slots each hold one
    state "page": that page's state is read whole and written back whole
    (``index_copy_`` into the pool leaves).  Layout: ``desc[i] =
    [ENG_DECODE, slot, pos]``; buffers = ``(page tables, tok, pos, rid,
    flags, pool leaves)``; statics = ``(params,)``."""

    def decode_round(desc, schedule, statics, buffers):
        del schedule                   # single write-colored phase
        params = statics[0]
        pt, tok = buffers[0], buffers[1]
        leaves = buffers[5]
        slots, p_b = _desc_columns(desc)
        rows = pt[slots].long()                             # (bs, MP)
        if not paged:
            sid = rows[:, 0]
            cache = {k: leaf[:, sid] for k, leaf in leaves.items()}
            logits, cache = serving_mod.decode_step(
                params, cfg, cache, tok[slots][:, None], p_b)
            for k, leaf in leaves.items():
                leaf.index_copy_(1, sid, cache[k])
            return _finish_decode(buffers, slots, p_b, logits, sampling,
                                  guard)
        cache = _gather_window(leaves, rows, page_size)
        logits, cache = serving_mod.decode_step(
            params, cfg, cache, tok[slots][:, None], p_b)
        _scatter_cells(leaves, cache, rows, p_b, page_size)
        return _finish_decode(buffers, slots, p_b, logits, sampling, guard)

    return decode_round


def _make_bounded_decode_round_fn(cfg, page_size: int,
                                  sampling: SamplingParams,
                                  guard: bool) -> Callable:
    """Window-bounded gather round function (``decode_path="bounded"``):
    the math of the full window, but it gathers and attends only the
    first ``n_walk`` pages per slot, ``n_walk = max(pos)//page_size + 1``
    over the round (``statics = (params, n_walk)``), so the work stays
    proportional to occupied pages like the kernel's.  Every truncated
    position is masked in the full window anyway."""

    def decode_round(desc, schedule, statics, buffers):
        del schedule
        params, n_walk = statics
        pt, tok = buffers[0], buffers[1]
        leaves = buffers[5]
        slots, p_b = _desc_columns(desc)
        rows = pt[slots][:, :n_walk].long()                 # (bs, n_walk)
        cache = _gather_window(leaves, rows, page_size)
        logits, cache = serving_mod.decode_step(
            params, cfg, cache, tok[slots][:, None], p_b)
        _scatter_cells(leaves, cache, rows, p_b, page_size)
        return _finish_decode(buffers, slots, p_b, logits, sampling, guard)

    return decode_round


def _make_paged_decode_round_fn(cfg, page_size: int,
                                sampling: SamplingParams,
                                guard: bool) -> Callable:
    """The paged-attention round function (``decode_path="kernel"``): hand
    the pool leaves, page-table rows and descriptor positions straight to
    ``serving.decode_step_paged``, whose K10 or K11 launches walk each
    slot's pages and write the new cell in place — no gather, no scatter,
    no ``max_seq``-shaped intermediate."""

    def decode_round(desc, schedule, statics, buffers):
        del schedule
        params = statics[0]
        pt, tok = buffers[0], buffers[1]
        leaves = buffers[5]
        slots, p_b = _desc_columns(desc)
        logits, _ = serving_mod.decode_step_paged(
            params, cfg, leaves, pt[slots], tok[slots][:, None], p_b,
            page_size=page_size)
        return _finish_decode(buffers, slots, p_b, logits, sampling, guard)

    return decode_round


class GenerateService:
    """Continuous-batching serving engine over a paged block pool.

    ``max_batch`` is the number of concurrent decode slots, ``max_seq``
    the per-request cache capacity (prompt + generated - 1 positions must
    fit), ``page_size`` the positions per pool page.  ``n_pages``
    defaults to exactly enough pages to fill every slot
    (``max_batch * max_seq / page_size``); set it lower to make paging
    pressure the admission bottleneck.  ``device`` is where the pool, the
    slot state and ``params`` live: ``cuda`` unless the caller asks for
    ``cpu``.

    Robustness knobs: ``max_queue`` bounds the admission queue
    (``submit`` raises :class:`QueueFull` past it); ``deadline_ms`` is a
    default per-request deadline; ``guard`` enables the post-round
    finiteness check and the retry/degrade/preempt ladder; ``faults``
    installs a :class:`~repro_torch.serve.faults.FaultPlan` (requires
    ``guard``)."""

    def __init__(self, params: Any, cfg, *, max_batch: int = 4,
                 max_seq: int = 64, page_size: int = 8,
                 n_pages: Optional[int] = None, nr_lanes: int = 1,
                 decode_path: str = "auto",
                 sampling: Optional[SamplingParams] = None,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 guard: bool = True,
                 faults: Optional[FaultPlan] = None,
                 device: Any = None):
        if cfg.family not in SUPPORTED_FAMILIES:
            raise ValueError(
                f"GenerateService supports families {SUPPORTED_FAMILIES}, "
                f"not {cfg.family!r} ({cfg.name}): extra per-request inputs "
                f"/ trunk+shared split not wired up yet, as in the "
                f"reference; serve it with models.serving's prefill and "
                f"decode_step (the static launcher)")
        if decode_path not in DECODE_PATHS:
            raise ValueError(
                f"decode_path must be one of {DECODE_PATHS}, "
                f"not {decode_path!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.paged = cfg.family != "ssm"
        if self.paged and max_seq % page_size != 0:
            raise ValueError("max_seq must be a multiple of page_size")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if params["embed"]["tok"].device != self.device:
            raise ValueError(f"params live on "
                             f"{params['embed']['tok'].device}, the service "
                             f"on {self.device}")
        self.params = params
        self.cfg = cfg
        self.sampling = sampling or SamplingParams()
        self.guard = bool(guard)
        # on the card the decode attention is K10 or K11, never a plain
        # path in its place: a card they are not built for raises here.
        # The SSM state is O(1) and nothing is paged: no kernel exists for
        # it, and gather is its one path on every device (the reference's
        # rule)
        if not self.paged:
            decode_path = "gather"
        elif decode_path == "auto":
            decode_path = ("kernel" if self.device.type == "cuda"
                           else "bounded")
        if decode_path == "kernel" and self.device.type == "cuda":
            paged_ops.check_device(self.device)
        self.decode_path = decode_path
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.nr_lanes = nr_lanes
        self.max_pages = max_seq // page_size if self.paged else 1
        if n_pages is None:
            n_pages = max_batch * self.max_pages
        self.pool = BlockPool(n_pages, page_size, cfg=cfg, device=self.device)
        self.max_queue = max_queue
        self.deadline_ms = deadline_ms

        # slot state lives on the device between steps (page table, last
        # token, position, request id, guard flag), updated in place
        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self._pt = zeros(max_batch, self.max_pages)
        self._tok = zeros(max_batch)
        self._pos = zeros(max_batch)
        # each slot's request id keys its sampling noise, so a request's
        # sample stream depends only on (seed, rid), not on its slot
        self._rid = zeros(max_batch, dtype=torch.int64)
        self._flags = zeros(max_batch)
        self._free_slots: List[int] = list(range(max_batch - 1, -1, -1))
        self._active: Dict[int, Request] = {}
        self._queue: Deque[Request] = deque()
        self._requests: Dict[int, Request] = {}    # rid -> live request
        self._next_rid = 0

        # prefill entry points per (prompt length, batch size): the
        # registry compiled_entry_points() reports; decode specializations
        # are recorded per batch size
        self._prefill_fns: Dict[Tuple[int, int], Callable] = {}
        self.decode_batch_sizes_seen: set = set()

        self.registry = {
            TT_PREFILL: BatchSpec(run_one=_weak(self._run_prefill),
                                  run_batch=_weak(self._run_prefill_batch)),
            TT_DECODE: BatchSpec(run_one=_weak(self._no_host_decode),
                                 encode=_weak(self._encode_decode)),
        }
        # degrade ladder: the selected path plus everything below it; the
        # last rung is always the gather oracle — also the retry path
        self._ladder: Tuple[str, ...] = (
            ("gather",) if not self.paged
            else DECODE_LADDER[DECODE_LADDER.index(self.decode_path):])
        self._level = 0                 # current rung (0 = selected path)
        self._fault_streak = 0          # consecutive faulted ticks
        self._cooldown = 0              # clean ticks before promotion
        self._hooks_by_path: Dict[str, EngineHooks] = {
            path: self._make_hooks(path) for path in self._ladder}

        # robustness bookkeeping
        self._faults: Optional[FaultPlan] = None
        self.faults_fired: List[Tuple[int, Any, bool]] = []
        self.faulted_rids: set = set()   # preempted / cancelled / expired
        self.retried_rids: set = set()   # recovered by the in-tick retry
        self._poison_budget: Dict[int, int] = {}   # slot -> armed rounds
        self._armed: set = set()         # slots poisoned in this round
        self._admission_fault = False
        self._skew = 0.0                 # virtual-clock offset (stalls)
        self._last_progress_tick = -1
        self.inject(faults)

        # per-service metrics registry: exact lifecycle counters,
        # occupancy/depth gauges sampled every tick, TTFT + end-to-end
        # latency histograms, the host cost of each decode tick's graph
        # build and plan lowering, and of issuing its round, and on the card
        # the round's device span (CUDA events, read after the tick's one
        # sync).  `stats` stays dict-shaped.
        self.metrics = MetricsRegistry()
        self._counters = {k: self.metrics.counter(f"serve.{k}")
                          for k in ("submitted", "admitted", "retired",
                                    "steps", "decode_items",
                                    "generated_tokens", "pages_attended",
                                    "preemptions", "retries", "rejected",
                                    "deadline_exceeded", "cancelled",
                                    "faults_injected")}
        self._g_pages = self.metrics.gauge("serve.pages_in_use")
        self._g_queue = self.metrics.gauge("serve.queue_depth")
        self._g_active = self.metrics.gauge("serve.active_slots")
        self._g_level = self.metrics.gauge("serve.degrade_level")
        self._h_ttft = self.metrics.histogram("serve.ttft_s")
        self._h_latency = self.metrics.histogram("serve.latency_s")
        self._h_plan = self.metrics.histogram("serve.decode_plan_s")
        self._h_round = self.metrics.histogram("serve.decode_round_s")
        self._h_device = self.metrics.histogram("serve.decode_device_s")

    def _make_hooks(self, path: str) -> EngineHooks:
        make = {"kernel": _make_paged_decode_round_fn,
                "bounded": _make_bounded_decode_round_fn,
                "gather": functools.partial(_make_decode_round_fn,
                                            paged=self.paged)}[path]
        return EngineHooks(
            arg_width=2,
            round_fn=make(self.cfg, self.pool.page_size, self.sampling,
                          self.guard),
            statics=functools.partial(_weak(self._statics_for), path),
            buffers=_weak(self._buffers),
            writeback=_weak(self._writeback),
            row_access=_decode_row_access,
        )

    @property
    def stats(self) -> Dict[str, int]:
        """Exact lifecycle counts as a plain dict — a view over the
        metrics registry (``GenerateService.metrics`` is the full one)."""
        return {k: c.value for k, c in self._counters.items()}

    @property
    def decode_path_active(self) -> str:
        """The rung of the degrade ladder the next tick will run on
        (equals ``decode_path`` until a fault degrades it)."""
        return self._ladder[self._level]

    @property
    def hooks(self) -> EngineHooks:
        """EngineHooks for the currently active decode path (the lower
        rung's after a degrade, the selected path's after promotion)."""
        return self._hooks_by_path[self.decode_path_active]

    def _now(self) -> float:
        """The service's virtual clock: the tracer clock plus any stall
        skew injected by the chaos harness."""
        return _trace.now() + self._skew

    # -- public API ----------------------------------------------------------
    def inject(self, faults: Optional[FaultPlan]) -> None:
        """Install (or clear) a chaos plan.  Requires the decode guard:
        injected NaNs must flow through the real detection path."""
        if faults is not None and not self.guard:
            raise ValueError("chaos injection requires guard=True — "
                             "injected faults must hit the real "
                             "finiteness check")
        self._faults = faults

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               deadline_ms: Optional[float] = None) -> Request:
        """Queue one request.  Tokens arrive in ``Request.generated`` as
        the service steps; the first token comes from prefill.  Raises
        :class:`QueueFull` when a bounded queue is at capacity."""
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._counters["rejected"].inc()
            raise QueueFull(
                f"admission queue full ({len(self._queue)} >= "
                f"max_queue={self.max_queue})",
                queue_depth=len(self._queue), max_queue=self.max_queue)
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.size < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens >= 1")
        positions = int(prompt.size) + max_new_tokens - 1
        if self.paged and positions > self.max_seq:
            raise ValueError(
                f"request needs {positions} cache positions, service "
                f"max_seq is {self.max_seq}")
        req = Request(self._next_rid, prompt, max_new_tokens)
        req.t_submit = self._now()
        eff = deadline_ms if deadline_ms is not None else self.deadline_ms
        if eff is not None:
            req.deadline_s = req.t_submit + eff / 1e3
        self._next_rid += 1
        self._queue.append(req)
        self._requests[req.rid] = req
        self._counters["submitted"].inc()
        self._g_queue.set(len(self._queue))
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel a live request: a queued one retires immediately, an
        active one is preempted (pages reclaimed) and retires.  Returns
        False for unknown or already-terminal rids."""
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        if req.slot >= 0:
            self._preempt(req.slot, requeue=False, status=ST_CANCELLED,
                          reason="cancel")
        else:
            self._queue.remove(req)
            self._retire(req, ST_CANCELLED)
        return True

    def step(self) -> bool:
        """One service tick: fire scheduled faults, sweep deadlines,
        admit whatever fits (conflict-round prefill), then one guarded
        continuous-batched decode over every active slot.  Returns True
        while any request is queued or in flight."""
        tick = self._counters["steps"].value
        before = (self._counters["admitted"].value,
                  self._counters["retired"].value)
        self._apply_faults(tick)
        self._sweep_deadlines()
        self._admit()
        slots = sorted(self._active)
        progressed = False
        if slots:
            # pages each slot's walk touches this tick (incl. the cell
            # being written) — what the kernel/bounded paths read
            ps = self.pool.page_size
            pages = (sum(self._active[s].pos // ps + 1 for s in slots)
                     if self.paged else len(slots))
            tr = _trace.get_tracer()
            t0 = _trace.now()
            ok_slots, events = self._decode_tick(slots)
            self._counters["decode_items"].inc(len(slots))
            self._counters["pages_attended"].inc(pages)
            tok_h = self._tok.cpu().numpy()      # one sync per tick
            pos_h = self._pos.cpu().numpy()
            if events is not None:
                self._h_device.observe(events[0].elapsed_time(events[1])
                                       / 1e3)
            if tr.enabled:
                tr.event_span("serve.decode", t0, _trace.now(),
                              lane="engine", path=self.decode_path,
                              batch=len(slots), pages_attended=pages)
            for slot in ok_slots:
                req = self._active[slot]
                req.generated.append(int(tok_h[slot]))
                req.pos = int(pos_h[slot])
                self._counters["generated_tokens"].inc()
                progressed = True
            for slot in ok_slots:
                req = self._active[slot]
                if len(req.generated) >= req.max_new_tokens:
                    self._retire(req)
        self._counters["steps"].inc()
        self._sample_gauges()
        if (progressed
                or self._counters["admitted"].value > before[0]
                or self._counters["retired"].value > before[1]):
            self._last_progress_tick = tick
        return bool(self._active or self._queue)

    def run_until_complete(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return
        raise ServiceStalled(
            f"service did not drain in {max_steps} steps: "
            f"{len(self._queue)} queued, {len(self._active)} active, "
            f"last progress at tick {self._last_progress_tick} of "
            f"{self._counters['steps'].value}",
            queue_depth=len(self._queue), active_slots=len(self._active),
            last_progress_tick=self._last_progress_tick,
            steps=self._counters["steps"].value)

    def compiled_entry_points(self) -> Dict[str, List]:
        """The service's entry-point registry: prefill by (prompt length,
        batch size), decode by batch size."""
        return {"prefill_plens": sorted({p for p, _ in self._prefill_fns}),
                "prefill_shapes": sorted(self._prefill_fns),
                "decode_batch_sizes": sorted(self.decode_batch_sizes_seen)}

    # -- fault application (chaos harness) -----------------------------------
    def _apply_faults(self, tick: int) -> None:
        if self._faults is None:
            return
        for ev in self._faults.events_at(tick):
            applied = True
            if ev.kind == "nan_decode":
                if self._active:
                    slots = sorted(self._active)
                    slot = slots[ev.victim % len(slots)]
                    self._poison_budget[slot] = max(
                        self._poison_budget.get(slot, 0), ev.sticky)
                else:
                    applied = False    # nothing decoding — fires as no-op
            elif ev.kind == "admission_fail":
                self._admission_fault = True
            elif ev.kind == "drop_prefill":
                self._prefill_fns.clear()
            elif ev.kind == "stall":
                self._skew += ev.skew_s
            if applied:
                self._counters["faults_injected"].inc()
            self.faults_fired.append((tick, ev, applied))

    def _arm_poison(self, slots: Sequence[int]) -> None:
        """Spend one round of each victim slot's poison budget by arming
        its guard flag to :data:`FLAG_POISON` — the round tail NaNs the
        armed slots' logits (see ``_finish_decode``)."""
        self._armed = set()
        if not self._poison_budget:
            return
        hit = [s for s in slots if self._poison_budget.get(s, 0) > 0]
        if not hit:
            return
        self._armed = set(hit)
        self._flags[hit] = FLAG_POISON
        for s in hit:
            self._poison_budget[s] -= 1
            if self._poison_budget[s] <= 0:
                del self._poison_budget[s]

    # -- deadlines -----------------------------------------------------------
    def _sweep_deadlines(self) -> None:
        now = self._now()
        expired_q = [r for r in self._queue
                     if r.deadline_s is not None and now >= r.deadline_s]
        for req in expired_q:
            self._queue.remove(req)
            self._retire(req, ST_DEADLINE)
        for slot in sorted(self._active):
            req = self._active[slot]
            if req.deadline_s is not None and now >= req.deadline_s:
                self._preempt(slot, requeue=False, status=ST_DEADLINE,
                              reason="deadline")

    # -- admission (conflict round + prefill family) -------------------------
    def _admit(self) -> int:
        batch: List[Request] = []
        while self._queue and self._free_slots:
            req = self._queue[0]
            need = self.pool.pages_needed(req.total_positions)
            if not self.pool.can_admit(need):
                break
            self._queue.popleft()
            req.t_admit = self._now()
            req.slot = self._free_slots.pop()
            req.pages = self.pool.alloc(need, owner=req.rid)
            batch.append(req)
        if not batch:
            return 0
        # lower the batch as a conflict round over canonical page
        # resources (single round + single coloring phase proven by
        # plan_admission), then execute the PREFILL family through the
        # rounds backend
        try:
            if self._admission_fault:
                self._admission_fault = False
                raise AdmissionConflict("injected admission failure (chaos)")
            sched, plan = self.pool.plan_admission(
                [r.pages for r in batch], TT_PREFILL, datas=batch,
                nr_lanes=self.nr_lanes)
        except AdmissionConflict:
            # roll back: pages to the free list, slots returned, requests
            # requeued in arrival order — retried next tick
            for req in reversed(batch):
                self.pool.free(req.pages)
                req.pages = []
                self._free_slots.append(req.slot)
                req.slot = -1
                self._queue.appendleft(req)
            self.pool.check_invariants()
            self._counters["retries"].inc(len(batch))
            return 0
        run_plan(sched, self.registry, "rounds", plan=plan)
        self._counters["admitted"].inc(len(batch))
        for req in batch:
            req.status = "active"
            if len(req.generated) >= req.max_new_tokens:
                self._retire(req)      # prompt-only requests never decode
        return len(batch)

    def _run_prefill(self, tid: int, req: Request) -> None:
        self._prefill_group([req])

    def _run_prefill_batch(self, tids: Sequence[int],
                           reqs: Sequence[Request]) -> None:
        """Batched multi-request prefill: same-length feeds admitted in
        one conflict round share one entry point (one forward pass over a
        ``(nb, plen)`` token block instead of nb B=1 calls)."""
        groups: Dict[int, List[Request]] = {}
        for req in reqs:
            groups.setdefault(len(req.feed_tokens()), []).append(req)
        for group in groups.values():
            self._prefill_group(group)

    def _prefill_group(self, reqs: List[Request]) -> None:
        feeds = [req.feed_tokens() for req in reqs]
        plen = int(feeds[0].size)
        nb = len(reqs)
        fn = self._prefill_fns.get((plen, nb))
        if fn is None:
            fn = self._prefill_fns[(plen, nb)] = self._make_prefill_fn(
                plen, nb)
        np_p = self.pool.pages_needed(plen)
        # only the first ceil(plen/ps) pages hold prompt positions; the
        # rest of each request's pages fill one decode cell at a time
        page_ids = np.zeros((nb, np_p), np.int64)
        pt_rows = np.zeros((nb, self.max_pages), np.int32)
        for i, req in enumerate(reqs):
            page_ids[i] = req.pages[:np_p]
            pt_rows[i, :len(req.pages)] = req.pages
        dev = self.device
        tok0 = fn(torch.as_tensor(np.stack(feeds), device=dev),
                  torch.as_tensor(page_ids, device=dev),
                  torch.as_tensor(pt_rows, device=dev),
                  torch.as_tensor([r.slot for r in reqs], device=dev),
                  torch.as_tensor([r.rid for r in reqs], device=dev))
        tok0_h = tok0.cpu().numpy()
        t = self._now()                # prefill yields the next token
        for i, req in enumerate(reqs):
            req.generated.append(int(tok0_h[i]))
            req.pos = plen
            if not req.t_first:
                req.t_first = t
            self._active[req.slot] = req
            self._counters["generated_tokens"].inc()

    def _make_prefill_fn(self, plen: int, nb: int) -> Callable:
        cfg = self.cfg
        paged = self.paged
        ps = self.pool.page_size
        np_p = self.pool.pages_needed(plen)
        pad_to = np_p * ps - plen
        sampling = self.sampling
        # what the entry point updates, taken here and not through self: it
        # is kept in self._prefill_fns, and a reference back would make a
        # cycle that holds the model after the service is dropped
        params, leaves = self.params, self.pool.leaves
        pt_buf, tok_buf, pos_buf, rid_buf = (self._pt, self._tok, self._pos,
                                             self._rid)

        def prefill_entry(tokens, page_ids, pt_rows, slots, rids):
            logits, cache, _ = serving_mod.prefill(params, cfg, tokens)
            if paged:
                cache = serving_mod.pad_seq(cache, pad_to)  # (L, nb, np_p*ps, ...)
                for k, leaf in leaves.items():
                    c = cache[k]
                    c = c.reshape((c.shape[0], nb, np_p, ps) + c.shape[3:])
                    leaf[:, page_ids] = c.to(leaf.dtype)
            else:               # each request's state into its one page
                for k, leaf in leaves.items():
                    leaf[:, page_ids[:, 0]] = cache[k].to(leaf.dtype)
            rid_buf[slots] = rids
            positions = torch.full_like(rids, plen)
            tok0 = serving_mod.sample_tokens(
                logits, sampling.temperature, sampling.top_k, sampling.seed,
                rids, positions)
            pt_buf[slots] = pt_rows
            tok_buf[slots] = tok0
            pos_buf[slots] = plen
            return tok0

        return prefill_entry

    # -- decode (engine task family) -----------------------------------------
    def _decode_tick(self, slots: List[int]) -> Tuple[List[int], Any]:
        """One guarded decode round over ``slots``.  Runs the active
        ladder rung; with the guard on, reads the per-slot finiteness
        flags afterwards, retries any tripped slot once on the gather
        round function (restoring the slot's pre-round token / position /
        request id from clones taken before the round), and preempts slots
        whose retry trips too.  A kernel round on the card that trips a
        slot no fault was injected into raises :class:`KernelFault`.
        Returns the slots whose tokens this tick are trustworthy, and on
        the card the CUDA events around the round (else None)."""
        # the round updates the slot state in place, so the pre-round
        # values a retry restores must be copies
        prev = None
        if self.guard:
            # an SSM round overwrites each slot's whole state, so a retry
            # must start from the pre-round state too: the round's slots'
            # state rows (leaf[:, ids] copies them)
            state = None
            if not self.paged:
                ids = self._pt[slots, 0].long()
                state = (slots, ids, {k: leaf[:, ids] for k, leaf
                                      in self.pool.leaves.items()})
            prev = (self._tok.clone(), self._pos.clone(), self._rid.clone(),
                    state)
        self._arm_poison(slots)
        t0 = time.perf_counter()
        sched = self._decode_sched(slots)
        plan = lower(sched, self.nr_lanes)
        t1 = time.perf_counter()
        self._h_plan.observe(t1 - t0)
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        path = self.decode_path_active
        run_plan(sched, self.registry, "engine", plan=plan,
                 engine=self._hooks_by_path[path])
        if events is not None:
            events[1].record()
        self._h_round.observe(time.perf_counter() - t1)
        self.decode_batch_sizes_seen.add(len(slots))
        if not self.guard:
            return slots, events
        flags_h = self._flags.cpu().numpy()
        bad = [s for s in slots if flags_h[s] != FLAG_OK]
        if not bad:
            self._note_clean_tick()
            return slots, events
        organic = [s for s in bad if s not in self._armed]
        if organic and path == "kernel" and self.device.type == "cuda":
            raise KernelFault(
                f"the paged decode kernel gave non-finite logits for slots "
                f"{organic} with no "
                f"fault injected (a position or page id out of range, or a "
                f"non-finite model); not recomputing them on the plain path",
                slots=organic)
        # faulted round: the victims' token/position advanced with
        # garbage — restore them and re-run just those slots on the
        # reference path.  The faulted round's KV-cell writes need no
        # undo: the retry rewrites the victims' cells at the same
        # (page, offset), and decode masks everything beyond pos.  An SSM
        # round's state writes do: _restore puts the pre-round state back
        # (the reference re-ran the retry on the advanced state).
        self._counters["retries"].inc(len(bad))
        self.retried_rids.update(self._active[s].rid for s in bad)
        self._note_fault_tick()
        self._restore(bad, prev)
        self._arm_poison(bad)          # sticky faults poison the retry too
        rsched = self._decode_sched(bad)
        run_plan(rsched, self.registry, "engine",
                 plan=lower(rsched, self.nr_lanes),
                 engine=self._hooks_by_path[self._ladder[-1]])
        flags_h = self._flags.cpu().numpy()
        still_bad = [s for s in bad if flags_h[s] != FLAG_OK]
        for s in still_bad:
            # restore once more so the requeued request's host state is
            # consistent (its generated list never saw this tick)
            self._restore([s], prev)
            self._preempt(s, requeue=True, reason="nan_decode")
        return [s for s in slots if s not in still_bad], events

    def _restore(self, slots: Sequence[int], prev: Tuple) -> None:
        idx = torch.as_tensor(list(slots), device=self.device)
        for buf, snap in zip((self._tok, self._pos, self._rid), prev[:3]):
            buf[idx] = snap[idx]
        if prev[3] is not None:        # the SSM state rows of the slots
            order, ids, rows = prev[3]
            at = torch.as_tensor([order.index(s) for s in slots],
                                 device=self.device)
            for k, leaf in self.pool.leaves.items():
                leaf.index_copy_(1, ids[at], rows[k][:, at])

    def _note_fault_tick(self) -> None:
        """Degrade one rung with exponential backoff: each consecutive
        faulted tick doubles the clean-tick cooldown a rung must survive
        before promotion back up the ladder."""
        self._fault_streak += 1
        self._cooldown = min(2 ** self._fault_streak, 256)
        if self._level < len(self._ladder) - 1:
            self._level += 1
            if self.device.type == "cuda":
                warnings.warn(f"serve: decode degraded to the "
                              f"{self.decode_path_active!r} path on the card "
                              f"after a faulted tick", RuntimeWarning,
                              stacklevel=2)
        self._g_level.set(self._level)

    def _note_clean_tick(self) -> None:
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        if self._level > 0:
            self._level -= 1           # promote one rung per clean window
            self._g_level.set(self._level)
        else:
            self._fault_streak = 0

    def _decode_sched(self, slots: Sequence[int]) -> QSched:
        """Canonical decode graph: one DECODE task per active slot locking
        one state resource under a root.  The payload carries ``(slot,
        pos)`` — task data is excluded from the structural hash, so the
        plan cache key depends only on the batch size."""
        s = QSched()
        root = s.addres()
        for slot in slots:
            rid = s.addres(parent=root)
            tid = s.addtask(type=TT_DECODE,
                            data=(int(slot), int(self._active[slot].pos)))
            s.addlock(tid, rid)
        return s

    def _encode_decode(self, tid: int, data: Tuple[int, int]):
        slot, pos = data
        return [(ENG_DECODE, int(slot), int(pos))]

    def _no_host_decode(self, tid: int, data) -> None:
        raise NotImplementedError(
            "the decode family is device-resident; run it through the "
            "'engine' backend")

    def _statics_for(self, path: str) -> Tuple:
        if path != "bounded":
            return (self.params,)
        # page-walk bound for this round
        mx = max((r.pos for r in self._active.values()), default=0)
        return (self.params,
                min(self.max_pages, mx // self.pool.page_size + 1))

    def _buffers(self) -> Tuple:
        # a tensor first: the engine runs on the first buffer's device
        return (self._pt, self._tok, self._pos, self._rid, self._flags,
                self.pool.leaves)

    def _writeback(self, buffers: Tuple) -> None:
        del buffers        # the round functions update every buffer in place

    def _sample_gauges(self) -> None:
        """Sample occupancy/depth gauges and, when a tracer is enabled,
        emit them as counter-track samples."""
        in_use = self.pool.allocated
        self._g_pages.set(in_use)
        self._g_queue.set(len(self._queue))
        self._g_active.set(len(self._active))
        tr = _trace.get_tracer()
        if tr.enabled:
            t = _trace.now()
            tr.counter("serve.pages_in_use", in_use, t=t)
            tr.counter("serve.queue_depth", len(self._queue), t=t)
            tr.counter("serve.active_slots", len(self._active), t=t)
            tr.counter("serve.pages_attended",
                       self._counters["pages_attended"].value, t=t)
            for k in ("preemptions", "retries", "rejected",
                      "deadline_exceeded"):
                tr.counter(f"serve.{k}", self._counters[k].value, t=t)

    # -- eviction / retirement -----------------------------------------------
    def _preempt(self, slot: int, *, requeue: bool, status: str = ST_DONE,
                 reason: str = "") -> None:
        """Evict the request occupying ``slot``: zero its row of the slot
        state in place (page-table row, token, position, request id and
        guard flag, so a stale row can never alias a later tenant; no
        other slot's row and no page changes), return its pages to the
        pool free list with conservation asserted, then either requeue it
        for re-admission or retire it with ``status``."""
        req = self._active.pop(slot)
        t0 = self._now()
        for buf in (self._pt, self._tok, self._pos, self._rid):
            buf[slot] = 0
        self._flags[slot] = FLAG_OK
        self.pool.free(req.pages)
        req.pages = []
        self.pool.check_invariants()   # page conservation, every eviction
        self._free_slots.append(slot)
        self._poison_budget.pop(slot, None)
        req.slot = -1
        req.pos = 0
        req.preemptions += 1
        self._counters["preemptions"].inc()
        self.faulted_rids.add(req.rid)
        tr = _trace.get_tracer()
        if tr.enabled:
            tr.event_span("request.preempted", t0, self._now(),
                          lane=f"req {req.rid}", process="requests",
                          rid=req.rid, reason=reason, requeue=requeue,
                          tokens_so_far=len(req.generated))
        if requeue:
            req.status = "queued"
            self._queue.appendleft(req)
            self._g_queue.set(len(self._queue))
        else:
            self._retire(req, status)

    def _retire(self, req: Request, status: str = ST_DONE) -> None:
        if status not in TERMINAL_STATES:
            raise ValueError(f"not a terminal state: {status!r}")
        if req.pages:
            self.pool.free(req.pages)
            req.pages = []
        if req.slot >= 0:
            self._active.pop(req.slot, None)
            self._free_slots.append(req.slot)
            req.slot = -1
        req.status = status
        req.done = True
        req.t_done = self._now()
        if not req.t_first:            # never produced a token
            req.t_first = req.t_done
        self._requests.pop(req.rid, None)
        self._counters["retired"].inc()
        if status == ST_CANCELLED:
            self._counters["cancelled"].inc()
            self.faulted_rids.add(req.rid)
        elif status == ST_DEADLINE:
            self._counters["deadline_exceeded"].inc()
            self.faulted_rids.add(req.rid)
        self._h_ttft.observe(req.ttft_s)
        self._h_latency.observe(req.latency_s)
        tr = _trace.get_tracer()
        if tr.enabled:
            # request lifecycle as phases on one lane per request: queued
            # (submit->admit), prefill (admit->first token), decode (first
            # token->retire); stages a request never reached emit no span
            lane = f"req {req.rid}"
            kw = dict(lane=lane, process="requests", rid=req.rid)

            def span(name, t0, t1, **extra):
                if t1 >= t0 > 0:
                    tr.event_span(name, t0, t1, **kw, **extra)

            span("request.queued", req.t_submit, req.t_admit or req.t_done)
            span("request.prefill", req.t_admit, req.t_first,
                 prompt_len=int(req.prompt.size))
            if req.t_done > req.t_first:
                span("request.decode", req.t_first, req.t_done,
                     tokens=len(req.generated))
            span("request", req.t_submit, req.t_done, status=status,
                 ttft_s=req.ttft_s, latency_s=req.latency_s)
