"""Open-loop synthetic traffic for the serving benchmark.

Requests arrive on a Poisson process measured in *service steps* (one
step = one continuous-batched decode tick), independent of service
progress — the open-loop discipline that exposes queueing behaviour a
closed loop hides.  Prompt contents are uniform random token ids;
lengths and generation budgets are drawn from caller-supplied choices so
the stream is ragged (the regime where continuous batching beats the
static-batch loop, which must decode every batch to its slowest member).

Port note: a copy of ``repro.serve.traffic``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass(frozen=True)
class SyntheticRequest:
    arrival_step: int
    prompt: np.ndarray            # (plen,) int32
    max_new_tokens: int


def open_loop_trace(n_requests: int, *, mean_interarrival: float,
                    prompt_lens: Sequence[int],
                    new_token_lens: Sequence[int],
                    vocab_size: int, seed: int = 0,
                    ) -> List[SyntheticRequest]:
    """Draw ``n_requests`` arrivals: exponential inter-arrival gaps of
    mean ``mean_interarrival`` steps (0 = all arrive up front), prompt
    length and ``max_new_tokens`` sampled uniformly from the given
    choices.  Deterministic per seed."""
    if n_requests < 1:
        raise ValueError("need at least one request")
    rng = np.random.default_rng(seed)
    trace: List[SyntheticRequest] = []
    t = 0.0
    for _ in range(n_requests):
        if mean_interarrival > 0:
            t += rng.exponential(mean_interarrival)
        plen = int(rng.choice(np.asarray(prompt_lens)))
        n_new = int(rng.choice(np.asarray(new_token_lens)))
        prompt = rng.integers(0, vocab_size, size=plen, dtype=np.int32)
        trace.append(SyntheticRequest(int(t), prompt, n_new))
    return trace


def replay(service, trace: Sequence[SyntheticRequest],
           max_steps: int = 100_000, faults=None) -> List:
    """Feed a trace into a :class:`~repro.serve.service.GenerateService`
    open-loop: submit every request whose arrival step has passed, tick
    once, repeat until drained.  Returns the submitted Request handles in
    arrival order.

    ``faults`` installs a :class:`~repro.serve.faults.FaultPlan` on the
    service for the replay — the chaos harness's entry point for
    trace-level tests and the CI chaos smoke.  A bounded-queue service
    that rejects an arrival propagates :class:`QueueFull` to the caller
    (open-loop traffic does not retry); a replay that fails to drain
    raises the service's diagnostic :class:`ServiceStalled`."""
    from .service import ServiceStalled

    if faults is not None:
        service.inject(faults)
    pending = sorted(trace, key=lambda r: r.arrival_step)
    handles, i = [], 0
    for step in range(max_steps):
        while i < len(pending) and pending[i].arrival_step <= step:
            handles.append(service.submit(pending[i].prompt,
                                          pending[i].max_new_tokens))
            i += 1
        busy = service.step()
        if i == len(pending) and not busy:
            return handles
    raise ServiceStalled(
        f"trace did not drain in {max_steps} steps",
        queue_depth=len(service._queue),
        active_slots=len(service._active),
        last_progress_tick=service._last_progress_tick,
        steps=max_steps)
