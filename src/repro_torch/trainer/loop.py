"""Training loop with checkpoint/restart fault tolerance.  The port of
``repro/trainer/loop.py``.

``run_training`` is restartable: given the same ``workdir`` it resumes from
the latest checkpoint and — because the data pipeline is a pure function of
the step counter — continues bit-identically (tested with a mid-run kill in
tests/test_torch_train.py, and at full width on the card by chip_smoke.py).
``fail_at_step`` injects a hard failure for that test.  With tracing on
(``repro_torch.obs``) each step records a ``train.step`` span (it ends
after the loss is read, so it covers the step's device time) and each
checkpoint a ``train.ckpt_save`` or ``train.ckpt_restore`` span.

On the card the loop runs under ``torch.use_deterministic_algorithms(True)``
(the previous setting is restored on exit): otherwise the backward passes
of the embedding gather and of the MoE combine accumulate with atomics in
a varying order, and one flipped bf16 rounding grows into a different run.
cuBLAS is deterministic only with ``CUBLAS_WORKSPACE_CONFIG`` set before
the process's first cuBLAS call; the loop raises if it is not set.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticTokens
from repro_torch.models import lm
from repro_torch.obs import trace as _trace
from .steps import make_train_step

# the settings under which cuBLAS picks the same reduction order every call
CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


class InjectedFailure(RuntimeError):
    pass


@contextlib.contextmanager
def deterministic(dev: torch.device):
    """Deterministic algorithms on ``dev`` (CUDA) for the block; raises if
    they cannot be had."""
    if dev.type != "cuda":
        yield
        return
    cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if cfg not in CUBLAS_DETERMINISTIC:
        raise RuntimeError(
            f"restart-exact training on the card needs deterministic cuBLAS: "
            f"set CUBLAS_WORKSPACE_CONFIG to one of {CUBLAS_DETERMINISTIC} "
            f"before the process's first cuBLAS call (it is {cfg!r})")
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    prev_fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    # the mode would also fill every fresh torch.empty with NaN (thousands
    # of fill kernels a full-width step); nothing here reads memory it did
    # not write, and the resume drill holds the result bit for bit
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)
        torch.utils.deterministic.fill_uninitialized_memory = prev_fill


def run_training(cfg, workdir: str, steps: int, seq_len: int = 128,
                 global_batch: int = 8, lr: float = 3e-4,
                 optimizer: str = "auto", ckpt_every: int = 50,
                 fail_at_step: Optional[int] = None, seed: int = 0,
                 log_every: int = 10, async_ckpt: bool = False,
                 log_fn: Callable[[str], None] = print, device=None):
    """Returns (params, opt_state, history list of (step, loss)).  Runs on
    ``device`` (the card unless the caller asks for the CPU); the weights
    are drawn from ``seed`` there."""
    dev = resolve_device(device)
    lm.check_family(cfg, "run_training")
    train_step, opt_init = make_train_step(
        cfg, optimizer=optimizer, lr=lr, total_steps=max(steps, 1))

    data = SyntheticTokens(cfg.vocab, seq_len, global_batch, seed=seed)
    mgr = CheckpointManager(f"{workdir}/ckpt", keep=3, async_save=async_ckpt)

    with deterministic(dev):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = lm.init_params(gen, cfg)
        opt_state = opt_init(params)
        start = 0
        latest = mgr.latest()
        if latest is not None:
            with _trace.span("train.ckpt_restore", step=latest):
                state = mgr.restore(latest, {"params": params,
                                             "opt": opt_state})
                params, opt_state = state["params"], state["opt"]
            start = latest
            log_fn(f"[resume] restored step {latest}")

        history = []
        t0 = time.time()
        for step in range(start, steps):
            if fail_at_step is not None and step == fail_at_step:
                raise InjectedFailure(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch_at(step).items()}
            # the reference's _extend_modality: zero stub inputs
            batch.update(lm.stub_inputs(cfg, batch["tokens"].shape[0], dev))
            # the float() below syncs on the result, so the span covers
            # the step's device time too
            with _trace.span("train.step", step=step) as sp:
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
                loss = float(metrics["loss"])
                sp.args["loss"] = loss
            history.append((step, loss))
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
            if step % log_every == 0:
                dt = time.time() - t0
                log_fn(f"step {step:5d} loss {loss:.4f} "
                       f"({dt / max(step - start + 1, 1):.2f}s/step)")
            if ckpt_every and (step + 1) % ckpt_every == 0:
                _save(mgr, step + 1, params, opt_state)
        mgr.wait()
        if ckpt_every:
            _save(mgr, steps, params, opt_state)
            mgr.wait()
    return params, opt_state, history


def _save(mgr: CheckpointManager, step: int, params, opt_state) -> None:
    # the span covers the device→host copy, and the disk write unless the
    # manager writes asynchronously
    with _trace.span("train.ckpt_save", step=step):
        mgr.save(step, {"params": params, "opt": opt_state})
