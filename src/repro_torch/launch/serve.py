"""Serving entry points of the port, on the card by default.

Continuous batching (``--continuous``): the ``repro_torch.serve``
service — a paged block pool, admission lowered as a QuickSched conflict
round, and engine-backed batched decode with per-step join/leave; on the
card its decode walks the pool with K10 (GQA) or K11 (MLA).  The SSM
family (``--arch falcon-mamba-7b``) keeps one O(1) state slot a request
and decodes on the ``gather`` path everywhere.  The hybrid, enc-dec and
VLM families raise there, as in the reference.
``--new-tokens`` is the *maximum* budget; per-request budgets are drawn
ragged so requests retire mid-stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --continuous --batch 4 --prompt-len 8 --new-tokens 32

Static batch (:func:`generate`): prefill a batch of prompts, then decode
against a contiguous cache until the slowest member finishes.  Every
family runs here; the VLM and enc-dec families get the reference's stub
inputs, zero patch embeddings (``vis_embeds``) or zero encoder frames
(``frames``) in ``cfg.dtype`` (``models.lm.stub_inputs``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --batch 4 --prompt-len 16 --new-tokens 32

``--device cpu`` runs the plain PyTorch path on the CPU (add
``--reduced`` there: the published widths are for the card).  Weights
are random, drawn from ``--seed`` on the device.  The port's counterpart
of ``repro/launch/serve.py``.
"""

from __future__ import annotations

import argparse
import time
from collections import Counter

import numpy as np
import torch

from repro_torch import resolve_device


def _setup(args):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.obs import enable as obs_enable

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    lm.check_family(cfg, "repro_torch.launch.serve")
    if args.trace:
        obs_enable()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    return dev, cfg, lm.init_params(gen, cfg)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _continuous_main(args) -> None:
    from repro_torch.obs import write_chrome_trace
    from repro_torch.serve import (FaultPlan, GenerateService, QueueFull,
                                   SamplingParams)

    dev, cfg, params = _setup(args)
    page = 8
    max_seq = -(-(args.prompt_len + args.new_tokens - 1) // page) * page
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, seed=args.seed)
    faults = None
    if args.chaos_seed is not None:
        faults = FaultPlan.seeded(args.chaos_seed, args.chaos_ticks)
        print(f"chaos: seed={args.chaos_seed} over {args.chaos_ticks} "
              f"ticks -> {faults.summary()}")
    svc = GenerateService(params, cfg, max_batch=args.batch,
                          max_seq=max_seq, page_size=page,
                          decode_path=args.decode_path, sampling=sampling,
                          max_queue=args.max_queue,
                          deadline_ms=args.deadline_ms,
                          guard=not args.no_guard, faults=faults,
                          device=dev)
    print(f"decode path: {svc.decode_path} (requested {args.decode_path}, "
          f"guard={'on' if svc.guard else 'off'}, device {dev})")
    rng = np.random.default_rng(args.seed)
    handles = []
    for _ in range(3 * args.batch):
        prompt = rng.integers(0, cfg.vocab, args.prompt_len, dtype=np.int32)
        budget = int(rng.choice([args.new_tokens // 8 or 1,
                                 args.new_tokens // 2 or 1, args.new_tokens]))
        try:
            handles.append(svc.submit(prompt, budget))
        except QueueFull as e:
            print(f"  rejected (queue {e.queue_depth}/{e.max_queue})")
    t0 = time.perf_counter()
    svc.run_until_complete()
    _sync(dev)
    dt = time.perf_counter() - t0
    s = svc.stats
    done = s["generated_tokens"]
    print(f"continuous: {len(handles)} requests, {done} tokens in "
          f"{s['steps']} steps, {dt:.2f}s ({done / dt:.1f} tok/s)")
    print(f"entry points: {svc.compiled_entry_points()}")
    print(f"robustness: retries={s['retries']} "
          f"preemptions={s['preemptions']} rejected={s['rejected']} "
          f"deadline_exceeded={s['deadline_exceeded']} "
          f"cancelled={s['cancelled']} faults_injected={s['faults_injected']}")
    print(f"terminal states: {dict(Counter(h.status for h in handles))}")
    if not all(h.done for h in handles):
        raise RuntimeError("a request never reached a terminal state")
    if svc.pool.allocated:
        raise RuntimeError(f"{svc.pool.allocated} pages leaked")
    svc.pool.check_invariants()
    if args.trace:
        info = write_chrome_trace(args.trace, registry=svc.metrics)
        print(f"trace: {args.trace} ({info['events']} events, "
              f"{len(info['counter_tracks'])} counter tracks) — open in "
              f"https://ui.perfetto.dev")
    print("greedy continuations (token ids):")
    for h in handles[:4]:
        print(f"  rid={h.rid} n={len(h.generated)}:", h.generated[:16])


def generate(params, cfg, tokens: torch.Tensor, new_tokens: int,
             extra=None) -> dict:
    """Static-batch greedy generation: ``serving.prefill`` of the prompts
    ``tokens`` (B, S) (with ``extra``), the cache padded by
    ``new_tokens`` positions (``serving.pad_seq``), then ``new_tokens``
    ``serving.decode_step``s.  Returns ``ids`` (B, 1 + new_tokens) — the
    prefill's token, then one a step — the final ``cache`` and ``pos``,
    and the host seconds of the prefill and of the decode loop (each
    ends synchronised with the device)."""
    from repro_torch.models import serving
    from repro_torch.obs import get_tracer

    dev, tr = tokens.device, get_tracer()
    b, s = tokens.shape
    t0 = time.perf_counter()
    with torch.no_grad():
        with tr.span("serve.prefill", batch=b, plen=s):
            logits, cache, pos = serving.prefill(params, cfg, tokens,
                                                 extra=extra)
            _sync(dev)
        prefill_s = time.perf_counter() - t0
        # pad the prompt-length cache out to the prompt plus new_tokens
        cache = serving.pad_seq(cache, new_tokens)
        tok = torch.argmax(logits, -1)[:, None]
        out = [tok]
        t0 = time.perf_counter()
        with tr.span("serve.decode", batch=b, tokens=new_tokens):
            for i in range(new_tokens):
                with tr.span("serve.decode_step", step=i):
                    logits, cache = serving.decode_step(params, cfg, cache,
                                                        tok, pos)
                    if tr.enabled:
                        _sync(dev)
                tok = torch.argmax(logits, -1)[:, None]
                pos = pos + 1
                out.append(tok)
            _sync(dev)
    return {"ids": torch.cat(out, dim=1), "cache": cache, "pos": pos,
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0}


def _static_main(args) -> None:
    from repro_torch.models import lm
    from repro_torch.obs import write_chrome_trace

    dev, cfg, params = _setup(args)
    rng = np.random.default_rng(args.seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (args.batch, args.prompt_len)),
                             device=dev)
    run = generate(params, cfg, tokens, args.new_tokens,
                   extra=lm.stub_inputs(cfg, args.batch, dev))
    print(f"prefill {args.batch}×{args.prompt_len}: {run['prefill_s']:.2f}s")
    dt = run["decode_s"]
    print(f"decode {args.new_tokens} tokens × batch {args.batch}: "
          f"{dt:.2f}s ({args.new_tokens * args.batch / dt:.1f} tok/s)")
    if args.trace:
        info = write_chrome_trace(args.trace)
        print(f"trace: {args.trace} ({info['events']} events) — open in "
              f"https://ui.perfetto.dev")
    print("greedy continuations (token ids):")
    for row in run["ids"][:4].cpu():
        print("  ", [int(t) for t in row[:16]])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the weights, the "
                         "cache and the decode run")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="run the repro_torch.serve continuous-batching "
                         "service")
    ap.add_argument("--decode-path", default="auto",
                    choices=["auto", "kernel", "bounded", "gather"],
                    help="continuous mode: decode round function — auto "
                         "takes the K10/K11 kernel on an sm_90 card and the "
                         "bounded gather elsewhere; kernel/bounded/gather "
                         "force a path")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="continuous mode: 0 = greedy (default); >0 "
                         "samples with one stream per request seeded from "
                         "--seed")
    ap.add_argument("--top-k", type=int, default=0,
                    help="continuous mode: truncate sampling to the k "
                         "highest-probability tokens (0 = full vocab)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="continuous mode: default per-request deadline")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="continuous mode: bound the admission queue")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="continuous mode: inject a seeded FaultPlan and "
                         "check the run still terminates with pages "
                         "conserved")
    ap.add_argument("--chaos-ticks", type=int, default=32,
                    help="service ticks the seeded fault plan covers")
    ap.add_argument("--no-guard", action="store_true",
                    help="continuous mode: disable the post-round "
                         "finiteness guard (and retry/degrade/preempt)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome/Perfetto trace of the run")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.continuous:
        _continuous_main(args)
    else:
        _static_main(args)


if __name__ == "__main__":
    main()
