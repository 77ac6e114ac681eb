"""Training driver CLI of the port, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 200 --workdir /tmp/run1

The loop auto-resumes from the latest checkpoint in ``--workdir``;
``--fail-at`` injects a failure (fault-tolerance drill).  ``--device cpu``
runs the plain PyTorch path on the CPU (add ``--reduced`` there: the
published widths are for the card).  Weights are random, drawn from
``--seed`` on the device.  The port's counterpart of
``repro/launch/train.py``.

On the card the loop is deterministic (``trainer/loop.py``), which needs
``CUBLAS_WORKSPACE_CONFIG`` before the first cuBLAS call; ``main`` sets it
(to ``:4096:8``) unless the caller did, and importing torch makes no
cuBLAS call.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--workdir", default="/tmp/repro_torch_train")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="auto",
                    choices=["auto", "adamw", "adafactor"])
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome/Perfetto trace of the run "
                         "(per-step train.step spans)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    from repro_torch.configs import get_config
    from repro_torch.trainer.loop import run_training

    if args.trace:
        from repro_torch.obs import enable as obs_enable
        obs_enable()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _, _, history = run_training(
        cfg, args.workdir, args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, lr=args.lr,
        optimizer=args.optimizer, ckpt_every=args.ckpt_every,
        fail_at_step=args.fail_at, seed=args.seed, device=args.device)
    first = history[0][1] if history else float("nan")
    last = history[-1][1] if history else float("nan")
    print(f"done: {len(history)} steps, loss {first:.4f} -> {last:.4f}")
    if args.trace:
        from repro_torch.obs import write_chrome_trace
        info = write_chrome_trace(args.trace)
        print(f"trace: {args.trace} ({info['events']} events) — open in "
              f"https://ui.perfetto.dev")


if __name__ == "__main__":
    main()
