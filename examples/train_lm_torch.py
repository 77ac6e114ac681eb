"""End-to-end training driver of the PyTorch/CUDA port: train a small LM
for a few hundred steps with checkpoint/restart, then sample from it.  The
twin of ``examples/train_lm.py``, with the same steps, arguments and
printed lines.

Defaults to a ~10M-param qwen3-family model; ``--full-width`` scales it
to ~100M (same code path).  Run again with the same ``--workdir`` and it
resumes from the last checkpoint.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300               # H100
    PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu   # CPU

No hand-written kernel is on this path: training and the static prefill
and decode run plain PyTorch attention.  Without a card the default device
raises.  On the card training is deterministic, which needs
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before the process's first cuBLAS
call: this script sets it when run as a program.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import serving
from repro_torch.trainer.loop import run_training

CACHE_PAD = 24    # positions added to the prompt's cache: 8 + 24 = 32


def example_config(arch: str, full_width: bool):
    """The example's two widths of ``arch``'s family."""
    cfg = get_config(arch)
    if full_width:
        return cfg.reduced(d_model=768, n_layers=12, n_heads=12,
                           n_kv_heads=4, d_ff=2048, vocab=32000)
    return cfg.reduced(d_model=256, n_layers=4, n_heads=4, n_kv_heads=2,
                       d_ff=683, vocab=4096)


def greedy_sample(params, cfg, n_new: int = 16, prompt_len: int = 8):
    """Greedy decode ``n_new`` token ids after a zero prompt through the
    serving path (prefill, the cache padded by ``CACHE_PAD`` positions,
    one decode step a token), on the parameters' device."""
    if n_new > CACHE_PAD:
        raise ValueError(f"{n_new} new tokens do not fit the {CACHE_PAD} "
                         f"padded positions")
    dev = params["embed"]["tok"].device
    tokens = torch.zeros((1, prompt_len), dtype=torch.int32, device=dev)
    logits, cache, pos = serving.prefill(params, cfg, tokens)
    cache = serving.pad_seq(cache, CACHE_PAD)
    out = []
    tok = logits.argmax(-1)[:, None]
    for _ in range(n_new):
        out.append(int(tok[0, 0]))
        logits, cache = serving.decode_step(params, cfg, cache, tok, pos)
        tok = logits.argmax(-1)[:, None]
        pos = pos + 1
    return out


def main(argv=None) -> dict:
    """Train, check the loss fell, sample; returns the numbers it prints."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train_lm"))
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full-width", action="store_true",
                    help="~100M params instead of the ~10M default")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = example_config(args.arch, args.full_width)
    n_params = cfg.param_count()
    print(f"training {cfg.name} reduced: ~{n_params / 1e6:.1f}M params")

    params, _, history = run_training(
        cfg, args.workdir, args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, lr=1e-3, ckpt_every=100, device=dev)
    losses = [l for _, l in history]
    print(f"loss: start {losses[0]:.3f} → end {losses[-1]:.3f} "
          f"(best {min(losses):.3f})")
    if not losses[-1] < losses[0]:
        raise RuntimeError("loss must decrease")

    # greedy decode a few tokens through the serving path
    sample = greedy_sample(params, cfg)
    print("greedy sample token ids:", sample)
    return {"cfg": cfg, "n_params": n_params, "losses": losses,
            "sample": sample, "workdir": args.workdir}


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    main()
