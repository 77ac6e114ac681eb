"""Deterministic synthetic token pipeline.

Generates a learnable Markov-ish token stream (next token is a fixed
permutation of the current one with noise), seeded per (epoch, step, shard)
so that (a) restarts are bit-reproducible from the step counter alone — the
checkpoint/restart test relies on this — and (b) each data-parallel shard
draws a disjoint stream.  Deterministic restart-from-step is the
fault-tolerance property a real distributed loader must provide; a file
loader would track (file, offset) the same way.

Port note: ``SyntheticTokens`` is a copy of the reference's (pure numpy);
``tests/test_torch_ckpt.py`` holds its batches array-equal to the
reference's.  The loop turns each batch into tensors on its device.
``batch_specs`` gives ``meta`` tensors where the reference gave
``ShapeDtypeStruct``s.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


class SyntheticTokens:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, noise: float = 0.1,
                 shard_id: int = 0, num_shards: int = 1):
        assert global_batch % num_shards == 0
        self.vocab = vocab
        self.seq = seq_len
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.noise = noise
        self.shard_id = shard_id
        self.num_shards = num_shards
        rng = np.random.default_rng(seed)           # shared permutation
        self.perm = rng.permutation(vocab)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, shard): restartable."""
        rng = np.random.default_rng(
            (self.seed, step, self.shard_id, 0xBEEF))
        b, s = self.local_batch, self.seq
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        flips = rng.random((b, s)) < self.noise
        rand = rng.integers(0, self.vocab, (b, s))
        for t in range(1, s):
            nxt = self.perm[toks[:, t - 1]]
            toks[:, t] = np.where(flips[:, t], rand[:, t], nxt)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def batch_specs(cfg, seq_len: int, global_batch: int,
                mode: str = "train") -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of a step — the dry run's
    input_specs() building block (no allocation)."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    dt = getattr(torch, cfg.dtype)
    specs: Dict[str, torch.Tensor] = {}
    if mode in ("train", "prefill"):
        s = seq_len
        if cfg.family == "vlm":
            s = seq_len - cfg.n_vis_tokens
            specs["vis_embeds"] = spec(
                (global_batch, cfg.n_vis_tokens, cfg.d_model), dt)
        if cfg.family == "encdec":
            specs["frames"] = spec((global_batch, cfg.enc_seq, cfg.d_model),
                                   dt)
        specs["tokens"] = spec((global_batch, s), torch.int32)
    elif mode == "decode":
        specs["tokens"] = spec((global_batch, 1), torch.int32)
        specs["pos"] = spec((global_batch,), torch.int32)
    else:
        raise ValueError(mode)
    return specs
