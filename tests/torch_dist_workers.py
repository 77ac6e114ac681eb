"""Rank bodies of the spawned gloo groups in ``tests/test_torch_dist.py``
(kept apart from the test module so a spawned rank imports torch and the
port, not jax).  Each rank writes its results as ``.npy`` files that the
test reads."""

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8


def spawn(fn, tmp_dir: str, deadline_s: float = 180.0,
          world: int = WORLD) -> None:
    """Run ``fn(rank, store_path, tmp_dir)`` on ``world`` spawned ranks of
    one gloo group over a file store; fails if a rank fails or the group
    outlives ``deadline_s``."""
    store = os.path.join(tmp_dir, "store")
    ctx = mp.start_processes(fn, args=(store, tmp_dir), nprocs=world,
                             join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"gloo group of {world} ranks still running "
                               f"after {deadline_s} s")


def _init(rank: int, store_path: str, world: int = WORLD) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)


def compression_inputs():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((WORLD, 128)).astype(np.float32)
    ef = (rng.standard_normal((WORLD, 128)) * 1e-3).astype(np.float32)
    return g, ef


def compression(rank: int, store_path: str, out: str) -> None:
    from repro_torch.dist.compression import compressed_psum
    _init(rank, store_path)
    try:
        g, ef = compression_inputs()
        got, ef2 = compressed_psum({"g": torch.from_numpy(g[rank])},
                                   {"g": torch.from_numpy(ef[rank])},
                                   group=dist.group.WORLD)
        np.save(os.path.join(out, f"psum_{rank}.npy"), got["g"].numpy())
        np.save(os.path.join(out, f"ef_{rank}.npy"), ef2["g"].numpy())
    finally:
        dist.destroy_process_group()


def matmul_inputs():
    rng = np.random.default_rng(0)
    x_ag = rng.standard_normal((64, 32)).astype(np.float32)
    w_ag = rng.standard_normal((32, 16)).astype(np.float32)
    x_rs = rng.standard_normal((64, 64)).astype(np.float32)   # (m, k)
    w_rs = rng.standard_normal((64, 16)).astype(np.float32)   # (k, n)
    return x_ag, w_ag, x_rs, w_rs


def ring_matmuls(rank: int, store_path: str, out: str) -> None:
    from repro_torch.dist.collective import (allgather_matmul,
                                             reducescatter_matmul)
    _init(rank, store_path)
    try:
        x_ag, w_ag, x_rs, w_rs = matmul_inputs()
        rows = x_ag.shape[0] // WORLD
        ag = allgather_matmul(
            torch.from_numpy(x_ag[rank * rows:(rank + 1) * rows]),
            torch.from_numpy(w_ag), dist.group.WORLD, WORLD)
        cols = x_rs.shape[1] // WORLD
        rs = reducescatter_matmul(
            torch.from_numpy(x_rs[:, rank * cols:(rank + 1) * cols]),
            torch.from_numpy(w_rs[rank * cols:(rank + 1) * cols]),
            dist.group.WORLD, WORLD)
        np.save(os.path.join(out, f"ag_{rank}.npy"), ag.numpy())
        np.save(os.path.join(out, f"rs_{rank}.npy"), rs.numpy())
    finally:
        dist.destroy_process_group()


SHARDED_ARCHS = ("qwen3-1.7b", "deepseek-v3-671b", "falcon-mamba-7b")


def sharded_grads(rank: int, store_path: str, out: str) -> None:
    """On a 2x2 mesh of 4 ranks: each arch's reduced float32 loss and
    gradients on DTensors (placed by the production rules), without and
    with activation sharding, against the same on plain tensors; rank 0
    writes the loss and the worst gradient leaf's max error relative to
    its max."""
    import contextlib
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.dist.act_sharding import activation_sharding
    from repro_torch.dist.sharding import (batch_pspecs, param_pspecs,
                                           place, shardings_for)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim.tree import leaves, tree_map
    from repro_torch.trainer.steps import loss_and_grads
    _init(rank, store_path, 4)
    try:
        mesh = make_host_mesh(2, 2, device_type="cpu")
        rows = []
        for arch in SHARDED_ARCHS:
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype="float32")
            params = lm.init_params(torch.Generator().manual_seed(0), cfg)
            tokens = np.random.default_rng(0).integers(0, cfg.vocab, (8, 32))
            batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
            loss, _, grads = loss_and_grads(tree_map(torch.clone, params),
                                            cfg, batch)
            for act in (False, True):
                pd = place(tree_map(torch.clone, params),
                           shardings_for(param_pspecs(params, mesh), mesh))
                bd = place(batch, shardings_for(batch_pspecs(batch, mesh),
                                                mesh))
                with (activation_sharding("data", "model") if act
                      else contextlib.nullcontext()):
                    loss_d, _, grads_d = loss_and_grads(pd, cfg, bd)
                err = max(float((a - b.full_tensor()).abs().max()
                                / a.abs().max())
                          for a, b in zip(leaves(grads), leaves(grads_d)))
                rows.append([float(loss), float(loss_d.full_tensor()), err])
        if rank == 0:
            np.save(os.path.join(out, "sharded.npy"), np.array(rows))
    finally:
        dist.destroy_process_group()
