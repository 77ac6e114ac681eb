"""Fault-tolerant checkpointing.  The port of ``repro/checkpoint/ckpt.py``.

Properties, all tested:
  * **atomic**: leaves are written to ``step_<N>.tmp/`` and the directory is
    ``os.rename``d into place only after an fsync'd manifest — a crash
    mid-save never corrupts the latest checkpoint;
  * **restartable**: ``latest_step`` + deterministic data pipeline
    (``SyntheticTokens.batch_at(step)``) give bit-identical continuation;
  * **async**: ``CheckpointManager(async_save=True)`` copies the leaves to
    host memory synchronously and writes them in a background thread, so
    the train loop is blocked only for the device→host copy;
  * **retention**: keeps the newest ``keep`` checkpoints.

Format: the reference's, so checkpoints cross between the two packages:
one ``.npy`` a leaf, named by its tree path (dict keys, ``OptState``
field names and sequence indices joined by ``__``, e.g.
``opt__inner__m__embed__tok``), and ``manifest.json``.  numpy has no
bfloat16, so a bf16 leaf is written as the reference's ``np.save`` of an
``ml_dtypes`` array writes it: raw two-byte words (``descr '<V2'``,
manifest dtype ``"bfloat16"``), and read back bit for bit.

Changes from the reference: the host copy is always a copy (the train
step updates its tensors in place, so a snapshot that shared their memory
would change under an async write); a DTensor leaf is saved as its global
value (``full_tensor``); restore places each leaf on the device and in
the dtype of the ``like`` leaf or, given ``shardings``
(``dist.sharding.shardings_for``), as a DTensor with that leaf's
placements over its mesh — RESHARDING: whatever mesh saved it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from repro_torch.optim.tree import flatten_with_path, leaves, unflatten_like

Pytree = Any
BF16_DESCR = "<V2"     # what np.save writes for an ml_dtypes bfloat16 array


def _leaf_name(path) -> str:
    return "__".join(str(k) for k in path) or "leaf"


def _flatten_with_names(tree: Pytree):
    return [(_leaf_name(path), leaf) for path, leaf in flatten_with_path(tree)]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as numpy, with its manifest dtype name."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())            # C order


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: bfloat16 leaf of {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def _snapshot(tree: Pytree) -> List[Tuple[str, np.ndarray, str]]:
    return [(n,) + _host(l) for n, l in _flatten_with_names(tree)]


def save_checkpoint(ckpt_dir: str, step: int, tree: Pytree,
                    host_tree: Optional[list] = None) -> str:
    """Write checkpoint atomically.  ``host_tree`` (from a prior snapshot)
    skips the device→host copy (async path)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    named = host_tree if host_tree is not None else _snapshot(tree)
    manifest = {"step": step, "leaves": []}
    for name, arr, dtype in named:
        fn = f"{name}.npy"
        _save_leaf(os.path.join(tmp, fn), arr, dtype)
        manifest["leaves"].append(
            {"name": name, "file": fn, "shape": list(arr.shape),
             "dtype": dtype})
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Pytree,
                       shardings: Optional[Pytree] = None) -> Pytree:
    """Restore into the structure of ``like``: each leaf a tensor in the
    dtype of its ``like`` leaf, on that leaf's device or, if ``shardings``
    is given, placed with its ``Sharding`` (RESHARDING: the saved mesh is
    irrelevant — elastic restarts on a different topology just work)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    named = _flatten_with_names(like)
    shards = (leaves(shardings) if shardings is not None
              else [None] * len(named))
    if len(shards) != len(named):
        raise ValueError("shardings and like differ in structure")
    out = []
    for (name, leaf), shd in zip(named, shards):
        entry = by_name.get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        t = _load_leaf(os.path.join(path, entry["file"]), entry["dtype"])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {name}: ckpt {tuple(t.shape)} vs "
                f"{tuple(leaf.shape)}")
        if shd is None:
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        else:
            out.append(shd.place(t.to(dtype=leaf.dtype)))
    return unflatten_like(like, out)


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Pytree) -> None:
        self.wait()
        if not self.async_save:
            save_checkpoint(self.dir, step, tree)
            self._gc()
            return
        # synchronous device→host snapshot, asynchronous disk write
        host = _snapshot(tree)

        def work():
            try:
                save_checkpoint(self.dir, step, None, host_tree=host)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.dir)
            if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.dir)

    def restore(self, step: int, like: Pytree,
                shardings: Optional[Pytree] = None) -> Pytree:
        return restore_checkpoint(self.dir, step, like, shardings)
