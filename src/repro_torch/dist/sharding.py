"""Partition specs for params / optimizer / batch / cache trees, and their
DTensor placements.  The port of ``repro/dist/sharding.py``.

One deterministic, shape-driven rule per tree kind, over the meshes from
``launch/mesh.py`` (single-pod ``("data", "model")``, multi-pod
``("pod", "data", "model")``):

  params    — last dim → "model" (tensor parallel), second-to-last dim →
              "data" (FSDP); only the last two dims are ever candidates,
              so the leading dim of rank-≥3 stacks stays replicated.
              "pod" is pure data parallelism: parameters are replicated
              across pods.
  optimizer — the same rule on each state leaf.  Adam moments mirror the
              parameter shapes, so they inherit the parameter specs by
              construction; factored Adafactor statistics and the scalar
              step counter get their own spec from their own shapes.
  batch     — dim 0 (global batch) → the DP axes; everything else
              replicated.
  cache     — dim 1 (batch; dim 0 is the layer/site stack) → the DP axes;
              the KV-heads dim when present and divisible, else the last
              (head/latent/channel) dim → "model".

Every rule drops an axis whose size does not divide the dim, so any
(config × shape × mesh) cell of the dry-run grid places without error:
uneven cells degrade to replication, never to failure.

The rules read only ``.shape`` of each leaf (a real tensor or a ``meta``
one, see ``models.lm.param_shapes``) and the mesh's axis sizes: a
``DeviceMesh`` with named dims, or a mapping ``{axis name: size}`` (the
reference's ``AbstractMesh``: specs need no devices).  A spec is the
port's own :class:`P`; :func:`shardings_for` turns it into one DTensor
placement per mesh dim, and :func:`place` distributes a tree of tensors
with them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.optim.tree import tree_map

Pytree = Any
Entry = Union[str, Tuple[str, ...], None]


class P:
    """A partition spec: per tensor dim, a mesh axis name, a tuple of
    names (the dim split over several axes, the first the major one), or
    ``None`` (replicated); trailing dims may be omitted.  Not a tuple, so
    the tree walk keeps it as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries: Entry):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims have no names")
    return dict(zip(names, mesh.shape))


def _dp_axes(mesh, multi_pod: bool):
    """The data-parallel axes and their total size."""
    sizes = axis_sizes(mesh)
    names = ("pod", "data") if multi_pod and "pod" in sizes else ("data",)
    size = 1
    for a in names:
        size *= sizes[a]
    return (names if len(names) > 1 else names[0]), size


def _weight_spec(shape: Tuple[int, ...], mesh) -> P:
    sizes = axis_sizes(mesh)
    spec = [None] * len(shape)
    if len(shape) >= 1 and shape[-1] % sizes["model"] == 0:
        spec[-1] = "model"
    if len(shape) >= 2 and shape[-2] % sizes["data"] == 0:
        spec[-2] = "data"
    return P(*spec)


def param_pspecs(params: Pytree, mesh, multi_pod: bool = False) -> Pytree:
    """Specs for a parameter tree (leaves: tensors, real or ``meta``)."""
    del multi_pod  # parameters are pod-replicated; "pod" is pure DP
    return tree_map(lambda leaf: _weight_spec(tuple(leaf.shape), mesh),
                    params)


def opt_pspecs(pspecs: Pytree, opt_state: Pytree, mesh) -> Pytree:
    """Specs for an optimizer-state tree (``OptState`` or any tree).

    ``pspecs`` (the parameter specs) documents the contract: the rule is a
    pure function of leaf shape, so exact-shape moment tensors (AdamW m/v)
    receive identical specs to their parameters without any tree alignment.
    """
    del pspecs
    return tree_map(lambda leaf: _weight_spec(tuple(leaf.shape), mesh),
                    opt_state)


def batch_pspecs(batch: Pytree, mesh, multi_pod: bool = False) -> Pytree:
    """Specs for model-input trees: dim 0 over the DP axes when even."""
    dp, size = _dp_axes(mesh, multi_pod)

    def rule(leaf):
        spec = [None] * leaf.dim()
        if leaf.dim() >= 1 and leaf.shape[0] % size == 0:
            spec[0] = dp
        return P(*spec)

    return tree_map(rule, batch)


def cache_pspecs(cache: Pytree, cfg, mesh, multi_pod: bool = False) -> Pytree:
    """Specs for serving caches (KV / SSM state, see models/serving.py).

    Every cache leaf is layer-stacked: dim 0 is the stack (never sharded),
    dim 1 the batch.  ``cfg`` selects the TP dim: the KV-heads dim for
    attention caches when it divides "model", else the trailing
    head/latent/channel dim.
    """
    dp, size = _dp_axes(mesh, multi_pod)
    model = axis_sizes(mesh)["model"]
    kv_heads = {h for h in (cfg.n_kv_heads, cfg.n_heads) if h}

    def rule(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % size == 0:
            spec[1] = dp
        if (len(shape) >= 4 and shape[-2] in kv_heads
                and shape[-2] % model == 0):
            spec[-2] = "model"
        elif len(shape) >= 3 and shape[-1] % model == 0:
            spec[-1] = "model"
        return P(*spec)

    return tree_map(rule, cache)


@dataclass(frozen=True, eq=False)
class Sharding:
    """A spec resolved against a mesh: one DTensor placement per mesh dim
    (the port's ``NamedSharding``)."""
    mesh: Any
    placements: Tuple[Any, ...]

    def place(self, t: torch.Tensor) -> DTensor:
        """``t`` (the global tensor, which every rank holds) distributed
        over the mesh: each rank keeps its own shard of it, so nothing
        crosses the wire."""
        return distribute_tensor(t, self.mesh, list(self.placements),
                                 src_data_rank=None)


def placements_for(spec: P, mesh) -> Tuple[Any, ...]:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim.  A tensor dim
    split over several axes (``("pod", "data")``) is ``Shard(d)`` on each
    of them; the tuple must list them in the mesh's order, which is the
    order DTensor splits them in (the first the major one)."""
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: axis {names[i]!r} used twice")
            out[i] = Shard(d)
    return tuple(out)


def shardings_for(pspecs: Pytree, mesh) -> Pytree:
    """Spec tree → :class:`Sharding` tree over ``mesh`` (a DeviceMesh)."""
    return tree_map(lambda s: Sharding(mesh, placements_for(s, mesh)),
                    pspecs)


def place(tree: Pytree, shardings: Pytree) -> Pytree:
    """Every leaf of ``tree`` distributed with its :class:`Sharding`."""
    return tree_map(lambda t, s: s.place(t), tree, shardings)


def unshard_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with tensor dim ``dim`` replicated over every mesh dim that
    shards it (the gather that slicing a sharded stack along its layer axis
    needs); any other tensor comes back as it is."""
    if not isinstance(t, DTensor):
        return t
    want = [Replicate() if p.is_shard(dim) else p for p in t.placements]
    if want == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def reshape(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(shape)``.  On a DTensor the reshape runs on the local
    shard, forward and backward alike (DTensor's own view rules differ
    between torch versions and refuse some backward views): the dims the
    reshape leaves alone keep their placements, and of the dims it splits
    or merges only the leading one may stay sharded, where the sharded
    count divides the leading output dim; the others are gathered
    first."""
    if not isinstance(t, DTensor):
        return t.reshape(shape)
    old = tuple(t.shape)
    known = math.prod(n for n in shape if n != -1)
    new = tuple(math.prod(old) // known if n == -1 else n for n in shape)
    lead = 0
    while lead < min(len(old), len(new)) and old[lead] == new[lead]:
        lead += 1
    tail = 0
    while (tail < min(len(old), len(new)) - lead
           and old[-1 - tail] == new[-1 - tail]):
        tail += 1
    mesh = t.device_mesh
    held, out = list(t.placements), []
    for i, p in enumerate(held):
        d = p.dim if p.is_shard() else None
        if d is None or d < lead:
            out.append(p)
        elif d >= len(old) - tail:
            out.append(Shard(d - len(old) + len(new)))
        elif (d == lead and lead < len(new) - tail
              and new[lead] % math.prod(n for n, q in zip(mesh.shape, held)
                                        if q.is_shard(d)) == 0):
            out.append(p)
        else:
            held[i] = Replicate()
            out.append(Replicate())
    if held != list(t.placements):
        t = t.redistribute(mesh, held)
    local = list(new)
    for p, n in zip(out, mesh.shape):
        if p.is_shard():
            local[p.dim] //= n
    return DTensor.from_local(t.to_local().reshape(local), mesh, out,
                              run_check=False)


def write_rows(cache: torch.Tensor, pos: torch.Tensor,
               new: torch.Tensor) -> None:
    """``cache[b, pos[b]] = new[b]`` for every row b, in place: a decode
    step's cache write (``cache`` (B, S, ...), ``pos`` (B,), ``new``
    (B, ...)).  On a DTensor cache (its batch dim sharded, its sequence
    dim never) each device writes its own rows: ``new`` and ``pos`` are
    laid out as the cache's rows and the write runs on the local shards,
    as an in-place index write over a sharded dim has no DTensor rule."""
    if not isinstance(cache, DTensor):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos] = new
        return
    mesh, held = cache.device_mesh, cache.placements
    if any(p.is_shard(1) for p in held):
        raise ValueError("the cache's sequence dim is sharded")
    new_at = [Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else p
              for p in held]
    pos_at = [Shard(0) if p.is_shard(0) else Replicate() for p in held]
    if not isinstance(pos, DTensor):
        pos = DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim)
    local = cache.to_local()
    pos_l = pos.redistribute(mesh, pos_at).to_local()
    new_l = new.redistribute(mesh, new_at).to_local()
    rows = torch.arange(local.shape[0], device=local.device)
    local[rows, pos_l] = new_l


def local_nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t`` that this device holds: its local shard for a
    DTensor, the whole tensor else."""
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()
