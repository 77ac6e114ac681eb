"""Logical→physical activation-sharding constraints.  The port of
``repro/dist/act_sharding.py``.

Model code annotates intermediates with *logical* axis names,

    x = constrain(x, "dp", None, "tp", None)

never with mesh axis names.  Outside an ``activation_sharding`` context
the call returns ``x`` untouched, and so it does for a tensor that is not
a DTensor, so the exact same model code runs unsharded (and bitwise as
before) on one device.  Inside the context each logical name resolves to
the mesh axes the launcher chose — e.g. ``"dp"`` → ``("pod", "data")`` on
the multi-pod mesh, ``"tp"`` → ``"model"`` — and a DTensor is
redistributed to the resulting placements over its own mesh (the
reference's ``with_sharding_constraint`` against the ambient mesh):

    with activation_sharding(("pod", "data"), "model"):
        step(params, opt_state, batch)      # launch/dryrun.py --act-shard

Entries whose dimension does not divide evenly over the resolved axes, or
that name an axis the mesh lacks, are dropped (replicated) instead of
failing, so one annotation serves every (config × mesh) cell of the
dry-run grid.

``on_shards`` is the port's counterpart of what GSPMD did for the
reference inside attention, the SSM scans and the MoE dispatch, where
DTensor's per-operator rules do not reach (batched products over two
sharded batch dims, padding, sorts and scatters): it resolves logical
specs to placements and hands them to torch's ``local_map``, which
redistributes the DTensor inputs, runs a plain function on each device's
local shards, and wraps the results back as DTensors.  On plain tensors
it is a plain call, and so are ``linear``, ``lookup`` and the attention
and scan regions, which test their arguments before building a spec.
``linear`` and ``lookup`` are the two regions every layer uses: a
product with a weight (each device's batch rows against the weight
gathered over its input dim, its output dim over "tp": FSDP with column
tensor parallelism) and an embedding lookup.
"""

from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from .sharding import P, axis_sizes, placements_for

Axes = Union[str, Tuple[str, ...], None]

_MAPPING: ContextVar[Optional[Dict[str, Axes]]] = ContextVar(
    "activation_sharding_mapping", default=None)


@contextlib.contextmanager
def activation_sharding(dp: Axes = "data", tp: Axes = "model"):
    """Activate ``constrain`` with the given logical→mesh axis mapping."""
    token = _MAPPING.set({"dp": dp, "tp": tp})
    try:
        yield
    finally:
        _MAPPING.reset(token)


def _as_tuple(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _resolve(shape, spec, mapping: Dict[str, Axes],
            sizes: Dict[str, int]) -> P:
    """The mesh spec of logical ``spec`` for a tensor of ``shape`` over a
    mesh of axis ``sizes``: names resolved, axes the mesh lacks and
    indivisible entries dropped."""
    resolved = []
    for dim, entry in zip(shape, spec):
        axes = mapping.get(entry, entry) if entry is not None else None
        if axes is None:
            resolved.append(None)
            continue
        names = _as_tuple(axes)
        if any(a not in sizes for a in names):
            resolved.append(None)
            continue
        size = 1
        for a in names:
            size *= sizes[a]
        resolved.append(axes if dim % size == 0 else None)
    return P(*resolved)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """Redistribute a DTensor to the placements of logical ``spec``; a
    no-op outside an ``activation_sharding`` context or on a tensor that
    is not a DTensor.

    ``spec`` entries are ``"dp"``, ``"tp"``, a raw mesh axis name, or
    ``None`` (replicated); trailing dims may be omitted.
    """
    mapping = _MAPPING.get()
    if mapping is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    pspec = _resolve(x.shape, spec, mapping, axis_sizes(mesh))
    want = placements_for(pspec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, list(want))


def _region_axes(sizes: Dict[str, int],
                 divides: Dict[str, int]) -> Dict[str, Axes]:
    """The mesh axes each logical axis of a region takes: the context's
    mapping (outside one, the production convention: "dp" the pod and
    data axes, "tp" the model axis), kept where the mesh has every one of
    them and their sizes divide the dim given in ``divides``."""
    mapping = _MAPPING.get() or {
        "dp": tuple(a for a in ("pod", "data") if a in sizes) or None,
        "tp": "model" if "model" in sizes else None}
    out: Dict[str, Axes] = {}
    for name, n in divides.items():
        axes = mapping.get(name)
        names = _as_tuple(axes) if axes else ()
        ok = (names and all(a in sizes for a in names)
              and n % math.prod(sizes[a] for a in names) == 0)
        out[name] = axes if ok else None
    return out


def sharded(*ts) -> bool:
    """Whether any of ``ts`` is a DTensor (else a region is a plain call)."""
    return any(isinstance(t, DTensor) for t in ts)


def on_shards(fn: Callable, args: Sequence[torch.Tensor],
              in_specs: Sequence, out_specs, divides: Dict[str, int]):
    """``fn(*args)`` run on each device's local shards.

    ``in_specs[i]`` is a logical spec (``"dp"``, ``"tp"`` or None per dim)
    for tensor ``args[i]``; ``out_specs`` is one spec, or a tuple of specs
    for a tuple result.  A logical axis shards only where its mesh axes
    divide ``divides[name]`` (every spec of the region then agrees).  The
    placements go to torch's ``local_map``, which redistributes each
    DTensor input to its spec's placements (the region's collectives),
    runs ``fn`` on the local shards and wraps the results.  A plain tensor
    input counts as replicated.  An input that is whole along a mesh dim
    the region splits over gets its gradient as a partial sum there (each
    device's part of the work contributes to it).  When no input is a
    DTensor this is ``fn(*args)``.
    """
    if not sharded(*args):
        return fn(*args)
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    axes = _region_axes(axis_sizes(mesh), divides)

    def at(spec):   # a list: local_map reads a tuple as one per output
        return list(placements_for(
            P(*(axes.get(e) if e is not None else None for e in spec)),
            mesh))

    placed = [at(spec) for spec in in_specs]
    # the mesh dims the region splits its work over: an input whole along
    # one of them gets a partial sum of its gradient from each device
    split = {i for pl in placed for i, p in enumerate(pl) if p.is_shard()}
    grads = [tuple(Partial() if i in split and not p.is_shard() else p
                   for i, p in enumerate(pl)) for pl in placed]
    whole = [Replicate()] * mesh.ndim
    args = [a if isinstance(a, DTensor)
            else DTensor.from_local(a, mesh, whole, run_check=False)
            for a in args]
    many = bool(out_specs) and all(isinstance(s, tuple) for s in out_specs)
    outs = tuple(map(at, out_specs)) if many else at(out_specs)
    return local_map(fn, outs, placed, grads, mesh,
                     redistribute_inputs=True)(*args)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations ``x (B, ..., d_in)`` and a weight ``w
    (d_in, d_out)``.  On DTensors each device multiplies its batch rows
    (dim 0 over "dp") of ``x``, whole along ``d_in``, by ``w`` gathered
    over ``d_in`` and kept over "tp" along ``d_out``; the product comes out
    batch over "dp", ``d_out`` over "tp"."""
    if not sharded(x, w):
        return torch.matmul(x, w)
    rows = (None,) * (x.dim() - 2)
    return on_shards(torch.matmul, (x, w),
                     (("dp",) + rows + (None,), (None, "tp")),
                     ("dp",) + rows + ("tp",),
                     {"dp": x.shape[0], "tp": w.shape[-1]})


def batched_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(x, w)`` for a stack of weights ``w (E, d_in, d_out)``
    (the experts) and ``x (E, C, d_in)``: each device holds ``x`` whole and
    ``w`` gathered over ``d_in``, ``d_out`` over "tp"."""
    if not sharded(x, w):
        return torch.bmm(x, w)
    return on_shards(torch.bmm, (x, w), ((None, None, None),
                                         (None, None, "tp")),
                     (None, None, "tp"), {"tp": w.shape[-1]})


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an embedding ``table (V, d)`` and indices ``idx
    (B, ...)``: on DTensors each device looks up its batch rows in the
    table gathered over ``V``, ``d`` over "tp"."""
    if not sharded(table, idx):
        return table[idx]
    rows = (None,) * (idx.dim() - 1)
    return on_shards(_take, (table, idx), ((None, "tp"), ("dp",) + rows),
                     ("dp",) + rows + ("tp",),
                     {"dp": idx.shape[0], "tp": table.shape[-1]})
