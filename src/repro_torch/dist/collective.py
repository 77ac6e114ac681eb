"""Ring collective matmuls.  The port of ``repro/dist/collective.py``.

Instead of ``all_gather → matmul`` / ``matmul → reduce_scatter`` — which
serialize a full-size collective against a full-size matmul — these run
the collective as ``axis_size`` ring steps of point-to-point exchange,
each step paired with the per-shard matmul for the block in flight.  The
next hop's send and receive (``dist.batch_isend_irecv``) are posted before
the block product and waited after it, so the exchange overlaps the
product: the reference's ``ppermute`` ring structure.  Both functions are
called on every rank of ``group`` with that rank's shards, and are exact
(no approximation) against ``x @ w``.

Change from the reference: the ring runs over a ``torch.distributed``
process group where the reference named a ``shard_map`` axis; a rank's
place in the ring is its rank in ``group``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def _ring(group, axis_size: int):
    """(this rank's index in ``group``, the global ranks of the next and
    the previous rank of the ring)."""
    group = group if group is not None else dist.group.WORLD
    n = dist.get_world_size(group)
    if n != axis_size:
        raise ValueError(f"axis_size {axis_size} != the group's size {n}")
    idx = dist.get_rank(group)
    return (idx, dist.get_global_rank(group, (idx + 1) % n),
            dist.get_global_rank(group, (idx - 1) % n))


def _post(send: torch.Tensor, recv: torch.Tensor, nxt: int, prv: int,
          group) -> List:
    """One forward hop: ``send`` to the next rank, ``recv`` from the
    previous one; the requests to wait on."""
    return dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group),
        dist.P2POp(dist.irecv, recv, prv, group)])


def allgather_matmul(x_local: torch.Tensor, w: torch.Tensor,
                     group=None, axis_size: Optional[int] = None
                     ) -> torch.Tensor:
    """Overlapped ``all_gather(x) @ w``.

    ``x_local``: this rank's ``(m / axis_size, k)`` rows of x;
    ``w``: the replicated ``(k, n)`` weight.
    Returns the full ``(m, n)`` product on every rank.  Step i multiplies
    the x block that originated on rank ``(idx - i) % axis_size`` while
    the ring moves the blocks one hop forward.
    """
    axis_size = axis_size or dist.get_world_size(group)
    idx, nxt, prv = _ring(group, axis_size)
    m_loc = x_local.shape[0]
    out = torch.empty((m_loc * axis_size, w.shape[1]),
                      dtype=torch.promote_types(x_local.dtype, w.dtype),
                      device=x_local.device)
    chunk = x_local.contiguous()
    for i in range(axis_size):
        reqs = []
        if i + 1 < axis_size:
            nxt_chunk = torch.empty_like(chunk)
            reqs = _post(chunk, nxt_chunk, nxt, prv, group)
        src = (idx - i) % axis_size                # the block's origin rank
        out[src * m_loc:(src + 1) * m_loc] = chunk @ w
        for r in reqs:
            r.wait()
        if reqs:
            chunk = nxt_chunk
    return out


def reducescatter_matmul(x_local: torch.Tensor, w_local: torch.Tensor,
                         group=None, axis_size: Optional[int] = None
                         ) -> torch.Tensor:
    """Overlapped ``reduce_scatter(x @ w)`` over contracted shards.

    ``x_local``: ``(m, k / axis_size)`` column shard of x;
    ``w_local``: ``(k / axis_size, n)`` row shard of w.
    Returns this rank's ``(m / axis_size, n)`` rows of ``x @ w``.

    A travelling partial-sum ring: the accumulator started on rank d is
    destined for rank ``d - 1``'s output rows and arrives there after
    ``axis_size - 1`` hops, each rank adding its own shard's contribution
    (an ``(m/axis_size, k/axis_size) @ (k/axis_size, n)`` matmul) for the
    block in flight, computed while the accumulator travels.
    """
    axis_size = axis_size or dist.get_world_size(group)
    idx, nxt, prv = _ring(group, axis_size)
    m = x_local.shape[0]
    if m % axis_size:
        raise ValueError(f"rows {m} do not divide over {axis_size}")
    m_loc = m // axis_size

    def block_partial(b):
        return (x_local[b * m_loc:(b + 1) * m_loc] @ w_local).float()

    acc = block_partial((idx - 1) % axis_size)
    for i in range(1, axis_size):
        recv = torch.empty_like(acc)
        reqs = _post(acc, recv, nxt, prv, group)
        part = block_partial((idx - i - 1) % axis_size)
        for r in reqs:
            r.wait()
        acc = recv + part
    return acc.to(x_local.dtype)
