"""Public paged-attention decode ops over block-pool leaves: the
counterpart of ``repro/kernels/paged_attention/ops.py``, whose
``interpret`` switch is replaced by the tensors' device.

* On CPU tensors ``paged_gqa_decode`` and ``paged_mla_decode`` run their
  plain versions (``ref``).
* On CUDA tensors they launch the hand-written kernels (``kernel``: K10
  for GQA, K11 for MLA) after checking device, dtypes, shapes, contiguity
  and the shared-memory limit, and raise if the kernel cannot build or
  launch.  They never fall back to the plain version.

The contract the kernels and plain versions share with the reference:

* for slot ``t`` only the pages ``page_rows[t, : pos[t] // page_size + 1]``
  are read — never another slot's pages, never the tail of the row;
* positions beyond ``pos[t]`` take no part in the softmax;
* the cell ``(page_rows[t, pos[t] // page_size], pos[t] % page_size)`` is
  written with the new token's K/V (or latent and RoPE key) first, so
  position ``pos[t]`` attends to itself.  The pools are updated in place
  (the reference returned new arrays through aliased outputs); the ops
  return them all the same.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` the plain-version
calls taken for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import kernel, ref
from .kernel import LAUNCHES, PLAIN_CALLS, reset_counts

__all__ = ["paged_gqa_decode", "paged_mla_decode", "pages_occupied",
           "check_operands", "check_mla_operands", "check_device",
           "LAUNCHES", "PLAIN_CALLS", "reset_counts"]


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> Tuple[int, int]:
    return torch.cuda.get_device_capability(index)


def check_device(device: torch.device) -> None:
    """Raise unless ``device`` is a card K10 and K11 are built for
    (sm_90a)."""
    if device.type != "cuda":
        raise ValueError(f"K10 and K11 run on a CUDA device, not {device}")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    cc = _capability(index)
    if cc != (9, 0):
        raise RuntimeError(f"K10 and K11 are built for sm_90a (Hopper); "
                           f"cuda:{index} has compute capability "
                           f"{cc[0]}.{cc[1]}")


def _check_common(name: str, floats, page_rows, pos) -> None:
    """Device, contiguity and dtypes shared by K10's and K11's operands:
    ``floats`` (the first sets the storage type) and the int32 page rows
    and positions."""
    dev = floats[0].device
    for x in tuple(floats) + (page_rows, pos):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"kernel operands must be CUDA tensors on one "
                             f"device, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    check_device(dev)
    dt = floats[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes float32 or bfloat16, got {dt}")
    for x in floats[1:]:
        if x.dtype != dt:
            raise ValueError(f"{name}'s queries, new cells and pools must "
                             f"share one dtype, got {dt} and {x.dtype}")
    if page_rows.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("page_rows and pos must be int32")


def check_operands(q, k_new, v_new, k_pool, v_pool, page_rows, pos,
                   page_size: int) -> None:
    """Validate the operands of a K10 launch; raises ValueError, or
    RuntimeError for a card the kernel is not built for."""
    _check_common("K10", (q, k_new, v_new, k_pool, v_pool), page_rows, pos)
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be (bs, H, hd) and the pools "
                         f"(P, ps, Hkv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}")
    bs, n_heads, hd = q.shape
    n_pages, ps, n_kv, hd_p = k_pool.shape
    if (v_pool.shape != k_pool.shape or ps != page_size or hd_p != hd
            or k_new.shape != (bs, n_kv, hd) or v_new.shape != k_new.shape
            or page_rows.dim() != 2 or page_rows.shape[0] != bs
            or pos.shape != (bs,) or n_heads % n_kv):
        raise ValueError(
            f"inconsistent shapes: q {tuple(q.shape)}, k_new "
            f"{tuple(k_new.shape)}, pools {tuple(k_pool.shape)}, page_rows "
            f"{tuple(page_rows.shape)}, pos {tuple(pos.shape)}, page_size "
            f"{page_size}")
    kernel.check_shape(q.dtype, n_heads, n_kv, hd, ps)


def paged_gqa_decode(q, k_new, v_new, k_pool, v_pool, page_rows, pos, *,
                     page_size: int) -> Tuple:
    """GQA decode against a paged K/V pool.

    q ``(bs, H, hd)``; k_new/v_new ``(bs, Hkv, hd)``; pools
    ``(P, page_size, Hkv, hd)``; page_rows ``(bs, max_pages)`` int32;
    pos ``(bs,)`` int32.  Returns ``(o (bs, H, hd), k_pool, v_pool)`` with
    the pools updated in place.  On the card a position outside the row,
    or a page id outside the pool among the pages the slot walks, gives
    NaN for that slot (the kernel cannot raise) and writes nothing.
    """
    ops_in = (q, k_new, v_new, k_pool, v_pool, page_rows, pos)
    if all(x.device.type == "cpu" for x in ops_in):
        kernel.count(PLAIN_CALLS, "paged_gqa")
        return ref.paged_gqa_decode_ref(*ops_in, page_size=page_size)
    check_operands(*ops_in, page_size)
    o = torch.empty_like(q)
    if q.shape[0]:
        kernel.paged_gqa(q, k_new, v_new, k_pool, v_pool, page_rows, pos, o)
    return o, k_pool, v_pool


def check_mla_operands(q_eff, q_rope, c_new, r_new, c_pool, r_pool,
                       page_rows, pos, page_size: int) -> None:
    """Validate the operands of a K11 launch; raises ValueError, or
    RuntimeError for a card the kernel is not built for."""
    _check_common("K11", (q_eff, q_rope, c_new, r_new, c_pool, r_pool),
                  page_rows, pos)
    if q_eff.dim() != 3 or c_pool.dim() != 3:
        raise ValueError(f"q_eff must be (bs, H, lat) and the pools "
                         f"(P, ps, width), got {tuple(q_eff.shape)}, "
                         f"{tuple(c_pool.shape)}")
    bs, n_heads, lat = q_eff.shape
    n_pages, ps, lat_p = c_pool.shape
    rope = q_rope.shape[-1]
    if (q_rope.shape != (bs, n_heads, rope) or c_new.shape != (bs, lat)
            or r_new.shape != (bs, rope) or ps != page_size or lat_p != lat
            or r_pool.shape != (n_pages, ps, rope) or page_rows.dim() != 2
            or page_rows.shape[0] != bs or pos.shape != (bs,)):
        raise ValueError(
            f"inconsistent shapes: q_eff {tuple(q_eff.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, c_new {tuple(c_new.shape)}, r_new "
            f"{tuple(r_new.shape)}, pools {tuple(c_pool.shape)} and "
            f"{tuple(r_pool.shape)}, page_rows {tuple(page_rows.shape)}, "
            f"pos {tuple(pos.shape)}, page_size {page_size}")
    if not (0 < lat <= kernel.MLA_MAX_LAT and 0 < rope <= kernel.MLA_MAX_ROPE):
        raise ValueError(f"K11 takes a latent width up to "
                         f"{kernel.MLA_MAX_LAT} and a RoPE width up to "
                         f"{kernel.MLA_MAX_ROPE}, got {lat} and {rope}")
    if kernel.mla_smem_bytes(lat, rope, q_eff.dtype) > kernel.MAX_SMEM:
        raise ValueError(f"lat {lat} + rope {rope} does not fit in shared "
                         f"memory")


def paged_mla_decode(q_eff, q_rope, c_new, r_new, c_pool, r_pool,
                     page_rows, pos, *, page_size: int,
                     scale: float) -> Tuple:
    """Weight-absorbed MLA decode against the compressed latent pool.

    q_eff ``(bs, H, lat)`` (q_nope absorbed through ``w_uk``); q_rope
    ``(bs, H, rope)``; c_new ``(bs, lat)``; r_new ``(bs, rope)``; pools
    ``(P, page_size, lat)`` and ``(P, page_size, rope)``; page_rows
    ``(bs, max_pages)`` int32; pos ``(bs,)`` int32.  Returns ``(ctx (bs,
    H, lat), c_pool, r_pool)`` with the pools updated in place; the caller
    re-expands the latent context through ``w_uv``.  On the card a position
    outside the row, or a page id outside the pool among the pages the
    slot walks, gives NaN for that slot and writes nothing.
    """
    ops_in = (q_eff, q_rope, c_new, r_new, c_pool, r_pool, page_rows, pos)
    if all(x.device.type == "cpu" for x in ops_in):
        kernel.count(PLAIN_CALLS, "paged_mla")
        return ref.paged_mla_decode_ref(*ops_in, page_size=page_size,
                                        scale=scale)
    check_mla_operands(*ops_in, page_size)
    ctx = torch.empty_like(q_eff)
    if q_eff.shape[0]:
        kernel.paged_mla(*ops_in, ctx, scale)
    return ctx, c_pool, r_pool


def pages_occupied(pos: torch.Tensor, page_size: int) -> torch.Tensor:
    """Pages slot(s) at position ``pos`` occupy including the cell being
    written this step — the kernel's per-slot walk bound."""
    return pos // page_size + 1
