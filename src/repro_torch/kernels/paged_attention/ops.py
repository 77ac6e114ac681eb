"""Public paged-attention decode op over block-pool leaves: the
counterpart of ``repro/kernels/paged_attention/ops.py``, whose
``interpret`` switch is replaced by the tensors' device.

* On CPU tensors ``paged_gqa_decode`` runs the plain version (``ref``).
* On CUDA tensors it launches the hand-written kernel (``kernel``, K10)
  after checking device, dtype, shapes and contiguity, and raises if the
  kernel cannot build or launch.  It never falls back to the plain version.

The contract both share with the reference:

* for slot ``t`` only the pages ``page_rows[t, : pos[t] // page_size + 1]``
  are read — never another slot's pages, never the tail of the row;
* positions beyond ``pos[t]`` take no part in the softmax;
* the cell ``(page_rows[t, pos[t] // page_size], pos[t] % page_size)`` is
  written with the new token's K/V first, so position ``pos[t]`` attends to
  itself.  The pools are updated in place (the reference returned new
  arrays through aliased outputs); the op returns them all the same.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` the plain-version
calls taken for CPU tensors.  The MLA flavour (``paged_mla_decode``, K11)
belongs to the MoE+MLA serving slice and is not ported yet.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import kernel, ref
from .kernel import LAUNCHES, PLAIN_CALLS, reset_counts

__all__ = ["paged_gqa_decode", "pages_occupied", "check_operands",
           "check_device",
           "LAUNCHES", "PLAIN_CALLS", "reset_counts"]


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> Tuple[int, int]:
    return torch.cuda.get_device_capability(index)


def check_device(device: torch.device) -> None:
    """Raise unless ``device`` is a card K10 is built for (sm_90a)."""
    if device.type != "cuda":
        raise ValueError(f"K10 runs on a CUDA device, not {device}")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    cc = _capability(index)
    if cc != (9, 0):
        raise RuntimeError(f"K10 is built for sm_90a (Hopper); cuda:{index} "
                           f"has compute capability {cc[0]}.{cc[1]}")


def check_operands(q, k_new, v_new, k_pool, v_pool, page_rows, pos,
                   page_size: int) -> None:
    """Validate the operands of a K10 launch; raises ValueError, or
    RuntimeError for a card the kernel is not built for."""
    dev = q.device
    for x in (q, k_new, v_new, k_pool, v_pool, page_rows, pos):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"kernel operands must be CUDA tensors on one "
                             f"device, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    check_device(dev)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K10 takes float32 or bfloat16, got {q.dtype}")
    for x in (k_new, v_new, k_pool, v_pool):
        if x.dtype != q.dtype:
            raise ValueError(f"q, k_new, v_new and the pools must share one "
                             f"dtype, got {q.dtype} and {x.dtype}")
    if page_rows.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("page_rows and pos must be int32")
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
    n_rep = n_heads // n_kv
    if hd > kernel.MAX_HD or n_rep * hd > kernel.THREADS * kernel.MAX_ITEMS:
        raise ValueError(f"K10 takes hd <= {kernel.MAX_HD} and "
                         f"H/Hkv * hd <= {kernel.THREADS * kernel.MAX_ITEMS}"
                         f", got hd {hd}, H/Hkv {n_rep}")
    if kernel.smem_bytes(n_rep, hd, ps) > kernel.MAX_SMEM:
        raise ValueError(f"page_size {ps} x hd {hd} does not fit in shared "
                         f"memory")


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


def pages_occupied(pos: torch.Tensor, page_size: int) -> torch.Tensor:
    """Pages slot(s) at position ``pos`` occupy including the cell being
    written this step — the kernel's per-slot walk bound."""
    return pos // page_size + 1
