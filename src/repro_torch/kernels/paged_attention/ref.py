"""Plain PyTorch version of the paged GQA decode (K10): the port of
``repro/kernels/paged_attention/ref.py::paged_gqa_decode_ref``.

It writes the new token's K/V into its cell of the pools in place, then
gathers the slot's own pages through ``page_rows`` (only the first
``max(pos) // page_size + 1`` of each row: positions beyond a slot's
``pos`` are masked anyway), zeroes every gathered position beyond ``pos``
so that stale or poisoned (NaN) contents cannot leak through ``0 * NaN``,
and takes a masked float32 softmax.  On the CPU it is what
``ops.paged_gqa_decode`` runs; on the card ``chip_smoke.py`` holds the
CUDA kernel against it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def write_cell(pool: torch.Tensor, page_rows: torch.Tensor,
               pos: torch.Tensor, new: torch.Tensor,
               page_size: int) -> None:
    """pool[page_rows[t, pos[t] // ps], pos[t] % ps] = new[t], in place."""
    pos = pos.long()
    pg = page_rows.long().gather(1, (pos // page_size)[:, None])[:, 0]
    pool[pg, pos % page_size] = new.to(pool.dtype)


def paged_gqa_decode_ref(q, k_new, v_new, k_pool, v_pool, page_rows, pos,
                         *, page_size: int) -> Tuple:
    """q (bs, H, hd); k_new, v_new (bs, Hkv, hd); pools (P, ps, Hkv, hd);
    page_rows (bs, max_pages); pos (bs,).  Returns ``(o (bs, H, hd) in
    q's dtype, k_pool, v_pool)``, the pools updated in place."""
    bs, n_heads, hd = q.shape
    write_cell(k_pool, page_rows, pos, k_new, page_size)
    write_cell(v_pool, page_rows, pos, v_new, page_size)
    n_walk = int(pos.max()) // page_size + 1
    window = n_walk * page_size
    rows = page_rows[:, :n_walk].long()
    valid = (torch.arange(window, device=q.device)[None, :]
             <= pos.long()[:, None])                       # (bs, W)
    mask = valid[:, :, None, None]

    def gather(pool):
        c = pool[rows].reshape((bs, window) + pool.shape[2:]).float()
        c = torch.where(mask, c, torch.zeros((), device=c.device))
        return torch.repeat_interleave(c, n_heads // c.shape[2], dim=2)

    kc, vc = gather(k_pool), gather(v_pool)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kc) * hd ** -0.5
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", w, vc)
    return o.to(q.dtype), k_pool, v_pool


def random_layout(bs: int, page_size: int, max_pages: int, spare: int,
                  seed: int, pos=None):
    """A seeded paged layout for holding K10 against this plain version
    (the card tests and ``chip_smoke.py``), as the reference's property
    test draws it: disjoint page lists per slot in a pool of
    ``bs * max_pages + spare`` pages, ragged positions (or ``pos``), and
    each row's tail pointing at a page no slot walks.  Returns numpy
    ``(page_rows (bs, max_pages) int32, pos (bs,) int32, walked page ids,
    n_pages)``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_pages = bs * max_pages + spare
    perm = rng.permutation(n_pages)
    if pos is None:
        pos = rng.integers(0, max_pages * page_size, size=bs)
    pos = np.asarray(pos, np.int32)
    page_rows = np.zeros((bs, max_pages), np.int32)
    walked, k = set(), 0
    for t in range(bs):
        n_walk = int(pos[t]) // page_size + 1
        page_rows[t, :n_walk] = perm[k:k + n_walk]
        walked.update(int(p) for p in perm[k:k + n_walk])
        k += n_walk
        page_rows[t, n_walk:] = perm[-1]
    return page_rows, pos, walked, n_pages


def random_operands(page_rows, pos, walked, n_pages, *, n_heads: int,
                    n_kv: int, hd: int, page_size: int, seed: int,
                    stale_tail: bool = False):
    """Seeded numpy operands for ``random_layout``'s layout: q, k_new,
    v_new (N(0, 0.25)) and pools whose pages no slot walks are NaN.  With
    ``stale_tail`` the positions after each slot's ``pos`` in its last
    page are +inf (K) and NaN (V), as a reused page's stale tail may be."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bs = pos.shape[0]

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    q = mk(bs, n_heads, hd)
    k_new, v_new = mk(bs, n_kv, hd), mk(bs, n_kv, hd)
    pools = []
    for fill in (np.inf, np.nan):
        pool = mk(n_pages, page_size, n_kv, hd)
        unwalked = np.ones(n_pages, bool)
        unwalked[list(walked)] = False
        pool[unwalked] = np.nan
        if stale_tail:
            for t in range(bs):
                last = page_rows[t, int(pos[t]) // page_size]
                pool[last, int(pos[t]) % page_size + 1:] = fill
        pools.append(pool)
    return q, k_new, v_new, pools[0], pools[1]
