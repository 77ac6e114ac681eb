"""Plain PyTorch versions of the paged decodes, GQA (K10) and MLA (K11): the
ports of ``repro/kernels/paged_attention/ref.py::paged_gqa_decode_ref`` and
``::paged_mla_decode_ref``.

Each writes the new token's cache cell into the pools in place, then
gathers the slot's own pages through ``page_rows`` (only the first
``max(pos) // page_size + 1`` of each row: positions beyond a slot's
``pos`` are masked anyway), zeroes every gathered position beyond ``pos``
so that stale or poisoned (NaN) contents cannot leak through ``0 * NaN``,
and takes a masked float32 softmax.  On the CPU they are what
``ops.paged_gqa_decode`` and ``ops.paged_mla_decode`` run; on the card
``chip_smoke.py`` holds the CUDA kernels against them.
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


def _gather_valid(pool: torch.Tensor, rows: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """The pages ``rows`` (bs, n) of ``pool`` as a float window (bs, n*ps,
    ...) with every position beyond a slot's ``pos`` zeroed, so that
    stale or poisoned contents cannot leak through ``0 * NaN``."""
    bs, n = rows.shape
    c = pool[rows].reshape((bs, n * pool.shape[1]) + pool.shape[2:]).float()
    mask = valid.reshape(valid.shape + (1,) * (c.dim() - 2))
    return torch.where(mask, c, torch.zeros((), device=c.device))


def paged_gqa_decode_ref(q, k_new, v_new, k_pool, v_pool, page_rows, pos,
                         *, page_size: int) -> Tuple:
    """q (bs, H, hd); k_new, v_new (bs, Hkv, hd); pools (P, ps, Hkv, hd);
    page_rows (bs, max_pages); pos (bs,).  Returns ``(o (bs, H, hd) in
    q's dtype, k_pool, v_pool)``, the pools updated in place."""
    n_heads, hd = q.shape[1:]
    write_cell(k_pool, page_rows, pos, k_new, page_size)
    write_cell(v_pool, page_rows, pos, v_new, page_size)
    n_walk = int(pos.max()) // page_size + 1
    rows = page_rows[:, :n_walk].long()
    valid = (torch.arange(n_walk * page_size, device=q.device)[None, :]
             <= pos.long()[:, None])                       # (bs, W)
    kc, vc = (torch.repeat_interleave(_gather_valid(pool, rows, valid),
                                      n_heads // pool.shape[2], dim=2)
              for pool in (k_pool, v_pool))
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kc) * hd ** -0.5
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", w, vc)
    return o.to(q.dtype), k_pool, v_pool


def paged_mla_decode_ref(q_eff, q_rope, c_new, r_new, c_pool, r_pool,
                         page_rows, pos, *, page_size: int,
                         scale: float) -> Tuple:
    """q_eff (bs, H, lat); q_rope (bs, H, rope); c_new (bs, lat); r_new
    (bs, rope); pools (P, ps, lat) and (P, ps, rope); page_rows (bs,
    max_pages); pos (bs,).  Scores ``(q_eff . c + q_rope . r) * scale``
    over positions ``0 .. pos``; returns ``(ctx (bs, H, lat) in q_eff's
    dtype, c_pool, r_pool)``, the pools updated in place."""
    write_cell(c_pool, page_rows, pos, c_new, page_size)
    write_cell(r_pool, page_rows, pos, r_new, page_size)
    n_walk = int(pos.max()) // page_size + 1
    rows = page_rows[:, :n_walk].long()
    valid = (torch.arange(n_walk * page_size, device=q_eff.device)[None, :]
             <= pos.long()[:, None])                       # (bs, W)
    cc = _gather_valid(c_pool, rows, valid)                # (bs, W, lat)
    rc = _gather_valid(r_pool, rows, valid)                # (bs, W, rope)
    s = (torch.einsum("bhl,bkl->bhk", q_eff.float(), cc)
         + torch.einsum("bhr,bkr->bhk", q_rope.float(), rc)) * scale
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhk,bkl->bhl", w, cc)
    return ctx.to(q_eff.dtype), c_pool, r_pool


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


def _random_arrays(page_rows, pos, walked, n_pages, page_size, seed,
                   stale_tail, new_shapes, cells):
    """N(0, 0.25) arrays of ``new_shapes`` (each with a leading slot axis),
    then one pool per ``(cell shape, fill)`` of ``cells`` whose pages no
    slot walks are NaN and, with ``stale_tail``, whose positions after each
    slot's ``pos`` in its last page hold ``fill``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bs = pos.shape[0]

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    out = [mk(bs, *shape) for shape in new_shapes]
    unwalked = np.ones(n_pages, bool)
    unwalked[list(walked)] = False
    for cell, fill in cells:
        pool = mk(n_pages, page_size, *cell)
        pool[unwalked] = np.nan
        if stale_tail:
            for t in range(bs):
                last = page_rows[t, int(pos[t]) // page_size]
                pool[last, int(pos[t]) % page_size + 1:] = fill
        out.append(pool)
    return tuple(out)


def random_operands(page_rows, pos, walked, n_pages, *, n_heads: int,
                    n_kv: int, hd: int, page_size: int, seed: int,
                    stale_tail: bool = False):
    """Seeded numpy operands for ``random_layout``'s layout: q, k_new,
    v_new (N(0, 0.25)) and pools whose pages no slot walks are NaN.  With
    ``stale_tail`` the positions after each slot's ``pos`` in its last
    page are +inf (K) and NaN (V), as a reused page's stale tail may be."""
    return _random_arrays(page_rows, pos, walked, n_pages, page_size, seed,
                          stale_tail,
                          ((n_heads, hd), (n_kv, hd), (n_kv, hd)),
                          (((n_kv, hd), float("inf")),
                           ((n_kv, hd), float("nan"))))


def random_mla_operands(page_rows, pos, walked, n_pages, *, n_heads: int,
                        lat: int, rope: int, page_size: int, seed: int,
                        stale_tail: bool = False):
    """``random_operands`` for the MLA flavour: q_eff, q_rope, c_new, r_new
    (N(0, 0.25)) and the latent and RoPE pools, NaN on every page no slot
    walks.  With ``stale_tail`` the positions after each slot's ``pos`` in
    its last page are NaN (latent) and +inf (RoPE key)."""
    return _random_arrays(page_rows, pos, walked, n_pages, page_size, seed,
                          stale_tail,
                          ((n_heads, lat), (n_heads, rope), (lat,), (rope,)),
                          (((lat,), float("nan")), ((rope,), float("inf"))))


def random_case(bs: int, page_size: int, dtype: torch.dtype, seed: int,
                device, *, mla: bool = False, max_pages: int = 5, pos=None,
                stale_tail: bool = False, **widths):
    """One seeded case for holding K10 (or, with ``mla``, K11) against its
    plain version: ``random_layout`` with 3 spare pages and its operands
    (``random_operands`` or ``random_mla_operands``, ``widths`` their head
    counts and widths, drawn from ``seed + 1``) as ``dtype`` tensors on
    ``device``.  Returns ``(the op's positional operands, page_rows, pos)``,
    the last two as numpy for the checks that walk them."""
    rows, pos, walked, n_pages = random_layout(bs, page_size, max_pages, 3,
                                               seed, pos)
    make = random_mla_operands if mla else random_operands
    arrs = make(rows, pos, walked, n_pages, page_size=page_size,
                seed=seed + 1, stale_tail=stale_tail, **widths)
    ts = [torch.tensor(a, device=device).to(dtype) for a in arrs]
    return ts + [torch.tensor(rows, device=device),
                 torch.tensor(pos, device=device)], rows, pos
