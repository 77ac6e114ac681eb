"""ctypes binding of the hand-written paged decode kernels in
``csrc/paged_attention.cu``: K10 (GQA), which replaces
``repro/kernels/paged_attention/kernel.py::paged_gqa_call``, and K11
(weight-absorbed MLA), which replaces ``::paged_mla_call`` (bf16 on the
tensor cores, float32 on the CUDA cores).

The library is built from that source by ``repro_torch._build`` at the
first launch, never at import, so this module imports on a machine with
no ``nvcc`` and no card.  ``paged_gqa`` and ``paged_mla`` take CUDA
tensors whose checks the caller (``ops.paged_gqa_decode``,
``ops.paged_mla_decode``) has made, launch on PyTorch's current stream,
raise if the launch was refused, and add one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict

import torch

from repro_torch.kernels import _binding
from repro_torch.kernels._binding import count

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "paged_attention.cu"   # includes csrc/paged_attention.cuh

GROUP = 4          # PA_GROUP in csrc/paged_attention.cuh: heads a block
SPLIT_POS = 32     # PA_SPLIT_POS: positions a split walks (whole pages)
MAX_HD = 256       # PA_MAX_HD
MAX_SMEM = 227 * 1024
MLA_CHUNK = 32     # MLA_CHUNK: positions K11 (fp32) stages at once
MLA_MAX_LAT = 512  # MLA_MAX_LAT
MLA_MAX_ROPE = 64  # MLA_MAX_ROPE
MLA_HT = 64        # MLA_HT: heads a K11 bf16 block (4 m16 tiles)
MLA_CB = 256       # MLA_CB: latent columns a K11 bf16 block
MLA_CH = 16        # MLA_CH: positions a K11 bf16 chunk
MLA_STAGES = 4     # MLA_STAGES: chunks in the K11 bf16 cp.async ring
MLA_BLOCKS = 128   # MLA_BLOCKS: blocks the K11 bf16 split aims at
MLA_MAX_SPLIT = 32  # MLA_MAX_SPLIT: K11 bf16 splits at most
MLA_SPLIT_CHUNKS = 4   # K11 bf16: chunks of MLA_CH a split walks at least

# kernel launches, and plain-version calls taken because the tensors lay on
# the CPU; chip_smoke.py zeroes both before the main path and reads them
LAUNCHES: Dict[str, int] = {"paged_gqa": 0, "paged_mla": 0}
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_LOAD_LOCK = threading.Lock()
_LIB = None

_P, _I, _F = _binding.P, _binding.I, _binding.F
_ARGS = (_P,) * 11 + (_I,) * 8 + (_F, _P)
_MLA_ARGS = (_P,) * 9 + (_I,) * 7 + (_F, _P)
_MLA_MMA_ARGS = (_P,) * 12 + (_I,) * 9 + (_F, _P)
_SIGNATURES = {"pa_gqa_decode_f32": _ARGS, "pa_gqa_decode_bf16": _ARGS,
               "pa_mla_decode_f32": _MLA_ARGS,
               "pa_mla_decode_bf16": _MLA_MMA_ARGS}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_counts() -> None:
    _binding.reset(LAUNCHES, PLAIN_CALLS)


def lib() -> ctypes.CDLL:
    """The built kernel library (built and loaded at the first call)."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
            if _LIB is None:
                _LIB = _binding.load(SOURCE, _SIGNATURES)
    return _LIB


def pages_per_split(page_size: int) -> int:
    """Listed pages one K10 split walks: max(1, SPLIT_POS // page_size)."""
    return max(1, SPLIT_POS // page_size)


def smem_bytes(hd: int, page_size: int) -> int:
    """Dynamic shared memory of one K10 block (the launcher's formula):
    the split's K and V rows as float (padded), the group's queries, its
    scores and its softmax state.  It does not grow with n_rep."""
    npos = pages_per_split(page_size) * page_size
    return 4 * (2 * npos * (hd + 1) + GROUP * hd + GROUP * npos + 2 * GROUP)


def check_shape(dtype: torch.dtype, n_heads: int, n_kv: int, hd: int,
                page_size: int) -> None:
    """Raise ValueError unless K10 takes these widths: float32 or bfloat16,
    Hkv dividing H (any n_rep), 1 <= hd <= ``MAX_HD`` and a page whose
    split fits in shared memory.  Needs no card."""
    if dtype not in _SUFFIX:
        raise ValueError(f"K10 takes float32 or bfloat16, got {dtype}")
    if n_kv < 1 or n_heads < n_kv or n_heads % n_kv:
        raise ValueError(f"K10 needs Hkv dividing H, got H {n_heads}, Hkv "
                         f"{n_kv}")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"K10 takes 1 <= hd <= {MAX_HD}, got hd {hd}")
    if page_size < 1 or smem_bytes(hd, page_size) > MAX_SMEM:
        raise ValueError(f"page_size {page_size} x hd {hd} does not fit in "
                         f"shared memory")


_TICKETS: Dict[torch.device, torch.Tensor] = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The device's merge tickets, at least ``n``: zero when made, and each
    launch leaves them zero.  Launches that share them are ordered on one
    stream, as the serving path's are."""
    with _LOAD_LOCK:
        buf = _TICKETS.get(device)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
            _TICKETS[device] = buf
        return buf


def paged_gqa(q, k_new, v_new, k_pool, v_pool, page_rows, pos, o) -> None:
    """o (bs, H, hd) <- the walk; the new cells land in the pools in
    place.  All operands checked by the caller.  The partials of the
    split walk go to scratch allocated here; the grid is sized from
    ``page_rows.shape[1]``, so nothing is read back from the card."""
    bs, n_heads, hd = q.shape
    n_pages, ps, n_kv, _ = k_pool.shape
    n_rep = n_heads // n_kv
    n_split = -(-page_rows.shape[1] // pages_per_split(ps))
    part_ml = torch.empty((bs, n_kv, n_rep, n_split, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((bs, n_kv, n_rep, n_split, hd),
                           dtype=torch.float32, device=q.device)
    tickets = _tickets(q.device, bs * n_kv * -(-n_rep // GROUP))
    operands = (q, k_new, v_new, k_pool, v_pool, o)
    vec = (hd * q.element_size() % 16 == 0
           and all(x.data_ptr() % 16 == 0 for x in operands))
    ptr = _binding.ptr
    fn = getattr(lib(), f"pa_gqa_decode_{_SUFFIX[q.dtype]}")
    _binding.check(fn(ptr(q), ptr(k_new), ptr(v_new), ptr(k_pool),
                      ptr(v_pool), ptr(page_rows), ptr(pos), ptr(o),
                      ptr(part_ml), ptr(part_acc), ptr(tickets), bs, n_kv,
                      n_rep, hd, ps, page_rows.shape[1], n_pages, int(vec),
                      hd ** -0.5, _binding.stream()),
                   "paged_gqa")
    count(LAUNCHES, "paged_gqa")


def mla_smem_bytes(lat: int, rope: int,
                   dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one K11 block (the launchers' formulas).
    bf16: the block's MLA_HT queries and a ring of MLA_STAGES
    MLA_CH-position chunks, rows of the padded width (lat + rope rounded up
    to 16, plus 8), and the score exchange of its 8 warps; float32:
    MLA_CHUNK rows as float."""
    if dtype == torch.bfloat16:
        ld = -(-(lat + rope) // 16) * 16 + 8
        return 2 * (MLA_HT + MLA_STAGES * MLA_CH) * ld + 4 * 8 * 32 * 8
    return 4 * MLA_CHUNK * (lat + rope)


def mla_pages_per_split(bs: int, n_heads: int, lat: int, max_pages: int,
                        page_size: int) -> int:
    """Listed pages one K11 bf16 split walks: the slots' (head tile,
    column block) units times the splits come to about ``MLA_BLOCKS``
    blocks, at most ``MLA_MAX_SPLIT`` splits, each of at least
    ``MLA_SPLIT_CHUNKS`` chunks of the longest walk the rows hold (a split
    costs its queries' staging and a merge), from the page rows' width
    alone (no read of pos)."""
    units = bs * -(-n_heads // MLA_HT) * -(-lat // MLA_CB)
    chunks = -(-max_pages * page_size // MLA_CH)
    want = max(1, min(max_pages, MLA_MAX_SPLIT, MLA_BLOCKS // max(units, 1),
                      -(-chunks // MLA_SPLIT_CHUNKS)))
    return -(-max_pages // want)


def paged_mla(q_eff, q_rope, c_new, r_new, c_pool, r_pool, page_rows, pos,
              ctx, scale: float) -> None:
    """ctx (bs, H, lat) <- the walk; the new latent and RoPE cells land in
    the pools in place.  All operands checked by the caller.  In bf16 the
    partials of the split walk go to scratch allocated here; the grid is
    sized from ``page_rows.shape[1]``, so nothing is read back from the
    card."""
    bs, n_heads, lat = q_eff.shape
    n_pages, ps, _ = c_pool.shape
    rope, max_pages = q_rope.shape[2], page_rows.shape[1]
    ptr = _binding.ptr
    fn = getattr(lib(), f"pa_mla_decode_{_SUFFIX[q_eff.dtype]}")
    if q_eff.dtype == torch.bfloat16:
        pps = mla_pages_per_split(bs, n_heads, lat, max_pages, ps)
        n_split = -(-max_pages // pps)
        n_cb = -(-lat // MLA_CB)
        part_ml = torch.empty((bs, n_cb, n_heads, n_split, 2),
                              dtype=torch.float32, device=q_eff.device)
        part_o = torch.empty((bs, n_heads, n_split, lat),
                             dtype=torch.float32, device=q_eff.device)
        tickets = _tickets(q_eff.device,
                           bs * -(-n_heads // MLA_HT) * n_cb)
        operands = (q_eff, q_rope, c_new, r_new, c_pool, r_pool)
        vec = (lat % 8 == 0 and rope % 8 == 0
               and all(x.data_ptr() % 16 == 0 for x in operands))
        err = fn(ptr(q_eff), ptr(q_rope), ptr(c_new), ptr(r_new),
                 ptr(c_pool), ptr(r_pool), ptr(page_rows), ptr(pos),
                 ptr(ctx), ptr(part_ml), ptr(part_o), ptr(tickets), bs,
                 n_heads, lat, rope, ps, max_pages, n_pages, pps, int(vec),
                 scale, _binding.stream())
    else:
        err = fn(ptr(q_eff), ptr(q_rope), ptr(c_new), ptr(r_new),
                 ptr(c_pool), ptr(r_pool), ptr(page_rows), ptr(pos),
                 ptr(ctx), bs, n_heads, lat, rope, ps, max_pages, n_pages,
                 scale, _binding.stream())
    _binding.check(err, "paged_mla")
    count(LAUNCHES, "paged_mla")
