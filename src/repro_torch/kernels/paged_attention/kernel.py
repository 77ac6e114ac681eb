"""ctypes binding of the hand-written paged decode kernels in
``csrc/paged_attention.cu``: K10 (GQA), which replaces
``repro/kernels/paged_attention/kernel.py::paged_gqa_call``, and K11
(weight-absorbed MLA), which replaces ``::paged_mla_call``.

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

THREADS = 128      # PA_THREADS in csrc/paged_attention.cuh
MAX_ITEMS = 8      # PA_ITEMS: n_rep * hd <= THREADS * MAX_ITEMS
MAX_HD = 256       # PA_MAX_HD
MAX_SMEM = 227 * 1024
MLA_CHUNK = 32     # MLA_CHUNK: positions K11 stages at once
MLA_MAX_LAT = 512  # MLA_MAX_LAT: 16 accumulators a lane
MLA_MAX_ROPE = 64  # MLA_MAX_ROPE

# kernel launches, and plain-version calls taken because the tensors lay on
# the CPU; chip_smoke.py zeroes both before the main path and reads them
LAUNCHES: Dict[str, int] = {"paged_gqa": 0, "paged_mla": 0}
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_LOAD_LOCK = threading.Lock()
_LIB = None

_P, _I, _F = _binding.P, _binding.I, _binding.F
_ARGS = (_P,) * 8 + (_I,) * 7 + (_F, _P)
_MLA_ARGS = (_P,) * 9 + (_I,) * 7 + (_F, _P)
_SIGNATURES = {"pa_gqa_decode_f32": _ARGS, "pa_gqa_decode_bf16": _ARGS,
               "pa_mla_decode_f32": _MLA_ARGS,
               "pa_mla_decode_bf16": _MLA_ARGS}
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


def smem_bytes(n_rep: int, hd: int, page_size: int) -> int:
    """Dynamic shared memory of one block (the launcher's formula)."""
    return 4 * (2 * page_size * hd + n_rep * hd + n_rep * page_size
                + 3 * n_rep)


def paged_gqa(q, k_new, v_new, k_pool, v_pool, page_rows, pos, o) -> None:
    """o (bs, H, hd) <- the walk; the new cells land in the pools in
    place.  All operands checked by the caller."""
    bs, n_heads, hd = q.shape
    n_pages, ps, n_kv, _ = k_pool.shape
    ptr = _binding.ptr
    fn = getattr(lib(), f"pa_gqa_decode_{_SUFFIX[q.dtype]}")
    _binding.check(fn(ptr(q), ptr(k_new), ptr(v_new), ptr(k_pool),
                      ptr(v_pool), ptr(page_rows), ptr(pos), ptr(o), bs,
                      n_kv, n_heads // n_kv, hd, ps, page_rows.shape[1],
                      n_pages, hd ** -0.5, _binding.stream()),
                   "paged_gqa")
    count(LAUNCHES, "paged_gqa")


def mla_smem_bytes(lat: int, rope: int) -> int:
    """Dynamic shared memory of one K11 block (the launcher's formula)."""
    return 4 * MLA_CHUNK * (lat + rope)


def paged_mla(q_eff, q_rope, c_new, r_new, c_pool, r_pool, page_rows, pos,
              ctx, scale: float) -> None:
    """ctx (bs, H, lat) <- the walk; the new latent and RoPE cells land in
    the pools in place.  All operands checked by the caller."""
    bs, n_heads, lat = q_eff.shape
    n_pages, ps, _ = c_pool.shape
    ptr = _binding.ptr
    fn = getattr(lib(), f"pa_mla_decode_{_SUFFIX[q_eff.dtype]}")
    _binding.check(fn(ptr(q_eff), ptr(q_rope), ptr(c_new), ptr(r_new),
                      ptr(c_pool), ptr(r_pool), ptr(page_rows), ptr(pos),
                      ptr(ctx), bs, n_heads, lat, q_rope.shape[2], ps,
                      page_rows.shape[1], n_pages, scale,
                      _binding.stream()),
                   "paged_mla")
    count(LAUNCHES, "paged_mla")
