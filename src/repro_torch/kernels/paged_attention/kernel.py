"""ctypes binding of the hand-written paged GQA decode kernel (K10,
``csrc/paged_attention.cu``), which replaces
``repro/kernels/paged_attention/kernel.py::paged_gqa_call``.

The library is built from that source by ``repro_torch._build`` at the
first launch, never at import, so this module imports on a machine with
no ``nvcc`` and no card.  ``paged_gqa`` takes CUDA tensors whose checks
the caller (``ops.paged_gqa_decode``) has made, launches on PyTorch's
current stream, raises if the launch was refused, and adds one to
``LAUNCHES``.
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

# kernel launches, and plain-version calls taken because the tensors lay on
# the CPU; chip_smoke.py zeroes both before the main path and reads them
LAUNCHES: Dict[str, int] = {"paged_gqa": 0}
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_LOAD_LOCK = threading.Lock()
_LIB = None

_P, _I, _F = _binding.P, _binding.I, _binding.F
_ARGS = (_P,) * 8 + (_I,) * 7 + (_F, _P)
_SIGNATURES = {"pa_gqa_decode_f32": _ARGS, "pa_gqa_decode_bf16": _ARGS}
_ENTRY = {torch.float32: "pa_gqa_decode_f32",
          torch.bfloat16: "pa_gqa_decode_bf16"}


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
    fn = getattr(lib(), _ENTRY[q.dtype])
    _binding.check(fn(ptr(q), ptr(k_new), ptr(v_new), ptr(k_pool),
                      ptr(v_pool), ptr(page_rows), ptr(pos), ptr(o), bs,
                      n_kv, n_heads // n_kv, hd, ps, page_rows.shape[1],
                      n_pages, hd ** -0.5, _binding.stream()),
                   "paged_gqa")
    count(LAUNCHES, "paged_gqa")
