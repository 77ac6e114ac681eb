"""ctypes binding of the hand-written flash-attention kernel (K12,
``csrc/flash_attention.cu``): one block per (batch-head, query tile), K/V
streamed through shared memory a key tile at a time, the online softmax in
float; bf16 products on the tensor cores (``mma.sync``) up to hd 256,
float32 and any head wider than 256 on the CUDA cores (the source's header
says how).  It replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention``
(``_fa_kernel``).

The library is built from that source by ``repro_torch._build`` at the
first launch, never at import, so this module imports on a machine with
no ``nvcc`` and no card.  ``flash_attention`` runs the plain version
(``ref.attention_ref``) for CPU tensors, counted in ``PLAIN_CALLS``; for
CUDA tensors it launches the kernel on PyTorch's current stream, or
raises, and adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict

import torch

from repro_torch.kernels import _binding
from repro_torch.kernels._binding import count

from . import ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"

BLOCK_Q = 128
BLOCK_K = 128
_SYMBOLS = {torch.float32: "fa_forward_f32", torch.bfloat16: "fa_forward_bf16"}

# kernel launches, and plain-version calls taken because the tensors lay
# on the CPU; chip_smoke.py zeroes both and reads them after its runs
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
PLAIN_CALLS: Dict[str, int] = {"flash_attention": 0}

_LOAD_LOCK = threading.Lock()
_LIB = None

_P, _I, _F = _binding.P, _binding.I, _binding.F
_SIG = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P)
_SIGNATURES = {name: _SIG for name in _SYMBOLS.values()}


def reset_counts() -> None:
    _binding.reset(LAUNCHES, PLAIN_CALLS)


_check, _ptr, _stream = _binding.check, _binding.ptr, _binding.stream


def lib() -> ctypes.CDLL:
    """The built kernel library (built and loaded at the first call)."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
            if _LIB is None:
                _LIB = _binding.load(SOURCE, _SIGNATURES)
    return _LIB


def _check_blocks(sq: int, sk: int, block_q: int, block_k: int) -> None:
    if block_q < 1 or block_k < 1 or sq % block_q or sk % block_k:
        raise ValueError(f"Sq {sq} / Sk {sk} not multiples of block_q "
                         f"{block_q} / block_k {block_k} (ops.py pads)")


def check_shape(dtype: torch.dtype, sq: int, sk: int, hd: int,
                block_q: int = BLOCK_Q, block_k: int = BLOCK_K) -> None:
    """Raise ValueError unless the card kernel takes these operands: float32
    or bfloat16, a head of at least one column (any width: above 256 the
    kernel sums over chunks of the head), and blocks that divide Sq and Sk
    (the reference's assertion).  Needs no card."""
    _check_blocks(sq, sk, block_q, block_k)
    if dtype not in _SYMBOLS:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {dtype}")
    if hd < 1:
        raise ValueError(f"the kernel takes hd >= 1, got {hd}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = BLOCK_Q,
                    block_k: int = BLOCK_K) -> torch.Tensor:
    """q: (BH, Sq, hd); k, v: (BH, Sk, hd), one dtype, Sq % block_q == 0
    and Sk % block_k == 0 (``ops`` pads) → (BH, Sq, hd) in q's dtype.

    As in the reference, the blocks must divide Sq and Sk; they set the
    reference's tiling and nothing else here: the card kernel picks its
    own tiles (and masks their ragged edges), the plain version has none.
    The causal mask is aligned at the top left (row r sees keys 0..r)."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if (k.shape != (bh, sk, hd) or v.shape != k.shape
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} "
                         f"{k.dtype}, v {tuple(v.shape)} {v.dtype}: want "
                         f"(BH, Sq, hd) and two (BH, Sk, hd) of one dtype")
    if q.device.type == "cpu":
        _check_blocks(sq, sk, block_q, block_k)
        count(PLAIN_CALLS, "flash_attention")
        return ref.attention_ref(q, k, v, causal=causal)
    check_shape(q.dtype, sq, sk, hd, block_q, block_k)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    vec = hd % 8 == 0 and all(x.data_ptr() % 16 == 0 for x in (q, k, v, o))
    if o.numel():
        _check(getattr(lib(), _SYMBOLS[q.dtype])(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), bh, sq, sk, hd, int(causal),
            int(vec), hd ** -0.5, _stream()), "flash_attention")
        count(LAUNCHES, "flash_attention")
    return o
