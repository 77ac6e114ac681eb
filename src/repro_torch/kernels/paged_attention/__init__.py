"""Paged-attention decode of the serving tier: the plain version
(``ref``), the binding of the hand-written CUDA kernel K10 (``kernel``)
and the device-dispatching op (``ops``).  The port of
``repro/kernels/paged_attention`` for the dense GQA flavour."""

from .ops import paged_gqa_decode, pages_occupied
from .ref import paged_gqa_decode_ref

__all__ = ["paged_gqa_decode", "pages_occupied", "paged_gqa_decode_ref"]
