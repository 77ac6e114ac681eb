"""Paged-attention decode of the serving tier: the plain versions
(``ref``), the binding of the hand-written CUDA kernels K10 (GQA) and K11
(MLA) (``kernel``) and the device-dispatching ops (``ops``).  The port of
``repro/kernels/paged_attention``."""

from .ops import paged_gqa_decode, paged_mla_decode, pages_occupied
from .ref import paged_gqa_decode_ref, paged_mla_decode_ref

__all__ = ["paged_gqa_decode", "paged_mla_decode", "pages_occupied",
           "paged_gqa_decode_ref", "paged_mla_decode_ref"]
