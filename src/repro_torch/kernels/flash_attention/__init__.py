"""Flash attention (K12) as an op: the plain version (``ref``), the CUDA
kernel's binding (``kernel``) and the model-layout wrapper (``ops``).  As
in the reference, no model path calls it: the models use
``models.layers.sdpa_chunked``."""

from . import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
