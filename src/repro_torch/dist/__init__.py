"""Distributed substrate of the port: sharding specs and their DTensor
placements, activation-sharding constraints, compressed data-parallel
all-reduce, and ring collective matmuls.  The port of ``repro.dist``.

Layout:
  act_sharding — logical ("dp"/"tp") activation constraints, no-op outside
                 an ``activation_sharding`` context (and on a tensor that
                 is not a DTensor) so model code stays mesh-agnostic;
  sharding     — partition specs for parameter / optimizer / batch /
                 KV-cache trees over the launch/mesh.py meshes, and their
                 DTensor placements;
  compression  — int8 gradient all-reduce with error feedback (EF-SGD);
  collective   — allgather/reduce-scatter matmuls as point-to-point rings
                 that overlap per-shard matmuls with neighbour exchange.
"""

from .act_sharding import activation_sharding, constrain
from .collective import allgather_matmul, reducescatter_matmul
from .compression import (compressed_psum, dequantize_int8,
                          init_error_feedback, quantize_int8)
from .sharding import (batch_pspecs, cache_pspecs, opt_pspecs, param_pspecs,
                       shardings_for)

__all__ = [
    "activation_sharding", "constrain",
    "param_pspecs", "opt_pspecs", "batch_pspecs", "cache_pspecs",
    "shardings_for",
    "quantize_int8", "dequantize_int8", "init_error_feedback",
    "compressed_psum",
    "allgather_matmul", "reducescatter_matmul",
]
