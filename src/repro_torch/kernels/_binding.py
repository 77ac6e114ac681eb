"""What every ctypes binding of the port's CUDA kernels shares: loading a
library built by ``repro_torch._build``, launch and plain-call counters
that the threaded backend's workers may bump concurrently, the launch
error check, and the pointer and stream arguments."""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Dict, Mapping, Sequence

import torch

P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64
F = ctypes.c_float

_COUNT_LOCK = threading.Lock()


def count(table: Dict[str, int], name: str) -> None:
    with _COUNT_LOCK:          # threaded-backend workers count concurrently
        table[name] += 1


def reset(*tables: Dict[str, int]) -> None:
    with _COUNT_LOCK:
        for table in tables:
            for k in table:
                table[k] = 0


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} was not launched: "
                           f"cudaError {err}")


def load(source: pathlib.Path,
         signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """Build ``source`` (reused when already built) and load its library
    with each function of ``signatures`` returning a C int."""
    from repro_torch import _build
    handle = ctypes.CDLL(str(_build.build([source])[source.stem]))
    for name, args in signatures.items():
        fn = getattr(handle, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return handle


def ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
