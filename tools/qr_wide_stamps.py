#!/usr/bin/env python3
"""Where the time of the b > 64 QR tile bodies goes, on one card.

    python3 tools/qr_wide_stamps.py

Prints the ptxas report (registers, spills) of every kernel of
``csrc/qr_tile.cu``, then builds the same sources with ``-DQR_STAMPS``
(into ``build/repro_torch/variants/``): thread 0 of block 0 stamps
``clock64()`` after a block barrier at each stage of a panel (loaded,
factored, written back, T built, trailing columns updated, the columns
left of the panel folded into T, merged) and of the applies (``QR_STAMP``
in ``csrc/qr_tile.cuh``).  It runs K1-K4 once at b = 128 and 256 (batch
1) through that build and prints each stage's microseconds summed over
the panels, at the card's SM clock (``nvidia-smi
--query-gpu=clocks.max.sm``).  The stamps add a barrier and a few hundred
clocks each; the shipped build has none.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/qr_tile/csrc"
STAGES = ["panel start", "loaded", "factored", "written back", "T built",
          "trailing done", "left chunks done", "merged", "apply loaded",
          "kernel start", "copied"]


def stamped_lib(kernel):
    """The kernels built with -DQR_STAMPS, loaded as kernel's library."""
    from repro_torch import _build
    out = _build.build_dir() / "variants" / "qr_stamps.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DQR_STAMPS", "-I",
                    str(CSRC), "-o", str(out), str(CSRC / "qr_tile.cu")],
                   check=True)
    handle = ctypes.CDLL(str(out))
    for name, args in kernel._SIGNATURES.items():
        getattr(handle, name).argtypes = list(args)
        getattr(handle, name).restype = ctypes.c_int
    kernel._check(handle.qr_init(), "qr_init")
    return handle


def ptxas_report() -> None:
    from repro_torch import _build
    proc = subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xptxas", "-v", "-c",
         str(CSRC / "qr_tile.cu"), "-I", str(CSRC), "-o", os.devnull],
        capture_output=True, text=True)
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line:
            name = line.split("'")[1]
            used = next((x for x in lines[i + 1:i + 4] if "Used" in x), "")
            spill = next((x for x in lines[i + 1:i + 4] if "spill" in x), "")
            print(f"[ptxas] {name}: {used.split(':')[-1].strip()}; "
                  f"{spill.strip()}", flush=True)


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels.qr_tile import kernel, ops
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    ptxas_report()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    kernel._LIB = stamped_lib(kernel)
    read = kernel._LIB.qr_stamps
    read.argtypes = [ctypes.c_void_p] * 3
    st, tags = (ctypes.c_longlong * 4096)(), (ctypes.c_int * 4096)()
    n = ctypes.c_int(0)
    dev = torch.device("cuda")
    for b in (128, 256):
        rng = np.random.default_rng(3)
        x, c1, c2 = (torch.tensor(rng.standard_normal((1, b, b)),
                                  dtype=torch.float32, device=dev)
                     for _ in range(3))
        r0 = torch.triu(x)
        rv, _, t = ops.geqrf(x)
        _, v2, _, t2 = ops.tsqrf(r0, c1)
        for name, call in (("geqrf", lambda: ops.geqrf(x)),
                           ("tsqrf", lambda: ops.tsqrf(r0, c1)),
                           ("apply_qt", lambda: ops.apply_qt(rv, t, c2)),
                           ("apply_tsqt",
                            lambda: ops.apply_tsqt(v2, t2, c1, c2))):
            for _ in range(2):           # the second run is the one kept
                read(st, tags, ctypes.byref(n))
                call()
                torch.cuda.synchronize()
            read(st, tags, ctypes.byref(n))
            spans = {}
            for i in range(1, n.value):
                key = f"{STAGES[tags[i - 1]]} -> {STAGES[tags[i]]}"
                spans[key] = spans.get(key, 0) + st[i] - st[i - 1]
            us = 1.0 / mhz
            total = (st[n.value - 1] - st[0]) * us
            print(f"[stamps] {name} b={b}: {total:.1f} us in "
                  f"{n.value} stamps; " + "; ".join(
                      f"{k} {v * us:.1f}" for k, v in
                      sorted(spans.items(), key=lambda kv: -kv[1])),
                  flush=True)


if __name__ == "__main__":
    main()
