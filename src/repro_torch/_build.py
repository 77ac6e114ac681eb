"""Build the port's CUDA sources at first use.

Each ``.cu`` under a package's ``csrc/`` compiles with ``nvcc`` into a
shared library with a plain C interface (loaded with ``ctypes`` by the
kernel's binding module) for ``sm_90a``.  Libraries land in
``build/repro_torch/<hash>/`` at the root of the checkout (override with
``REPRO_TORCH_BUILD_DIR``), each keyed by a hash of its source, the
headers beside it and the flags, so an edited source rebuilds and an
unchanged one is reused, whichever set of sources a call asks for.  All
requested sources compile in parallel, one ``nvcc`` each.  Nothing is
downloaded and no prebuilt kernel is used: a checkout builds everything
it runs from its own sources.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_ROOT = pathlib.Path(__file__).resolve().parents[2]


def build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                                       _ROOT / "build" / "repro_torch"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = pathlib.Path(home) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use")
    return path


def _digest(src: pathlib.Path) -> str:
    """Hash of the flags, ``src`` and every header beside it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src] + sorted(src.parent.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(sources: Sequence[pathlib.Path]) -> Dict[str, pathlib.Path]:
    """Compile each of ``sources`` into ``<stem>.so`` (reused when already
    built from the same bytes) and return ``{stem: path}``.  Raises with
    nvcc's output when a compile fails."""
    libs = {src.stem: build_dir() / _digest(src) / f"{src.stem}.so"
            for src in sources}
    procs = {}
    for src in sources:
        lib = libs[src.stem]
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(src.parent), "-o", str(tmp),
               str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, lib)
    failed = []
    for stem, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)           # atomic: a reader never sees half
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return libs
