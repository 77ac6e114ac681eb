"""The port stands alone: ``repro_torch`` imports neither jax nor anything
of ``repro``, its entry points default to the card and refuse to run
quietly on the CPU, and its backend registry is its own."""

import importlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.apps import qr  # noqa: E402
from repro_torch.kernels.qr_tile import kernel  # noqa: E402

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k == 'jax' or k.startswith('jax.') or k == 'repro'
             or k.startswith('repro.'))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_package_imports_no_jax_and_nothing_of_repro():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_every_module_imports_here():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for n in names:
        importlib.import_module(n)
    assert "repro_torch.kernels.qr_tile.kernel" in names


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_run_qr_defaults_to_cuda_and_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    kernel.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        qr.run_qr(np.eye(32, dtype=np.float32), tile=16)
    assert all(v == 0 for v in kernel.PLAIN_CALLS.values())
    with pytest.raises(RuntimeError, match="CUDA"):
        qr._TileState.from_numpy({(0, 0): np.eye(4)})


def test_resolve_device():
    assert repro_torch.resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        repro_torch.resolve_device("meta")


def test_backend_registry_is_the_ports_own():
    from repro.core import backends as jbackends
    from repro_torch.core import backends
    assert set(backends.available_backends()) >= {
        "sequential", "threaded", "rounds", "engine"}
    assert backends.get_backend("engine") is not jbackends.get_backend(
        "engine")
    assert backends.get_backend("engine").device_resident

    class Probe(backends.Backend):
        name = "probe-only-in-port"

    backends.register_backend(Probe())
    try:
        assert "probe-only-in-port" not in jbackends.available_backends()
    finally:
        del backends._BACKENDS["probe-only-in-port"]
    if not torch.cuda.is_available():
        assert not backends.get_backend("engine").compiled_kernels()
