"""The port stands alone: ``repro_torch`` imports neither jax nor anything
of ``repro``, its entry points default to the card and refuse to run
quietly on the CPU, and its backend registry is its own."""

import importlib
import importlib.util
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.apps import barneshut as bh  # noqa: E402
from repro_torch.apps import qr  # noqa: E402
from repro_torch.kernels.nbody import kernel as nb_kernel  # noqa: E402
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
sys.exit(1 if bad or len(names) < 70 else 0)
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
    assert {"repro_torch.kernels.qr_tile.kernel",
            "repro_torch.kernels.nbody.kernel",
            "repro_torch.kernels.nbody.ops",
            "repro_torch.kernels.nbody.ref",
            "repro_torch.apps.barneshut",
            "repro_torch.kernels.paged_attention.kernel",
            "repro_torch.kernels.paged_attention.ops",
            "repro_torch.kernels.paged_attention.ref",
            "repro_torch.models.config", "repro_torch.models.layers",
            "repro_torch.models.lm", "repro_torch.models.serving",
            "repro_torch.models.mla", "repro_torch.models.moe",
            "repro_torch.models.ssm", "repro_torch.core.weights",
            "repro_torch.core.static_sched",
            "repro_torch.configs.deepseek_v3_671b",
            "repro_torch.configs.kimi_k2_1t_a32b",
            "repro_torch.models.convert", "repro_torch.configs",
            "repro_torch.configs.qwen3_1p7b",
            "repro_torch.serve", "repro_torch.serve.blockpool",
            "repro_torch.serve.faults", "repro_torch.serve.service",
            "repro_torch.serve.traffic", "repro_torch.obs.export",
            "repro_torch.launch.serve", "repro_torch.core.simulator",
            "repro_torch.pipeline", "repro_torch.pipeline.qsched_pipeline",
            "repro_torch.pipeline.exec", "repro_torch.pipeline.convert",
            "repro_torch.kernels.pipe_walk.kernel",
            "repro_torch.kernels.pipe_walk.ref",
            "repro_torch.kernels.flash_attention.kernel",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref",
            "repro_torch.optim", "repro_torch.optim.optimizers",
            "repro_torch.optim.tree", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.checkpoint",
            "repro_torch.checkpoint.ckpt", "repro_torch.trainer",
            "repro_torch.trainer.steps", "repro_torch.trainer.loop",
            "repro_torch.launch.train"} <= set(names)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert (torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction is False)


def test_run_qr_defaults_to_cuda_and_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    kernel.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        qr.run_qr(np.eye(32, dtype=np.float32), tile=16)
    assert all(v == 0 for v in kernel.PLAIN_CALLS.values())
    with pytest.raises(RuntimeError, match="CUDA"):
        qr._TileState.from_numpy({(0, 0): np.eye(4)})


def test_solve_defaults_to_cuda_and_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    nb_kernel.reset_counts()
    x = np.random.default_rng(0).random((64, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        bh.solve(x, np.ones(64), n_max=16, n_task=32)
    assert all(v == 0 for v in nb_kernel.PLAIN_CALLS.values())
    g = bh.build_graph(bh.Octree(x, np.ones(64), n_max=16), n_task=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        bh.BHState(g)


def test_service_and_launcher_default_to_cuda_and_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm
    from repro_torch.serve import GenerateService
    cfg = get_config("qwen3-1.7b").reduced()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    pa_kernel.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerateService(params, cfg)
    assert launch_serve.build_parser().parse_args(
        ["--arch", "qwen3-1.7b"]).device == "cuda"
    for extra in (["--continuous"], []):
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_serve.main(["--arch", "qwen3-1.7b", "--reduced"] + extra)
    assert all(v == 0 for v in pa_kernel.PLAIN_CALLS.values())


def test_blockpool_with_cache_defaults_to_cuda_and_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import get_config
    from repro_torch.serve import BlockPool
    cfg = get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockPool(4, 8, cfg=cfg)
    pool = BlockPool(4, 8, cfg=cfg, device="cpu")
    assert pool.leaves and all(
        t.device.type == "cpu" for t in pool.leaves.values())
    assert BlockPool(4, 8).leaves is None      # a pure allocator: no tensors


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


EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
TWINS = ("quickstart", "nbody", "trace_qr", "train_lm")
RUN_HELP = """
import runpy, sys
sys.argv = [{path!r}, '--help']
try:
    runpy.run_path({path!r}, run_name='__main__')
except SystemExit as e:
    code = e.code
bad = sorted(k for k in sys.modules
             if k == 'jax' or k.startswith('jax.') or k == 'repro'
             or k.startswith('repro.'))
print(bad)
sys.exit(1 if bad or code else 0)
"""


@pytest.mark.parametrize("name", TWINS)
def test_example_twin_imports_no_jax_and_nothing_of_repro(name):
    """examples/<name>_torch.py run as a program with --help loads no jax
    and no module of repro."""
    path = str(EXAMPLES / f"{name}_torch.py")
    out = subprocess.run([sys.executable, "-c", RUN_HELP.format(path=path)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "--device" in out.stdout


@pytest.mark.parametrize("name", TWINS)
def test_example_twin_defaults_to_cuda_and_raises_without_card(name,
                                                               tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = {"trace_qr": ["--out", str(tmp_path / "t.json")],
            "train_lm": ["--workdir", str(tmp_path / "w")]}.get(name, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    assert not any(tmp_path.iterdir())
