"""The port's CUDA kernels on the card (``gpu`` marker; skipped without a
card).  No jax import, so the file runs on the machine with the H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, at the reference's kernel-vs-oracle tolerance (atol 2e-5,
rtol 1e-4: tests/test_kernels_qr.py).  Across the four execution modes the
card's R is bitwise equal (one set of ``__device__`` functions, one
blockDim); against the plain path on the CPU it agrees to atol
1e-4·max|R|, rtol 1e-4 (two float32 summation orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.apps import qr  # noqa: E402
from repro_torch.kernels.qr_tile import kernel, ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-5, rtol=1e-4)
MODES = ("sequential", "threaded", "rounds", "engine")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (H100)")
    return torch.device("cuda")


def rand(shape, seed, device):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape),
                        dtype=torch.float32, device=device)


def close(got, want):
    for g, w in zip(got, want):
        assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)


@pytest.mark.parametrize("b", [16, 32, 64])
@pytest.mark.parametrize("n", [1, 8])
def test_kernels_match_plain_on_card(cuda, b, n):
    a, c1, c2 = (rand((n, b, b), b + k, cuda) for k in range(3))
    rv, tau, t = ops.geqrf(a)
    r1, v2, tau2, t2 = ops.tsqrf(torch.triu(a), c1)
    q1 = ops.apply_qt(rv, t, c2)
    s1, s2 = ops.apply_tsqt(v2, t2, c1, c2)
    torch.cuda.synchronize()
    for i in range(n):
        close((rv[i], tau[i], t[i]), ref.geqrf_ref(a[i]))
        close((r1[i], v2[i], tau2[i], t2[i]),
              ref.tsqrf_ref(torch.triu(a[i]), c1[i]))
        close((q1[i],), (ref.apply_qt_ref(rv[i], t[i], c2[i]),))
        close((s1[i], s2[i]), ref.apply_tsqt_ref(v2[i], t2[i], c1[i], c2[i]))


def test_ops_check_operands(cuda):
    with pytest.raises(ValueError, match="float32"):
        ops.apply_qt(*(torch.zeros((8, 8), device=cuda,
                                   dtype=torch.float64),) * 3)
    big = torch.zeros((128, 128), device=cuda)
    with pytest.raises(ValueError, match="b <= 64"):
        ops.geqrf(big)
    nc = torch.zeros((16, 32), device=cuda)[:, :16]
    with pytest.raises(ValueError, match="contiguous"):
        ops.geqrf(nc)


def test_modes_bitwise_equal_and_match_cpu(cuda):
    a = np.random.default_rng(1).standard_normal((256, 256)).astype(
        np.float32)
    kernel.reset_counts()
    rs = {m: qr.run_qr(a, tile=32, mode=m, nr_queues=4, device=cuda)[0]
          for m in MODES}
    torch.cuda.synchronize()
    assert all(v > 0 for v in kernel.LAUNCHES.values()), kernel.LAUNCHES
    assert all(v == 0 for v in kernel.PLAIN_CALLS.values())
    for m in MODES[1:]:
        assert torch.equal(rs[m], rs["sequential"]), m
    want = qr.run_qr(a, tile=32, mode="engine", device="cpu")[0].numpy()
    assert_allclose(rs["engine"].cpu().numpy(), want,
                    atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_threaded_workers_launch_on_the_callers_stream(cuda):
    """Worker threads enter the caller's stream, so a run under a side
    stream keeps its dependency order and equals the sequential R."""
    a = np.random.default_rng(2).standard_normal((128, 128)).astype(
        np.float32)
    want, _ = qr.run_qr(a, tile=32, mode="sequential", device=cuda)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got, _ = qr.run_qr(a, tile=32, mode="threaded", nr_queues=4,
                           device=cuda)
    side.synchronize()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
