"""The port's CUDA kernels on the card (``gpu`` marker; skipped without a
card).  No jax import, so the file runs on the machine with the H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, at the reference's kernel-vs-oracle tolerance (QR: atol 2e-5,
rtol 1e-4, tests/test_kernels_qr.py; N-body: rtol 2e-4, atol 1e-5,
tests/test_kernels_nbody.py).  Across the four execution modes the card's
QR R is bitwise equal (one set of ``__device__`` functions, one
blockDim); against the plain path on the CPU it agrees to atol
1e-4·max|R|, rtol 1e-4 (two float32 summation orders).  The N-body
tolerance applies to each target's acceleration vector, not to each of its
components: a component that cancels to ~1 out of terms of ~10³ keeps no
relative precision in any float32 sum, and the kernel and its plain
version sum in different orders (rsqrtf in order j = 0, 1, ... against
PyTorch's blocked reductions).  Barnes-Hut's
modes sum in different orders (a leaf's COM sources in one launch or in
rows of 8), so they agree within 1e-4 per particle, relative, with each
other and with the CPU plain path (the reference's cross-mode tolerance).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch import engine  # noqa: E402
from repro_torch.apps import barneshut as bh  # noqa: E402
from repro_torch.apps import qr  # noqa: E402
from repro_torch.core import lower  # noqa: E402
from repro_torch.kernels.nbody import kernel as nb_kernel  # noqa: E402
from repro_torch.kernels.nbody import ops as nb_ops  # noqa: E402
from repro_torch.kernels.nbody import ref as nb_ref  # noqa: E402
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


NB_RTOL, NB_ATOL = 2e-4, 1e-5


def close_vec(got, want, axis):
    """|got - want| <= 2e-4 |want| + 1e-5 for each target's vector (the
    coordinates run along ``axis``)."""
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.isfinite(g).all()
    err = np.linalg.norm(g - w, axis=axis)
    bound = NB_RTOL * np.linalg.norm(w, axis=axis) + NB_ATOL
    assert (err <= bound).all(), float((err / bound).max())


def cloud(n, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.random((3, n)), dtype=torch.float32, device=device)
    m = torch.tensor(rng.random(n) + 0.1, dtype=torch.float32,
                     device=device)
    return x, m


@pytest.mark.parametrize("ni,nj", [(1, 1), (37, 100), (58, 463),
                                   (128, 128), (300, 29)])
def test_nbody_kernels_match_plain_on_card(cuda, ni, nj):
    xi, mi = cloud(ni, ni, cuda)
    xj, mj = cloud(nj, nj + 1, cuda)
    xj[:, :3] = xi[:, :1]              # coincident with a target
    mj[-5:] = 0.0                      # zero masses
    nb_kernel.reset_counts()
    got = nb_ops.acc_pair(xi, xj, mj)
    self_ = nb_ops.acc_self(xi, mi)
    strided = nb_ops.acc_pair(xi[:, : ni // 2 + 1],
                              xj.T.contiguous()[1:].T, mj[1:])
    torch.cuda.synchronize()
    assert nb_kernel.LAUNCHES["acc_pair"] == 2
    assert nb_kernel.LAUNCHES["acc_self"] == 1
    assert all(v == 0 for v in nb_kernel.PLAIN_CALLS.values())
    for g, w in ((got, nb_ref.acc_pair_ref(xi, xj, mj)),
                 (self_, nb_ref.acc_self_ref(xi, mi)),
                 (strided, nb_ref.acc_pair_ref(xi[:, : ni // 2 + 1],
                                               xj[:, 1:], mj[1:]))):
        close_vec(g, w, axis=0)


def bh_lowered(n, seed, n_max, n_task, device):
    rng = np.random.default_rng(seed)
    x, m = rng.random((n, 3)), rng.random(n) + 0.5
    g = bh.build_graph(bh.Octree(x, m, n_max=n_max), n_task=n_task,
                       nr_queues=4)
    st = bh.BHState(g, device=device)
    plan = lower(g.sched, 4)
    tab = engine.lower_tables(plan, g.sched, st.batch_registry(),
                              arg_width=engine.BH_ARG_WIDTH,
                              row_access=engine.bh_row_access)
    return x, m, st, tab


@pytest.mark.parametrize("n,n_max,n_task", [(3000, 48, 192),
                                             (400, 4, 16)])   # P < 8
def test_bh_walk_matches_plain_walk_on_card(cuda, n, n_max, n_task):
    _, _, st, tab = bh_lowered(n, 5, n_max, n_task, cuda)
    lg = engine.launch_groups(tab, engine.bh_row_keys)
    hooks = st.engine_hooks()
    statics = hooks.statics()
    walked, plain = hooks.buffers(), hooks.buffers()
    desc = torch.as_tensor(tab.desc[lg.order], device=cuda)
    nb_kernel.reset_counts()
    hooks.round_fn(desc, lg, statics, walked)
    engine.bh_walk_plain(tab.desc, *statics, *plain, st.eps)
    torch.cuda.synchronize()
    assert nb_kernel.LAUNCHES["bh_walk"] <= lg.nr_groups <= tab.nr_rounds
    for got, want in zip(walked, plain):      # acc (L,3,P), com, cmass
        close_vec(got, want, axis=1)


def rel_err(a, want):
    a, want = a.double().cpu().numpy(), want.double().cpu().numpy()
    num = np.linalg.norm(a - want, axis=0)
    return num / np.maximum(np.linalg.norm(want, axis=0), 1e-12)


def test_bh_modes_agree_on_card_and_with_cpu(cuda):
    rng = np.random.default_rng(2)
    x, m = rng.random((2000, 3)), rng.random(2000) + 0.5
    nb_kernel.reset_counts()
    accs = {md: bh.solve(x, m, n_max=32, n_task=128, mode=md,
                         nr_workers=4, device=cuda)[0] for md in MODES}
    torch.cuda.synchronize()
    assert all(v > 0 for v in nb_kernel.LAUNCHES.values())
    assert all(v == 0 for v in nb_kernel.PLAIN_CALLS.values())
    cpu = bh.solve(x, m, n_max=32, n_task=128, mode="engine",
                   device="cpu")[0]
    for md in MODES:
        assert rel_err(accs[md], accs["sequential"]).max() < 1e-4, md
        assert rel_err(accs[md], cpu).max() < 1e-4, md


def test_bh_walk_launches_per_plan_within_rounds(cuda):
    x, m, _, tab = bh_lowered(20000, 7, 64, 256, cuda)
    nb_kernel.reset_counts()
    bh.solve(x, m, n_max=64, n_task=256, mode="engine", nr_workers=4,
             device=cuda)
    torch.cuda.synchronize()
    assert 1 <= nb_kernel.LAUNCHES["bh_walk"] <= tab.nr_rounds
