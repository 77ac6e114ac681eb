"""Port of the tiled-QR tile kernels (``repro_torch.kernels.qr_tile``):
the plain PyTorch ops against the reference's Pallas kernels (interpret
mode) and its jnp oracles, the factorization invariants, the Householder
guards, and the wrappers' dispatch by device.

Tolerances are the reference's own kernel-vs-oracle ones
(tests/test_kernels_qr.py): atol 2e-5 / rtol 1e-4 for the factorizations,
whose column recurrences reassociate float32 sums differently in the two
frameworks, and atol 1e-5 for the applies (three products each).  The CUDA
kernels themselves are held against the plain ops on the card
(``chip_smoke.py`` and tests/test_torch_gpu.py).
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels.qr_tile import kernel as jkernel  # noqa: E402
from repro.kernels.qr_tile import ref as jref  # noqa: E402
from repro_torch.kernels.qr_tile import kernel, ops, ref  # noqa: E402

SIZES = [4, 8, 16, 32, 64]
FACT = dict(atol=2e-5, rtol=1e-4)     # reference: factorization tolerance
APPLY = dict(atol=1e-5)               # reference: apply tolerance


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def tt(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def close(got, *wants, **tol):
    for want in wants:
        for g, w in zip(got, want):
            assert_allclose(np.asarray(g), np.asarray(w), **tol)


@pytest.mark.parametrize("b", SIZES)
def test_geqrf_matches_reference(b):
    a = rand((b, b), b)
    got = [x.numpy() for x in ops.geqrf(tt(a))]
    assert got[1].shape == (b,)
    close(got, jkernel.geqrf(jnp.asarray(a), interpret=True),
          jref.geqrf_ref(jnp.asarray(a)), **FACT)


@pytest.mark.parametrize("b", SIZES)
def test_tsqrf_matches_reference(b):
    r0, a = np.triu(rand((b, b), b + 1)), rand((b, b), b + 2)
    got = [x.numpy() for x in ops.tsqrf(tt(r0), tt(a))]
    assert got[2].shape == (b,)
    close(got, jkernel.tsqrf(jnp.asarray(r0), jnp.asarray(a),
                             interpret=True),
          jref.tsqrf_ref(jnp.asarray(r0), jnp.asarray(a)), **FACT)


@pytest.mark.parametrize("b", SIZES)
def test_apply_qt_matches_reference(b):
    rv, _, t = jref.geqrf_ref(jnp.asarray(rand((b, b), b + 3)))
    c = rand((b, b), b + 4)
    got = ops.apply_qt(tt(rv), tt(t), tt(c)).numpy()
    close([got], [jkernel.apply_qt(rv, t, jnp.asarray(c), interpret=True)],
          [jref.apply_qt_ref(rv, t, jnp.asarray(c))], **APPLY)


@pytest.mark.parametrize("b", SIZES)
def test_apply_tsqt_matches_reference(b):
    _, v2, _, t = jref.tsqrf_ref(jnp.asarray(np.triu(rand((b, b), b + 5))),
                                 jnp.asarray(rand((b, b), b + 6)))
    c1, c2 = rand((b, b), b + 7), rand((b, b), b + 8)
    got = [x.numpy() for x in ops.apply_tsqt(tt(v2), tt(t), tt(c1), tt(c2))]
    close(got, jkernel.apply_tsqt(v2, t, jnp.asarray(c1), jnp.asarray(c2),
                                  interpret=True),
          jref.apply_tsqt_ref(v2, t, jnp.asarray(c1), jnp.asarray(c2)),
          **APPLY)


@pytest.mark.parametrize("b", SIZES)
def test_geqrf_reconstructs(b):
    """Q @ R == A and Q orthonormal (reference tolerance 5e-4)."""
    a = rand((b, b), 7 * b)
    rv, _, t = (x.numpy().astype(np.float64) for x in ref.geqrf_ref(tt(a)))
    v = np.tril(rv, -1) + np.eye(b)
    q = np.eye(b) - v @ t @ v.T
    assert_allclose(q @ np.triu(rv), a, atol=5e-4)
    assert_allclose(q.T @ q, np.eye(b), atol=5e-4)


@pytest.mark.parametrize("b", SIZES)
def test_tsqrf_reconstructs(b):
    r0, a = np.triu(rand((b, b), 3 * b)), rand((b, b), 3 * b + 1)
    r1, v2, _, t = (x.numpy() for x in ref.tsqrf_ref(tt(r0), tt(a)))
    vfull = np.vstack([np.eye(b), v2])
    q = np.eye(2 * b) - vfull @ t @ vfull.T
    rec = q @ np.vstack([r1, np.zeros((b, b), np.float32)])
    assert_allclose(rec, np.vstack([r0, a]), atol=5e-4)


@pytest.mark.parametrize("case", ["zero_column", "triangular", "zero_tile"])
def test_householder_guards(case):
    """sigma2 == 0 gives tau 0 (no reflection) and no NaN; the port agrees
    with the reference on such tiles."""
    b = 8
    a = rand((b, b), 11)
    if case == "zero_column":
        a[:, 2] = 0.0
    elif case == "triangular":
        a = np.triu(a)
    else:
        a[:] = 0.0
    rv, tau, t = (x.numpy() for x in ref.geqrf_ref(tt(a)))
    assert np.isfinite(rv).all() and np.isfinite(t).all()
    close([rv, tau, t], jref.geqrf_ref(jnp.asarray(a)), **FACT)
    if case != "zero_column":
        assert (tau == 0.0).all()          # nothing below the diagonal
    # the dense block of tsqrf: an all-zero column means tau_j = 0
    d = rand((b, b), 12)
    d[:, 5] = 0.0
    outs = [x.numpy() for x in ref.tsqrf_ref(tt(np.triu(a)), tt(d))]
    assert all(np.isfinite(o).all() for o in outs)
    close(outs, jref.tsqrf_ref(jnp.asarray(np.triu(a)), jnp.asarray(d)),
          **FACT)


def test_ops_cpu_tensors_take_plain_path():
    """A CPU tensor gets the plain version, counted in PLAIN_CALLS and never
    in LAUNCHES; a stack of tiles loops the single-tile version, so the
    batched result is bitwise equal to the per-tile calls."""
    kernel.reset_counts()
    b, n = 8, 3
    a = tt(rand((n, b, b), 21))
    rv, tau, t = ops.geqrf(a)
    assert rv.shape == (n, b, b) and tau.shape == (n, b)
    for i in range(n):
        one = ref.geqrf_ref(a[i])
        for x, y in zip((rv[i], tau[i], t[i]), one):
            assert torch.equal(x, y)
    c = tt(rand((n, b, b), 22))
    out = ops.apply_qt(rv, t, c)
    for i in range(n):
        assert torch.equal(out[i], ref.apply_qt_ref(rv[i], t[i], c[i]))
    assert kernel.PLAIN_CALLS["geqrf"] == 1
    assert kernel.PLAIN_CALLS["apply_qt"] == 1
    assert all(v == 0 for v in kernel.LAUNCHES.values())


def test_launch_counts_exact_under_threads():
    """The counters are shared by the threaded backend's workers: no
    increment may be lost, even with a short switch interval."""
    import threading
    kernel.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [kernel.count(kernel.LAUNCHES, "apply_tsqt")
                            for _ in range(2000)]) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert kernel.LAUNCHES["apply_tsqt"] == 16 * 2000
    kernel.reset_counts()


def test_ops_refuse_other_devices():
    """Neither a non-CPU tensor without a kernel nor mixed devices quietly
    run the plain version."""
    m = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.apply_qt(m, m, m)
    with pytest.raises(ValueError, match="CUDA"):
        ops.apply_qt(torch.zeros(8, 8), torch.zeros(8, 8), m)


def test_kernel_builds_only_at_launch_and_needs_nvcc(tmp_path, monkeypatch):
    """The binding imported (at the top of this file) with no nvcc and no
    card: nothing is built at import.  A launch builds first, and with no
    nvcc the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernel, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.lib()
    assert kernel._LIB is None
