"""Port of the N-body interaction ops (``repro_torch.kernels.nbody``)
against the reference: the same numpy inputs through
``repro.kernels.nbody.ref`` (the jnp oracles) and through the reference's
Pallas kernels in interpret mode, at the reference's kernel-vs-oracle
tolerance (rtol 2e-4, atol 1e-5: tests/test_kernels_nbody.py).  On CPU
tensors the port's ops run their plain versions; the CUDA kernels are held
against those on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels.nbody import ops as jops  # noqa: E402
from repro.kernels.nbody import ref as jref  # noqa: E402
from repro_torch.kernels.nbody import kernel, ops, ref  # noqa: E402

TOL = dict(rtol=2e-4, atol=1e-5)


def cloud(n, seed, coincident=0, massless=0):
    """(3,n) positions in the unit cube and masses in [0.1, 1.1); the
    first ``coincident`` particles share one position, the last
    ``massless`` have zero mass."""
    rng = np.random.default_rng(seed)
    x = rng.random((3, n)).astype(np.float32)
    m = (rng.random(n) + 0.1).astype(np.float32)
    x[:, :coincident] = x[:, :1]
    if massless:
        m[n - massless:] = 0.0
    return x, m


# ragged path shapes (a 37-particle leaf against a 100-particle one, a
# 58-particle leaf against 463 COM sources), a lane multiple, one particle
PAIR_CASES = [(37, 100, 0, 0), (58, 463, 0, 0), (128, 128, 0, 0),
              (1, 1, 0, 0), (40, 60, 6, 20)]


@pytest.mark.parametrize("ni,nj,coincident,massless", PAIR_CASES)
def test_pair_matches_reference(ni, nj, coincident, massless):
    xi, _ = cloud(ni, ni)
    xj, mj = cloud(nj, nj + 1, coincident, massless)
    xj[:, :coincident] = xi[:, :1]     # sources on top of a target
    got = ops.acc_pair(*map(torch.from_numpy, (xi, xj, mj))).numpy()
    assert got.shape == (3, ni) and np.isfinite(got).all()
    args = tuple(map(jnp.asarray, (xi, xj, mj)))
    assert_allclose(got, np.asarray(jref.acc_pair_ref(*args)), **TOL)
    assert_allclose(got, np.asarray(jops.acc_pair(*args, backend="pallas")),
                    **TOL)


@pytest.mark.parametrize("n,coincident,massless",
                         [(37, 0, 0), (58, 0, 0), (128, 0, 0), (1, 0, 0),
                          (50, 5, 10)])
def test_self_matches_reference(n, coincident, massless):
    x, m = cloud(n, n + 7, coincident, massless)
    got = ops.acc_self(*map(torch.from_numpy, (x, m))).numpy()
    assert got.shape == (3, n) and np.isfinite(got).all()
    args = (jnp.asarray(x), jnp.asarray(m))
    assert_allclose(got, np.asarray(jref.acc_self_ref(*args)), **TOL)
    assert_allclose(got, np.asarray(jops.acc_self(*args, backend="pallas")),
                    **TOL)


def test_direct_sum_matches_reference():
    x, m = cloud(300, 5)
    got = ref.acc_direct_ref(torch.from_numpy(x), torch.from_numpy(m))
    want = jref.acc_direct_ref(jnp.asarray(x), jnp.asarray(m))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ref.DEFAULT_EPS == jref.DEFAULT_EPS


def test_zero_mass_sources_add_exactly_zero():
    """The engine's padded leaf blocks rely on it: a zero-mass source, even
    one on top of the target, changes no bit of the sum."""
    xi, _ = cloud(20, 1)
    xj, mj = cloud(30, 2)
    pad = np.concatenate([xj, np.zeros((3, 8), np.float32),
                          xi[:, :4]], axis=1)
    mpad = np.concatenate([mj, np.zeros(12, np.float32)])
    t = torch.from_numpy
    assert torch.equal(ops.acc_pair(t(xi), t(xj), t(mj)),
                       ops.acc_pair(t(xi), t(pad), t(mpad)))


def test_strided_views_take_the_same_path():
    """The app hands the ops a cell's slice of the (3, N) positions and a
    transposed gather of COM rows; both are views, never copied."""
    x, m = cloud(90, 3)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    com = xt.T.contiguous()                      # (N, 3) rows
    got = ops.acc_pair(xt[:, 10:40], com[50:80].T, mt[50:80])
    want = ops.acc_pair(xt[:, 10:40].contiguous(),
                        com[50:80].T.contiguous(), mt[50:80].clone())
    assert torch.equal(got, want)


def test_cpu_tensors_count_plain_calls_only():
    kernel.reset_counts()
    x, m = map(torch.from_numpy, cloud(16, 4))
    ops.acc_pair(x, x, m)
    ops.acc_self(x, m)
    assert kernel.PLAIN_CALLS == {"acc_pair": 1, "acc_self": 1,
                                  "bh_walk": 0}
    assert all(v == 0 for v in kernel.LAUNCHES.values())
    kernel.reset_counts()


def test_ops_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, and so
    are mixed devices: nothing falls back to the plain version."""
    x = torch.zeros((3, 4), device="meta")
    m = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.acc_self(x, m)
    with pytest.raises(ValueError, match="CUDA"):
        ops.acc_pair(torch.zeros((3, 4)), x, m)


def test_kernel_builds_only_at_launch_and_needs_nvcc(tmp_path, monkeypatch):
    """The binding imports with no nvcc and no card; a launch builds
    first, and with no nvcc the build raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernel, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.lib()
    assert kernel._LIB is None
