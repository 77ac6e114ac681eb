"""Port of the tiled QR end to end (``repro_torch.apps.qr.run_qr``), on the
CPU through the plain tile ops, against the reference.

* Within the port, the four execution modes are BITWISE equal: they run
  the same plain tile functions on the same values in the same dependency
  order (on the card they share one set of ``__device__`` functions).
* Against ``repro.apps.qr.run_qr(backend="pallas")`` in its ``sequential``
  and ``rounds`` modes: atol 1e-4·max|R|, rtol 1e-4 — two float32
  implementations of the same recurrences, rounded differently, with the
  error compounding over the levels of the factorization.  The
  reference's ``engine`` mode is not compared: it cannot run on the
  installed jax (``pl.load``).
* Mirrors tests/test_qr.py: the paper's structure counts, RᵀR = AᵀA below
  1e-4 relative, and R against LAPACK up to the signs of its rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.apps import qr as jqr  # noqa: E402
from repro_torch.apps import qr  # noqa: E402
from repro_torch.kernels.qr_tile import kernel  # noqa: E402

MODES = ("sequential", "threaded", "rounds", "engine")
CASES = [(96, 32), (128, 16)]        # (n, tile)


def rand_matrix(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    n, b = request.param
    a = rand_matrix(n, seed=n + b)
    rs = {m: qr.run_qr(a, tile=b, mode=m, nr_queues=4, device="cpu")[0]
          for m in MODES}
    return a, b, rs


@pytest.mark.parametrize("mode", MODES[1:])
def test_modes_bitwise_equal(case, mode):
    _, _, rs = case
    assert torch.equal(rs[mode], rs["sequential"])


@pytest.mark.parametrize("ref_mode", ["sequential", "rounds"])
def test_matches_reference_r(case, ref_mode):
    a, b, rs = case
    want, _ = jqr.run_qr(jnp.asarray(a), tile=b, mode=ref_mode,
                         backend="pallas", nr_queues=4)
    want = np.asarray(want)
    assert_allclose(rs["sequential"].numpy(), want,
                    atol=1e-4 * np.abs(want).max(), rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_r_is_valid(case, mode):
    a, _, rs = case
    r = rs[mode].numpy()
    assert np.abs(np.tril(r, -1)).max() == 0.0
    lhs, rhs = r.T @ r, a.T @ a
    assert np.abs(lhs - rhs).max() / np.abs(rhs).max() < 1e-4


def test_matches_lapack_up_to_signs():
    a = rand_matrix(64, seed=3)
    r, _ = qr.run_qr(a, tile=16, mode="sequential", device="cpu")
    r = r.numpy()
    r_ref = np.linalg.qr(a.astype(np.float64), mode="r")
    sign = np.sign(np.diag(r)) * np.sign(np.diag(r_ref))
    assert_allclose(r * sign[:, None], r_ref, atol=2e-3)


def test_input_matrix_untouched():
    """Tiles are cloned out of ``a``: no mode writes into the caller's
    matrix through a view."""
    a = torch.tensor(rand_matrix(64, seed=5))
    keep = a.clone()
    for m in MODES:
        qr.run_qr(a, tile=16, mode=m, nr_queues=2, device="cpu")
    assert torch.equal(a, keep)


def test_cpu_run_takes_only_plain_paths():
    kernel.reset_counts()
    qr.run_qr(rand_matrix(32), tile=16, mode="engine", device="cpu")
    assert kernel.PLAIN_CALLS["qr_walk"] == 1
    assert all(v == 0 for v in kernel.LAUNCHES.values())


class TestStructure:
    def test_paper_task_and_resource_counts(self):
        """2048² matrix, 64² tiles → 32×32 grid (tests/test_qr.py)."""
        c = qr.paper_counts(32, 32)
        assert c == {"tasks": 11440, "deps": 32240, "resources": 1024,
                     "locks": 21856, "uses": 11408}

    def test_task_type_counts(self):
        s, _ = qr.make_qr_graph(32, 32)
        by_type = {}
        for t in s.tasks:
            by_type[t.type] = by_type.get(t.type, 0) + 1
        assert by_type == {qr.T_GEQRF: 32, qr.T_LARFT: 496,
                           qr.T_TSQRF: 496, qr.T_SSRFT: 10416}

    def test_plan_and_table_counts_at_paper_size(self):
        """The main path's structure at 2048²/64² with 4 lanes: 94 rounds,
        125 write-colored phases (one walk launch each), largest phase
        296 rows, 649 host dispatches in rounds mode."""
        from repro_torch import engine
        from repro_torch.core import lower
        s, _ = qr.make_qr_graph(32, 32, nr_queues=4)
        plan = lower(s, 4)
        st = qr._TileState({(i, j): torch.empty(0) for i in range(32)
                            for j in range(32)})
        t = engine.lower_tables(plan, s, st.batch_registry(),
                                arg_width=engine.QR_ARG_WIDTH,
                                row_access=engine.qr_row_access)
        assert (plan.nr_rounds, t.nr_phases, t.nr_items,
                t.stats["max_phase_len"]) == (94, 125, 11440, 296)
        host, launches = qr.dispatch_counts(np.empty((2048, 2048)), 64, 4)
        assert (host, launches) == (649, 125)
