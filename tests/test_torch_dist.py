"""The port's int8 compressed psum and ring matmuls on the CPU against the
reference.

* the three quantization tests of ``tests/test_dist.py`` (round trip
  within scale/2, error feedback unbiased over 200 steps, EF-SGD on a
  quadratic), each against the reference's outputs on the same seeded
  inputs;
* a spawned 8-rank gloo group for ``compressed_psum``: every rank's sum
  is the same, within 2e-2 of the exact sum (the reference's limit), and
  equal (to float32 summation order) to the reference's per-shard
  dequantized values summed; each rank's residual is the reference's;
* a spawned 8-rank gloo group for both ring matmuls against ``x @ w``
  (the reference's limits, 1e-4 and 1e-3), every rank's all-gather
  product the same;
* a spawned 4-rank gloo group (a 2x2 mesh) for the sharded step: the loss
  and every gradient leaf on DTensors against the plain step's, for a
  dense, an MLA + MoE and an SSM architecture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose, assert_array_equal  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from repro.dist import compression as jcomp  # noqa: E402
from repro_torch.dist.compression import (compressed_psum,  # noqa: E402
                                          dequantize_int8, quantize_int8)


class TestQuantization:
    def test_roundtrip_error_bound(self):
        x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
        q, s = quantize_int8(torch.from_numpy(x))
        err = torch.abs(dequantize_int8(q, s) - torch.from_numpy(x))
        assert float(err.max()) <= float(s) * 0.5 + 1e-7
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)

    def test_error_feedback_unbiased_over_time(self):
        rng = np.random.default_rng(1)
        g_seq = [(rng.standard_normal(64) * 0.01).astype(np.float32)
                 for _ in range(200)]
        ef, acc = {"g": torch.zeros(64)}, torch.zeros(64)
        jef, jacc = {"g": jnp.zeros(64)}, jnp.zeros(64)
        for g in g_seq:
            out, ef = compressed_psum({"g": torch.from_numpy(g)}, ef)
            acc = acc + out["g"]
            jout, jef = jcomp.compressed_psum({"g": jnp.asarray(g)}, jef)
            jacc = jacc + jout["g"]
        true = sum(g.astype(np.float64) for g in g_seq)
        assert_allclose(acc.numpy() + ef["g"].numpy(), true, atol=1e-4)
        assert_allclose(acc.numpy(), np.asarray(jacc), rtol=0, atol=1e-6)
        assert_allclose(ef["g"].numpy(), np.asarray(jef["g"]), rtol=0,
                        atol=1e-7)

    def test_ef_sgd_converges_on_quadratic(self):
        w, ef = torch.ones(32) * 5.0, {"w": torch.zeros(32)}
        jw, jef = jnp.ones(32) * 5.0, {"w": jnp.zeros(32)}
        for _ in range(300):
            out, ef = compressed_psum({"w": 2 * w}, ef)
            w = w - 0.05 * out["w"]
            jout, jef = jcomp.compressed_psum({"w": 2 * jw}, jef)
            jw = jw - 0.05 * jout["w"]
        assert float(torch.abs(w).max()) < 1e-2
        assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


class TestGlooRanks:
    def test_compressed_psum_matches_exact(self, tmp_path):
        workers.spawn(workers.compression, str(tmp_path))
        g, ef = workers.compression_inputs()
        got = [np.load(tmp_path / f"psum_{r}.npy")
               for r in range(workers.WORLD)]
        for r in range(1, workers.WORLD):
            assert_array_equal(got[r], got[0])
        exact = g.sum(0)
        rel = np.abs(got[0] - exact).max() / (np.abs(exact).max() + 1e-9)
        assert rel < 2e-2, f"compressed psum too lossy: {rel}"
        # the reference's single-shard path on each rank's (g, ef), summed
        want = np.zeros(128, np.float64)
        for r in range(workers.WORLD):
            out, ef2 = jcomp.compressed_psum({"g": jnp.asarray(g[r])},
                                             {"g": jnp.asarray(ef[r])})
            want += np.asarray(out["g"], np.float64)
            assert_allclose(np.load(tmp_path / f"ef_{r}.npy"),
                            np.asarray(ef2["g"]), rtol=0, atol=1e-7)
        assert_allclose(got[0], want, rtol=1e-6, atol=1e-6)

    def test_ring_matmuls_exact(self, tmp_path):
        workers.spawn(workers.ring_matmuls, str(tmp_path))
        x_ag, w_ag, x_rs, w_rs = workers.matmul_inputs()
        rows = x_rs.shape[0] // workers.WORLD
        want_rs = x_rs.astype(np.float64) @ w_rs
        for r in range(workers.WORLD):
            ag = np.load(tmp_path / f"ag_{r}.npy")
            assert np.abs(ag - x_ag.astype(np.float64) @ w_ag).max() < 1e-4
            if r:
                assert_array_equal(ag, np.load(tmp_path / "ag_0.npy"))
            rs = np.load(tmp_path / f"rs_{r}.npy")
            assert np.abs(rs - want_rs[r * rows:(r + 1) * rows]).max() < 1e-3

    def test_sharded_loss_and_grads_match_plain(self, tmp_path):
        """On 4 gloo ranks (a 2x2 mesh) the loss and every gradient leaf
        of a step on DTensors placed by the production rules match the
        plain step's, without and with activation sharding: float32
        reductions in another order (the limits), so each region's
        gradient layout (a partial sum where the region splits the work
        and the input is whole) is right."""
        workers.spawn(workers.sharded_grads, str(tmp_path), world=4)
        rows = np.load(tmp_path / "sharded.npy")
        assert rows.shape == (2 * len(workers.SHARDED_ARCHS), 3)
        assert_allclose(rows[:, 1], rows[:, 0], rtol=1e-6)
        assert rows[:, 2].max() < 1e-5, rows


def test_group_none_is_the_single_device_path():
    """``group=None`` returns each leaf's own dequantized value, as the
    reference's ``axis_name=None``, for a nested tree."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    ef = {"a": np.zeros((4, 5), np.float32), "b": {"c": np.zeros(7,
                                                                   np.float32)}}
    out, ef2 = compressed_psum(jax.tree.map(torch.from_numpy, tree),
                               jax.tree.map(torch.from_numpy, ef))
    jout, jef2 = jcomp.compressed_psum(jax.tree.map(jnp.asarray, tree),
                                       jax.tree.map(jnp.asarray, ef))
    for got, want in ((out, jout), (ef2, jef2)):
        assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
        assert_array_equal(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]))
