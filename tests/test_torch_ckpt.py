"""The port's checkpoints and data pipeline on the CPU against the
reference.

* twins of ``tests/test_traincore.py``'s checkpoint tests (round trip,
  atomicity, retention, async save) and data tests (deterministic
  restart, disjoint shards, learnable structure);
* the async save writes the values of the moment it was called, though
  the train step updates its tensors in place right after;
* ``SyntheticTokens.batch_at`` array-equal to the reference's for several
  (seed, step, shard);
* checkpoints cross between the packages: an fp32 ``{"params", "opt"}``
  tree written by the reference restores in the port and one written by
  the port restores in the reference, under the same leaf names
  (``opt__inner__m__embed__tok``); a bf16 tree written by the reference
  restores in the port bit for bit, and the port writes the same bytes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import SyntheticTokens as JTokens  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim.tree import leaves, tree_map  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These models are tiny: one intra-op thread is as fast, and the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestCheckpoint:
    """Twins of tests/test_traincore.py::TestCheckpoint on the port."""

    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "n": {"b": torch.ones((2,), dtype=torch.int32)},
                "h": torch.randn(5, generator=torch.Generator().manual_seed(0)
                                 ).to(torch.bfloat16)}
        save_checkpoint(str(tmp_path), 5, tree)
        assert latest_step(str(tmp_path)) == 5
        out = restore_checkpoint(str(tmp_path), 5, tree)
        for a, b in zip(leaves(tree), leaves(out)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_atomicity_no_partial_visible(self, tmp_path):
        """A .tmp directory must never be picked up as a checkpoint."""
        save_checkpoint(str(tmp_path), 1, {"a": torch.ones((4,))})
        os.makedirs(tmp_path / "step_00000002.tmp")
        assert latest_step(str(tmp_path)) == 1

    def test_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"a": torch.ones((2,))})
        assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                                "step_00000004"]

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
        tree = {"a": torch.arange(1000.0)}
        mgr.save(7, tree)
        tree["a"].mul_(-1.0)        # an in-place step right after the save
        mgr.wait()
        out = mgr.restore(7, tree)
        assert_allclose(out["a"].numpy(), np.arange(1000.0))

    def test_restore_refuses_missing_and_misshapen_leaves(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"a": torch.ones((4,))})
        with pytest.raises(KeyError, match="b"):
            restore_checkpoint(str(tmp_path), 1, {"b": torch.ones((4,))})
        with pytest.raises(ValueError, match="shape mismatch"):
            restore_checkpoint(str(tmp_path), 1, {"a": torch.ones((5,))})


class TestDataPipeline:
    """Twins of tests/test_traincore.py::TestDataPipeline, and the copy
    against the reference."""

    def test_deterministic_restart(self):
        d1 = SyntheticTokens(1000, 32, 4, seed=3)
        d2 = SyntheticTokens(1000, 32, 4, seed=3)
        assert (d1.batch_at(17)["tokens"] == d2.batch_at(17)["tokens"]).all()

    def test_shards_disjoint_streams(self):
        a = SyntheticTokens(1000, 32, 8, seed=3, shard_id=0, num_shards=2)
        b = SyntheticTokens(1000, 32, 8, seed=3, shard_id=1, num_shards=2)
        assert not (a.batch_at(0)["tokens"] == b.batch_at(0)["tokens"]).all()

    def test_learnable_structure(self):
        d = SyntheticTokens(100, 64, 4, seed=0, noise=0.0)
        t = d.batch_at(0)["tokens"]
        assert (t[:, 1:] == d.perm[t[:, :-1]]).all()

    @pytest.mark.parametrize("seed,step,shard,shards", [
        (0, 0, 0, 1), (0, 17, 0, 1), (3, 5, 1, 2), (7, 1000, 3, 4),
        (123, 2, 0, 8)])
    def test_batches_equal_the_reference(self, seed, step, shard, shards):
        kw = dict(seed=seed, shard_id=shard, num_shards=shards)
        mine = SyntheticTokens(151936, 128, 8, **kw)
        ref = JTokens(151936, 128, 8, **kw)
        np.testing.assert_array_equal(mine.perm, ref.perm)
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert set(got) == set(want) == {"tokens"}
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        it = iter(mine)
        np.testing.assert_array_equal(next(it)["tokens"],
                                      ref.batch_at(0)["tokens"])


# --- across the packages ------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """The reference's fp32 ``{"params", "opt"}`` tree at qwen3-1.7b
    --reduced after one AdamW step (nonzero moments, step 1), and the
    port's copy of it."""
    jcfg = jconfigs.get_config("qwen3-1.7b").reduced()
    tcfg = tconfigs.get_config("qwen3-1.7b").reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), jp)
    jp, js = joptim.adamw_update(grads, joptim.adamw_init(jp), jp, 1e-3)
    np_tree = jax.tree.map(np.asarray, {"params": jp, "opt": js})
    port = {"params": convert.params_from_reference(np_tree["params"], tcfg),
            "opt": convert.opt_state_from_reference(np_tree["opt"], tcfg)}
    return {"params": jp, "opt": js}, port


def _names(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["leaves"]}


def test_reference_checkpoint_restores_in_the_port(trees, tmp_path):
    ref, port = trees
    jckpt.save_checkpoint(str(tmp_path), 3, ref)
    like = tree_map(torch.zeros_like, port)
    assert isinstance(like["opt"], toptim.OptState)
    out = tckpt.restore_checkpoint(str(tmp_path), 3, like)
    assert int(out["opt"].step) == 1
    assert len(leaves(out)) == len(leaves(port)) == len(jax.tree.leaves(ref))
    for a, b in zip(leaves(out), leaves(port)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    names = _names(tmp_path / "step_00000003")
    assert {"opt__inner__m__embed__tok", "opt__step",
            "params__layers__attn__wq"} <= set(names)


def test_port_checkpoint_restores_in_the_reference(trees, tmp_path):
    ref, port = trees
    tckpt.save_checkpoint(str(tmp_path / "t"), 4, port)
    jckpt.save_checkpoint(str(tmp_path / "j"), 4, ref)
    assert _names(tmp_path / "t" / "step_00000004") == _names(
        tmp_path / "j" / "step_00000004")
    like = jax.tree.map(jnp.zeros_like, ref)
    out = jckpt.restore_checkpoint(str(tmp_path / "t"), 4, like)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_bf16_checkpoint_restores_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((3, 7, 5)).astype(np.float32)
    vals[0, 0, :3] = [np.inf, -0.0, 1e-40]
    ref = {"w": jnp.asarray(vals, jnp.bfloat16),
           "s": jnp.asarray(vals[0], jnp.float32),
           "step": jnp.asarray(9, jnp.int32)}
    jckpt.save_checkpoint(str(tmp_path / "j"), 2, ref)
    like = {"w": torch.zeros((3, 7, 5), dtype=torch.bfloat16),
            "s": torch.zeros((7, 5)), "step": torch.zeros((), dtype=torch.int32)}
    out = tckpt.restore_checkpoint(str(tmp_path / "j"), 2, like)
    want_bits = np.asarray(ref["w"]).view(np.uint16)
    np.testing.assert_array_equal(out["w"].view(torch.int16).numpy().view(
        np.uint16), want_bits)
    np.testing.assert_array_equal(out["s"].numpy(), vals[0])
    assert int(out["step"]) == 9
    # the port writes the reference's bytes and manifest
    tckpt.save_checkpoint(str(tmp_path / "t"), 2, out)
    for name in ("w.npy", "s.npy", "step.npy", "manifest.json"):
        assert (tmp_path / "t" / "step_00000002" / name).read_bytes() == (
            tmp_path / "j" / "step_00000002" / name).read_bytes(), name
