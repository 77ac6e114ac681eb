"""The port's sharding rules, activation constraints, ``scan_layers`` and
``batch_specs`` on the CPU against the reference.

* ``param_pspecs`` / ``opt_pspecs`` (AdamW) / ``batch_pspecs`` /
  ``cache_pspecs`` leaf for leaf against ``repro.dist.sharding``'s, for
  every architecture in ``ARCH_IDS``, on the single-pod (16×16) and
  multi-pod (2×16×16) mesh shapes: the reference's leaves from
  ``jax.eval_shape`` as in ``tests/test_sharding_specs.py``, the port's
  from ``meta`` tensors (``lm.param_shapes``); the leaf paths and shapes
  agree too;
* ``shardings_for``: a spec over two mesh axes (``("pod", "data")``) is
  ``Shard(d)`` on both, in the mesh's order;
* ``constrain``: the tensor itself outside the context and for a plain
  tensor inside it; inside, a DTensor's placements on a ``fake`` 2×4 mesh,
  with absent axes and indivisible dims dropped;
* ``scan_util.scan_layers`` and ``data.batch_specs`` array for array
  against the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_array_equal  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import batch_specs as jbatch_specs  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import scan_util as jscan  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import batch_specs  # noqa: E402
from repro_torch.dist import sharding as tsharding  # noqa: E402
from repro_torch.dist.act_sharding import (activation_sharding,  # noqa: E402
                                           constrain)
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import scan_util as tscan  # noqa: E402
from repro_torch.models import serving as tserving  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.tree import flatten_with_path, leaves  # noqa: E402

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _abstract_mesh(kind):
    """The reference's rules read only ``mesh.shape`` (as its own spec
    tests do)."""
    class _MeshShape:
        shape = MESHES[kind]
    return _MeshShape()


def _norm(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _jax_named(tree):
    def key(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return getattr(k, attr)
        raise TypeError(k)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [(tuple(key(k) for k in path), leaf) for path, leaf in flat]


def _assert_same_specs(port_specs, ref_specs, port_leaves, ref_leaves):
    got = flatten_with_path(port_specs)
    want = _jax_named(ref_specs)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert _norm(g) == _norm(w), (path, g, w)
    shapes = [tuple(t.shape) for _, t in flatten_with_path(port_leaves)]
    assert shapes == [tuple(x.shape) for x in jax.tree.leaves(ref_leaves)]


@pytest.fixture(scope="module")
def shapes():
    """(cfg, port params on meta, reference eval_shape) per architecture."""
    out = {}
    for arch in tconfigs.ARCH_IDS:
        jcfg = jconfigs.get_config(arch)
        out[arch] = (tconfigs.get_config(arch),
                     tlm.param_shapes(tconfigs.get_config(arch)),
                     jcfg,
                     jax.eval_shape(functools.partial(
                         jlm.init_params, jax.random.PRNGKey(0), jcfg)))
    return out


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_and_adamw_specs_match_reference(shapes, arch, kind):
    cfg, tp, jcfg, jp = shapes[arch]
    mesh, jmesh = MESHES[kind], _abstract_mesh(kind)
    multi = kind == "multi"
    ps = tsharding.param_pspecs(tp, mesh, multi)
    jps = jsharding.param_pspecs(jp, jmesh, multi)
    _assert_same_specs(ps, jps, tp, jp)
    opt = adamw_init(tp)
    jopt = jax.eval_shape(jmake_optimizer("adamw", 1e-3)[0], jp)
    _assert_same_specs(tsharding.opt_pspecs(ps, opt, mesh),
                       jsharding.opt_pspecs(jps, jopt, jmesh), opt, jopt)
    for mode in ("train", "decode"):
        b = batch_specs(cfg, 4096, 256, mode)
        jb = jbatch_specs(jcfg, 4096, 256, mode)
        _assert_same_specs(tsharding.batch_pspecs(b, mesh, multi),
                           jsharding.batch_pspecs(jb, jmesh, multi), b, jb)


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cache_specs_match_reference(arch, kind):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    mesh, jmesh = MESHES[kind], _abstract_mesh(kind)
    for batch in (32, 8):
        c = tserving.init_cache(cfg, batch, 1024, torch.device("meta"))
        jc = jax.eval_shape(functools.partial(jserving.init_cache, jcfg,
                                              batch, 1024))
        _assert_same_specs(
            tsharding.cache_pspecs(c, cfg, mesh, kind == "multi"),
            jsharding.cache_pspecs(jc, jcfg, jmesh, kind == "multi"), c, jc)


def test_spec_over_two_axes_is_shard_on_both_in_mesh_order():
    with fake_world(8):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        spec = tsharding.P(("pod", "data"), None, "model")
        assert tsharding.placements_for(spec, mesh) == (Shard(0), Shard(0),
                                                        Shard(2))
        with pytest.raises(ValueError):
            tsharding.placements_for(tsharding.P(("data", "pod")), mesh)
        x = torch.arange(8 * 3 * 4, dtype=torch.float32).reshape(8, 3, 4)
        d = tsharding.shardings_for({"x": spec}, mesh)["x"].place(x)
        # rank 0 holds the first of 4 row blocks (pod-major) and the
        # first half of the last dim
        assert_array_equal(d.to_local().numpy(), x[:2, :, :2].numpy())


class TestConstrain:
    def test_noop_outside_context_and_on_plain_tensors(self):
        x = torch.ones((4, 4))
        assert constrain(x, "dp", "tp") is x
        with activation_sharding("data", "model"):
            assert constrain(x, "dp", "tp") is x

    def test_places_inside_context_and_drops_indivisible(self):
        with fake_world(8):
            mesh = make_host_mesh(2, 4, device_type="cpu")
            x = tsharding.Sharding(mesh, (Replicate(), Replicate())).place(
                torch.ones(4, 8))
            assert constrain(x, "dp", "tp") is x        # outside the context
            with activation_sharding("data", "model"):
                y = constrain(x, "dp", "tp")
                assert tuple(y.placements) == (Shard(0), Shard(1))
                z = constrain(x, "dp", None, "tp")      # trailing dims omitted
                assert tuple(z.placements) == (Shard(0), Replicate())
            with activation_sharding(("pod", "data"), "model"):
                w = constrain(
                    tsharding.Sharding(mesh, (Replicate(), Replicate())).place(
                        torch.ones(3, 5, 7)), "dp", None, "tp")
                assert tuple(w.placements) == (Replicate(), Replicate())
            assert_array_equal(y.full_tensor().numpy(), np.ones((4, 8)))


def test_scan_layers_matches_reference():
    rng = np.random.default_rng(0)
    xs = {"w": rng.standard_normal((5, 3, 3)).astype(np.float32),
          "b": rng.standard_normal((5, 3)).astype(np.float32)}
    init = rng.standard_normal(3).astype(np.float32)

    def tf(c, x):
        c = torch.tanh(x["w"] @ c + x["b"])
        return c, {"c": c, "s": c.sum()}

    def jf(c, x):
        c = jnp.tanh(x["w"] @ c + x["b"])
        return c, {"c": c, "s": c.sum()}

    tx = {k: torch.from_numpy(v) for k, v in xs.items()}
    carry, ys = tscan.scan_layers(tconfigs.get_config("qwen3-1.7b"), tf,
                                  torch.from_numpy(init), tx)
    for scan in (True, False):
        jcfg = jconfigs.get_config("qwen3-1.7b")
        jcfg = jcfg.__class__(**{**jcfg.__dict__, "scan_layers": scan})
        jcarry, jys = jscan.scan_layers(jcfg, jf, jnp.asarray(init),
                                        jax.tree.map(jnp.asarray, xs))
        np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry),
                                   rtol=1e-6, atol=1e-6)
        for k in ("c", "s"):
            np.testing.assert_allclose(ys[k].numpy(), np.asarray(jys[k]),
                                       rtol=1e-6, atol=1e-6)
    none_carry, none_ys = tscan.scan_layers(
        None, lambda c, x: (c + x["b"], None), torch.zeros(3), tx)
    assert none_ys is None
    np.testing.assert_allclose(none_carry.numpy(), xs["b"].sum(0), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-76b",
                                  "whisper-tiny", "falcon-mamba-7b"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_batch_specs_match_reference(arch, mode):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    got = batch_specs(cfg, 2048, 16, mode)
    want = jbatch_specs(jcfg, 2048, 16, mode)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
    with pytest.raises(ValueError):
        batch_specs(cfg, 2048, 16, "score")


class TestReshardingRestore:
    """``restore_checkpoint(..., shardings)`` on a ``fake`` 2×4 mesh: each
    leaf comes back a DTensor with its spec's placements, and rank 0's
    shard holds the saved values bit for bit, whatever mesh saved it."""

    @staticmethod
    def _rank0_block(full, d):
        """Rank 0's block of ``full`` on the 2×4 mesh from the DTensor's
        placements (rank 0 holds the first block of each sharded dim)."""
        sl = [slice(None)] * full.dim()
        for p, n in zip(d.placements, d.device_mesh.shape):
            if p.is_shard():
                sl[p.dim] = slice(0, full.shape[p.dim] // n)
        return full[tuple(sl)]

    def _check(self, out, want, shardings):
        for (path, got), w, shd in zip(flatten_with_path(out),
                                       flatten_with_path(want),
                                       leaves(shardings)):
            assert tuple(got.placements) == shd.placements, path
            assert got.dtype == w[1].dtype, path
            loc = got.to_local()
            exp = self._rank0_block(w[1], got)
            assert torch.equal(loc.view(torch.uint8) if loc.dim() else loc,
                               exp.contiguous().view(torch.uint8)
                               if exp.dim() else exp), path

    def test_port_checkpoint_restores_sharded_bitwise(self, tmp_path):
        from repro_torch.checkpoint import CheckpointManager
        cfg = tconfigs.get_config("qwen3-1.7b").reduced()
        gen = torch.Generator().manual_seed(0)
        params = tlm.init_params(gen, cfg)
        tree = {"params": params, "opt": adamw_init(params)}
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(5, tree)
        with fake_world(8):
            mesh = make_host_mesh(2, 4, device_type="cpu")
            ps = tsharding.param_pspecs(params, mesh)
            specs = {"params": ps,
                     "opt": tsharding.opt_pspecs(ps, tree["opt"], mesh)}
            shardings = tsharding.shardings_for(specs, mesh)
            out = mgr.restore(5, tree, shardings)
            self._check(out, tree, shardings)
            assert any(not isinstance(p, Replicate)
                       for s in leaves(shardings)
                       for p in s.placements)

    def test_reference_checkpoint_restores_sharded_bitwise(self, tmp_path):
        from repro import checkpoint as jckpt
        from repro_torch.checkpoint import restore_checkpoint
        rng = np.random.default_rng(0)
        vals = rng.standard_normal((6, 8, 12)).astype(np.float32)
        ref = {"w": jnp.asarray(vals, jnp.bfloat16),
               "s": jnp.asarray(vals[0], jnp.float32),
               "step": jnp.asarray(9, jnp.int32)}
        jckpt.save_checkpoint(str(tmp_path), 2, ref)
        like = {"w": torch.empty((6, 8, 12), dtype=torch.bfloat16,
                                 device="meta"),
                "s": torch.empty((8, 12), device="meta"),
                "step": torch.empty((), dtype=torch.int32, device="meta")}
        want = {"w": torch.from_numpy(np.asarray(ref["w"]).view(np.int16)
                                      .copy()).view(torch.bfloat16),
                "s": torch.from_numpy(vals[0].copy()),
                "step": torch.tensor(9, dtype=torch.int32)}
        with fake_world(8):
            mesh = make_host_mesh(2, 4, device_type="cpu")
            shardings = tsharding.shardings_for(
                tsharding.param_pspecs(like, mesh), mesh)
            out = restore_checkpoint(str(tmp_path), 2, like, shardings)
            self._check(out, want, shardings)
            assert tuple(out["w"].placements) == (Shard(1), Shard(2))
