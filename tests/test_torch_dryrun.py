"""The port's dry run on the CPU: twins of ``tests/test_dryrun_small.py``
on torch's ``fake`` process group (one process plays every rank, the
shards are ``meta`` tensors).

* the skip rules and ``depth_variants`` for every architecture, against
  the reference's;
* the depth extrapolation against the full count within 2% on reduced
  qwen3 at 6 layers (here every layer is counted, so the full count is
  exact);
* every family's tiny train and decode cells on a ``fake`` 2×4 mesh:
  positive per-device FLOPs, and argument bytes equal to the local shards'
  bytes computed from the specs alone;
* ``collective_stats``: the names the counter files collectives under, a
  known event list, all-gathers on 2×4 and none on 1×1;
* ``run_cell``/``main`` for a skipped cell write the reference's record.
"""

import dataclasses
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402

# the reference's dry-run module sets XLA_FLAGS (512 forced host devices)
# at import, meant for a process of its own: put the flags back, so JAX
# tests that later share this process start JAX with their own
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdr  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.optim.tree import leaves, tree_map  # noqa: E402

TINY = {"tiny": dict(seq_len=64, global_batch=8, kind="train"),
        "tinydec": dict(seq_len=64, global_batch=8, kind="decode")}
FAMILIES = ("qwen3-1.7b", "kimi-k2-1t-a32b", "deepseek-v3-671b",
            "falcon-mamba-7b", "zamba2-7b", "whisper-tiny", "internvl2-76b")


@pytest.fixture
def tiny_shapes(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setitem(dr.SHAPES, k, v)


@pytest.fixture
def mesh_2x4():
    with dr.fake_world(8):
        yield make_host_mesh(2, 4, device_type="cpu")


def _spec_bytes(tree, specs, mesh) -> int:
    """The bytes of rank 0's shards, from the specs alone."""
    sizes = sharding.axis_sizes(mesh)
    total = 0
    for t, spec in zip(leaves(tree), leaves(specs)):
        n = t.numel()
        for entry in spec:
            for axis in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes[axis]
        total += n * t.element_size()
    return total


def test_skip_rules_match_reference():
    assert dr.skip_reason(get_config("granite-8b"), "long_500k")
    assert dr.skip_reason(get_config("falcon-mamba-7b"), "long_500k") is None
    assert dr.skip_reason(get_config("zamba2-7b"), "long_500k") is None
    for a in ARCH_IDS:
        for shape in dr.SHAPES:
            assert ((dr.skip_reason(get_config(a), shape) is None)
                    == (jdr.skip_reason(jget_config(a), shape) is None))
    assert dr.SHAPES == jdr.SHAPES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_depth_variants_match_reference(arch):
    c1, c2, u1, u2, uf = dr.depth_variants(get_config(arch))
    j1, j2, v1, v2, vf = jdr.depth_variants(jget_config(arch))
    assert (u1, u2, uf) == (v1, v2, vf)
    for c, j in ((c1, j1), (c2, j2)):
        assert c.family == j.family == get_config(arch).family
        assert (c.n_layers, c.enc_layers) == (j.n_layers, j.enc_layers)
        assert not c.scan_layers
    assert c2.n_layers > c1.n_layers and uf >= u2


def test_extrapolated_flops_match_full_count(tiny_shapes, mesh_2x4):
    cfg = get_config("qwen3-1.7b").reduced(
        n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=512)

    def flops_of(c):
        fn, args, _ = dr.build_cell(c, "tiny", mesh_2x4, False)
        return dr.analyse_step(fn, args)["flops_per_device"]

    truth = flops_of(dataclasses.replace(cfg, scan_layers=False))
    ext = dr._depth_extrapolate(cfg, "tiny", mesh_2x4, False)
    assert abs(ext["flops_per_device"] - truth) / truth < 0.02
    c1, c2, u1, u2, uf = dr.depth_variants(cfg)
    f1, f2 = flops_of(c1), flops_of(c2)
    assert ext["probe"]["d1"]["flops"] == f1
    assert ext["probe"]["d2"]["flops"] == f2


def test_build_cell_takes_a_shape_dict(tiny_shapes, mesh_2x4):
    cfg = get_config("qwen3-1.7b").reduced()
    _, by_name, _ = dr.build_cell(cfg, "tiny", mesh_2x4, False)
    _, by_dict, _ = dr.build_cell(cfg, dict(TINY["tiny"]), mesh_2x4, False)
    got, want = leaves(by_dict), leaves(by_name)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.shape, a.dtype, a.placements) == (b.shape, b.dtype,
                                                    b.placements)


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_runs_sharded_tiny(tiny_shapes, mesh_2x4, arch):
    cfg = get_config(arch).reduced()
    for shape in TINY:
        fn, args, _ = dr.build_cell(cfg, shape, mesh_2x4, False)
        specs = tree_map(
            lambda t: sharding.P(*_spec_of(t)), args)
        want = _spec_bytes(args, specs, mesh_2x4)
        rec = dr.analyse_step(fn, args)
        assert rec["flops_per_device"] > 0, (arch, shape)
        assert rec["memory"]["argument_bytes"] == want, (arch, shape)
        assert 0 < rec["memory"]["alias_bytes"] <= rec["memory"][
            "output_bytes"]
        assert rec["collectives"]["all-gather"]["count"] > 0


def _spec_of(t):
    """The tensor-dim → mesh-axes spec of a placed DTensor."""
    names = t.device_mesh.mesh_dim_names
    entries = [[] for _ in range(t.dim())]
    for name, p in zip(names, t.placements):
        if p.is_shard():
            entries[p.dim].append(name)
    return [tuple(e) if len(e) > 1 else (e[0] if e else None)
            for e in entries]


def test_collective_names_and_stats():
    assert dr.collective_name("_c10d_functional.all_gather_into_tensor."
                              "default") == "all-gather"
    assert dr.collective_name("_c10d_functional.reduce_scatter_tensor."
                              "default") == "reduce-scatter"
    assert dr.collective_name("_c10d_functional.all_reduce.default") \
        == "all-reduce"
    assert dr.collective_name("_dtensor.shard_dim_alltoall.default") \
        == "all-to-all"
    assert dr.collective_name("_c10d_functional.wait_tensor.default") is None
    assert dr.collective_name("aten.mm.default") is None
    st = dr.collective_stats([("all-gather", 8 * 128 * 2, 64 * 128 * 2),
                              ("all-reduce", 32 * 4, 32 * 4),
                              ("all-to-all", 4 * 16 * 4, 4 * 16 * 4)])
    assert st["all-gather"]["count"] == 1
    assert st["all-gather"]["operand_bytes"] == 8 * 128 * 2
    assert st["all-reduce"]["operand_bytes"] == 32 * 4
    assert st["all-to-all"]["count"] == 1
    assert st["collective-permute"]["count"] == 0
    assert dr.total_collective_bytes(st) == 8 * 128 * 2 + 32 * 4 + 4 * 16 * 4


def test_collectives_on_2x4_and_none_on_1x1(tiny_shapes):
    cfg = get_config("qwen3-1.7b").reduced()
    counts = {}
    for world, shape in ((8, (2, 4)), (1, (1, 1))):
        with dr.fake_world(world):
            mesh = make_host_mesh(*shape, device_type="cpu")
            fn, args, _ = dr.build_cell(cfg, "tiny", mesh, False)
            rec = dr.analyse_step(fn, args)
        counts[world] = rec
    assert counts[8]["collectives"]["all-gather"]["count"] > 0
    assert counts[1]["collective_operand_bytes_per_device"] == 0
    assert all(v["count"] == 0 for v in counts[1]["collectives"].values())
    # one device holds everything: the whole step's work and bytes
    one = counts[1]
    assert one["memory"]["argument_bytes"] == sum(
        t.numel() * t.element_size() for t in leaves(args))
    assert one["flops_per_device"] > counts[8]["flops_per_device"]


def test_skipped_cell_record_and_cli(tmp_path, monkeypatch, capsys):
    rec = dr.run_cell("granite-8b", "long_500k", "single", str(tmp_path))
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["skip_reason"]
    saved = json.loads((tmp_path / "single_granite-8b_long_500k.json")
                       .read_text())
    assert saved["status"] == "skipped" and saved["chips"] == 256
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "granite-8b,qwen3-1.7b", "--shape", "long_500k",
        "--mesh", "both", "--out", str(tmp_path)])
    dr.main()
    assert "done: 0 ok, 4 skipped, 0 errors" in capsys.readouterr().out
    assert math.isclose(rec["params"], get_config("granite-8b").param_count())
