"""The examples' twins (``examples/*_torch.py``) on the CPU against the
reference's own functions:

* quickstart: the Fig 2 order and makespan and the simulated speedups
  equal to the reference's (the same Python arithmetic); its R within the
  reference's QR tolerance (atol 2e-5, rtol 1e-4) of
  ``repro.apps.qr.run_qr(..., backend="ref")``; the engine's R bitwise
  its sequential R; the host dispatch count the reference's;
* nbody at 2,000 particles: the graph counts those of the reference's
  ``build_graph``, the efficiencies at 1/8/32/64 workers the reference's
  ``simulate``'s, the force error within tests/test_barneshut.py's bounds,
  and the chunked direct sum against the reference's ``acc_direct_ref``;
* trace_qr: tasks, items and item task ids those of the reference's
  ``lower_tables``, the trace valid under both packages'
  ``validate_chrome_trace``, and the port's measured item times replayed
  through the reference's ``replay_item_times`` giving the port's makespan;
* train_lm: 110 steps at (16, 2) (past the 100-step warmup) with the loss
  falling, its checkpoints, and ``greedy_sample`` on the reference's
  parameters (``models/convert.py``) token for token the reference
  example's own loop.

Each twin's ``main()`` runs once, with ``--device cpu``, through a
module-scoped fixture.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.apps import barneshut as jbh  # noqa: E402
from repro.apps import qr as jqr  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
QR_TOL = dict(atol=2e-5, rtol=1e-4)      # tests/test_kernels_qr.py
NBODY_N = 2000


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart():
    return load("quickstart").main(["--device", "cpu"])


def test_quickstart_graph_matches_reference(quickstart):
    """The reference example's Fig 2 graph, run by the reference's core."""
    s = jcore.QSched(nr_queues=2)
    shared = s.addres()
    a, b, c = (s.addtask(data=d, cost=1.0) for d in "ABC")
    for t in (b, c):
        s.addunlock(a, t)
        s.addlock(t, shared)
    order = []
    jcore.SequentialExecutor(s).run(lambda ty, data: order.append(data))
    assert quickstart["order"] == order
    assert quickstart["makespan"] == jcore.simulate(s, nr_workers=2).makespan
    assert quickstart["makespan"] == 3.0


def test_quickstart_speedups_match_reference(quickstart):
    t1 = jcore.simulate(jqr.make_qr_graph(16, 16, nr_queues=1)[0],
                        1).makespan
    want = {n: t1 / jcore.simulate(jqr.make_qr_graph(16, 16, nr_queues=n)[0],
                                   n).makespan
            for n in (1, 4, 16, 64)}
    assert quickstart["speedups"] == want


def test_quickstart_r_matches_reference(quickstart):
    a = quickstart["a"].numpy()
    r_ref, sched = jqr.run_qr(jnp.asarray(a), 32, "sequential",
                              backend="ref")
    assert quickstart["nr_tasks"] == sched.nr_tasks
    assert_allclose(quickstart["r"].numpy(), np.asarray(r_ref), **QR_TOL)
    r, a = quickstart["r"].double().numpy(), a.astype(np.float64)
    # chip_smoke.py's GRAM_TOL on ‖RᵀR − AᵀA‖_F / ‖A‖_F²
    assert np.linalg.norm(r.T @ r - a.T @ a) / np.linalg.norm(a) ** 2 < 1e-5


def test_quickstart_engine_is_bitwise_and_counts_match(quickstart):
    assert torch.equal(quickstart["r_engine"], quickstart["r"])
    assert quickstart["engine_gap"] == 0.0
    host, eng = jqr.dispatch_counts(quickstart["a"].numpy(), tile=32)
    assert (quickstart["host_dispatches"], quickstart["engine_dispatches"]) \
        == (host, eng)


# ---------------------------------------------------------------------------
# nbody
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nbody():
    mod = load("nbody")
    return mod, mod.main([str(NBODY_N), "--device", "cpu"])


def test_nbody_graph_and_efficiency_match_reference(nbody):
    mod, out = nbody
    x, m = out["x"], out["m"]
    g = jbh.build_graph(jbh.Octree(x, m, n_max=mod.N_MAX), n_task=mod.N_TASK)
    assert out["counts"] == g.counts
    for w in mod.SCALING_WORKERS:
        gw = jbh.build_graph(jbh.Octree(x, m, n_max=mod.N_MAX),
                             n_task=mod.N_TASK, nr_queues=w)
        r = jcore.simulate(gw.sched, w)
        assert out["efficiency"][w] == r.total_cost / (w * r.makespan)


def test_nbody_accuracy_within_reference_bounds(nbody):
    _, out = nbody
    assert out["median_rel"] < 2e-2     # tests/test_barneshut.py:134
    assert out["mean_rel"] < 5e-2       # tests/test_barneshut.py:135
    assert out["rel"].shape == (NBODY_N,)


def test_nbody_chunked_direct_sum_matches_reference(nbody):
    """The twin's direct sum, a chunk of targets at a time, against the
    reference's one-product ``acc_direct_ref`` on the sorted particles,
    and the chunk size does not change it."""
    from repro.kernels.nbody import ref as jref
    mod, out = nbody
    st = out["state"]
    want = np.asarray(jref.acc_direct_ref(jnp.asarray(st.x.numpy()),
                                          jnp.asarray(st.m.numpy())))
    scale = np.abs(want).max()
    assert_allclose(out["exact"].numpy(), want, rtol=2e-4, atol=1e-5 * scale)
    other = mod.direct_sum(st.x, st.m, chunk=97)
    assert_allclose(other.numpy(), out["exact"].numpy(), rtol=1e-5,
                    atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# trace_qr
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trace_qr(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "trace_qr.json"
    return load("trace_qr").main(["--device", "cpu", "--out", str(path)])


def test_trace_qr_tables_match_reference(trace_qr):
    a = jnp.asarray(np.random.default_rng(0).standard_normal((96, 96)),
                    jnp.float32)
    tiles, mt, nt = jqr._split_tiles(a, 32)
    sched, _ = jqr.make_qr_graph(mt, nt, nr_queues=4)
    plan = jcore.lower(sched, 4)
    tables = jengine.lower_tables(
        plan, sched, jqr._TileState(dict(tiles), "ref").batch_registry(),
        arg_width=jengine.QR_ARG_WIDTH, row_access=jengine.qr_row_access)
    assert trace_qr["nr_tasks"] == sched.nr_tasks
    assert trace_qr["nr_items"] == tables.nr_items
    assert np.array_equal(np.asarray(trace_qr["tables"].tids),
                          np.asarray(tables.tids))


def test_trace_qr_trace_is_valid_in_both_packages(trace_qr):
    from repro.obs.export import validate_chrome_trace as jvalidate
    from repro_torch.obs.export import validate_chrome_trace
    for check in (jvalidate, validate_chrome_trace):
        info = check(trace_qr["out"])
        assert info["processes"] == ["measured", "predicted"]
        assert info["events"] == trace_qr["info"]["events"]
    items = trace_qr["nr_items"]
    assert trace_qr["tasks_by_process"] == {"measured": items,
                                            "predicted": items}
    assert trace_qr["n_pred"] == items


def test_trace_qr_replay_matches_reference_simulator(trace_qr):
    """The port's measured item times through the reference's replay give
    the port's predicted makespan."""
    sched, _ = jqr.make_qr_graph(3, 3, nr_queues=4)
    res = jcore.replay_item_times(sched, trace_qr["tables"].tids,
                                  trace_qr["item_s"], nr_workers=4)
    assert res.makespan == pytest.approx(trace_qr["makespan"], rel=1e-12)
    assert trace_qr["makespan"] <= trace_qr["measured_s"] + 1e-12


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_lm(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("train_lm")
    mod = load("train_lm")
    return mod, workdir, mod.main(["--steps", "110", "--seq-len", "16",
                                   "--global-batch", "2", "--device", "cpu",
                                   "--workdir", str(workdir)])


def test_train_lm_loss_falls_and_checkpoints(train_lm):
    _, workdir, out = train_lm
    losses = out["losses"]
    assert len(losses) == 110 and all(np.isfinite(losses))
    assert np.mean(losses[:10]) - np.mean(losses[-10:]) > 0.1
    assert sorted(p.name for p in (workdir / "ckpt").iterdir()) == [
        "step_00000100", "step_00000110"]
    assert len(out["sample"]) == 16
    assert all(0 <= t < out["cfg"].vocab for t in out["sample"])


def test_train_lm_config_is_the_reference_examples(train_lm):
    from repro.configs import get_config
    mod, _, _ = train_lm
    for full, over in ((False, dict(d_model=256, n_layers=4, n_heads=4,
                                     n_kv_heads=2, d_ff=683, vocab=4096)),
                       (True, dict(d_model=768, n_layers=12, n_heads=12,
                                   n_kv_heads=4, d_ff=2048, vocab=32000))):
        want = get_config("qwen3-1.7b").reduced(**over)
        got = mod.example_config("qwen3-1.7b", full)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()


def test_greedy_sample_matches_reference_loop(train_lm):
    """greedy_sample on the reference's parameters equals the reference
    example's own loop (examples/train_lm.py), token for token."""
    from repro.configs import get_config
    from repro.models import lm as jlm
    from repro.models import serving as jserving
    from repro_torch.models import convert
    mod, _, _ = train_lm
    cfg = mod.example_config("qwen3-1.7b", False)
    jcfg = get_config("qwen3-1.7b").reduced(
        d_model=256, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=683,
        vocab=4096)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    # the reference example's loop, as written there
    tokens = jnp.zeros((1, 8), jnp.int32)
    logits, cache, pos = jserving.prefill(jp, jcfg, tokens)
    cache = jax.tree.map(
        lambda a: (jnp.pad(a, [(0, 0), (0, 0), (0, 24)] + [(0, 0)] *
                           (a.ndim - 3))
                   if a.ndim >= 4 and a.shape[2] == 8 else a), cache)
    want = []
    tok = jnp.argmax(logits, -1)[:, None]
    for _ in range(16):
        want.append(int(tok[0, 0]))
        logits, cache = jserving.decode_step(jp, jcfg, cache, tok, pos)
        tok = jnp.argmax(logits, -1)[:, None]
        pos = pos + 1
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), cfg)
    assert mod.greedy_sample(tp, cfg) == want
    with pytest.raises(ValueError):
        mod.greedy_sample(tp, cfg, n_new=25)
