"""Port of the pipelined value-and-grad (``repro_torch.pipeline``, the
pipeline part of ``repro_torch.engine``, ``repro_torch.core.simulator``)
against the reference, on the CPU.

* Structure: the port's pipeline graph, plan, task tables and synthesized
  schedule equal the reference's, array for array, at (S, M) = (3, 6),
  (4, 8) and (8, 64) (the reference bench's full schedule); ``simulate``
  on a QR graph equals the reference's event for event.
* Numbers: the four modes (the engine's plain walk on the CPU) against the
  reference's ``rounds`` mode and against ``jax.value_and_grad`` of the
  monolithic loss on the same numpy inputs, at the reference's pipeline
  tolerance (loss |Δ| < 1e-6; gradients rtol 1e-5, atol 1e-6,
  tests/test_backends.py::TestMatrixPipeline).  The reference's own engine
  mode cannot be compared: its Pallas walk fails on this jax (no
  ``pl.load``).
* ``pipe_walk_plain`` row by row against a float64 recomputation of each
  row from the walk's own state, and the host side of the CUDA walk (its
  tile offsets); the rejections.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.apps import qr as jqr  # noqa: E402
from repro.core import simulate as jsimulate  # noqa: E402
from repro.core import scaling_curve as jscaling_curve  # noqa: E402
from repro import pipeline as jpipe  # noqa: E402
from repro.pipeline import exec as jexec  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch import pipeline as pipe  # noqa: E402
from repro_torch.apps import qr  # noqa: E402
from repro_torch.core import BackendUnsupported, scaling_curve, simulate  # noqa: E402
from repro_torch.kernels.pipe_walk import kernel as pw_kernel  # noqa: E402
from repro_torch.pipeline import exec as pexec  # noqa: E402

MODES = ("sequential", "threaded", "rounds", "engine")
SHAPES = [(3, 6), (4, 8), (8, 64)]
TABLE_FIELDS = ("desc", "tids", "round_offsets", "phase_offsets",
                "round_phase_ptr")
LOSS_TOL = 1e-6
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def streams(s):
    out = [s._ttype, s._tdata, s._tcost, [r.owner for r in s.resources],
           [r.parent for r in s.resources]]
    for x in (s._deps, s._locks, s._uses):
        xa, xb = x.arrays()
        out += [xa.tolist(), xb.tolist()]
    return out


def plan_rounds(plan):
    return [(r.tids, [(b.ttype, b.tids) for b in r.batches], r.lanes)
            for r in plan.rounds]


def lowered(mod_pipe, mod_exec, mod_engine, S, M):
    sched, meta, plan = mod_pipe.lower_pipeline_plan(S, M,
                                                     per_stage_window=True)
    reg = mod_exec._PipeRunner([mod_exec.dense_stage] * S,
                               mod_exec.mse_loss, [{}] * S,
                               [{}] * M).registry()
    tab = mod_engine.lower_tables(plan, sched, reg,
                                  arg_width=mod_engine.PIPE_ARG_WIDTH,
                                  row_access=mod_engine.pipe_row_access)
    return sched, meta, plan, tab


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def both(request):
    S, M = request.param
    return (S, M), (lowered(jpipe, jexec, jengine, S, M),
                    lowered(pipe, pexec, engine, S, M))


# ---------------------------------------------------------------------------
# structure, array for array
# ---------------------------------------------------------------------------

def test_graph_matches_reference(both):
    _, ((js, jmeta, _, _), (s, meta, _, _)) = both
    assert streams(s) == streams(js)
    assert meta == jmeta


@pytest.mark.parametrize("kw", [dict(max_in_flight=2), dict()],
                         ids=["window2", "unthrottled"])
def test_graph_options_match_reference(kw):
    ours, _ = pipe.build_pipeline_graph(4, 8, 1.0, 2.5, 0.25, **kw)
    theirs, _ = jpipe.build_pipeline_graph(4, 8, 1.0, 2.5, 0.25, **kw)
    assert streams(ours) == streams(theirs)


def test_plan_and_tables_match_reference(both):
    (S, M), ((_, _, jplan, jtab), (_, _, plan, tab)) = both
    assert plan_rounds(plan) == plan_rounds(jplan)
    assert plan.structural_hash == jplan.structural_hash
    for f in TABLE_FIELDS:
        assert np.array_equal(getattr(tab, f), getattr(jtab, f)), f
    assert tab.stats == jtab.stats
    if (S, M) == (8, 64):   # the reference bench's full schedule
        assert (tab.nr_items, tab.nr_rounds, tab.nr_phases) == (1032, 143,
                                                               143)
        assert np.diff(tab.phase_offsets).max() == 8


@pytest.mark.parametrize("S,M", SHAPES)
def test_schedule_matches_reference(S, M):
    ours = pipe.synthesize_schedule(S, M, per_stage_window=True)
    theirs = jpipe.synthesize_schedule(S, M, per_stage_window=True)
    assert ours.lanes == theirs.lanes
    assert (ours.makespan, ours.work_time) == (theirs.makespan,
                                               theirs.work_time)
    assert pipe.bubble_fraction(ours) == jpipe.bubble_fraction(theirs)
    assert (pipe.one_f_one_b_bubble(S, M)
            == jpipe.one_f_one_b_bubble(S, M))


def test_simulate_qr_graph_matches_reference():
    def run(mod_qr, sim):
        s, _ = mod_qr.make_qr_graph(5, 4, nr_queues=3)
        res = sim(s, 3, overhead=0.01)
        return ([(e.tid, e.worker, e.t0, e.t1, e.type) for e in res.timeline],
                res.makespan, res.busy, res.per_type_cost, res.steals,
                res.gettask_calls, res.overhead_time)

    assert run(qr, simulate) == run(jqr, jsimulate)
    curve = scaling_curve(lambda n: qr.make_qr_graph(4, 4, nr_queues=n)[0],
                          [1, 2, 4])
    assert curve == jscaling_curve(
        lambda n: jqr.make_qr_graph(4, 4, nr_queues=n)[0], [1, 2, 4])


# ---------------------------------------------------------------------------
# numbers: the four modes against the reference
# ---------------------------------------------------------------------------

def inputs(S, M, Bt, D, seed):
    rng = np.random.default_rng(seed)
    params = [{"w": (rng.standard_normal((D, D)) * 0.3).astype(np.float32),
               "b": (rng.standard_normal(D) * 0.1).astype(np.float32)}
              for _ in range(S)]
    micro = [{"x": rng.standard_normal((Bt, D)).astype(np.float32),
              "y": rng.standard_normal((Bt, D)).astype(np.float32)}
             for _ in range(M)]
    return params, micro


def jax_monolithic(params, micro):
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    jm = [{k: jnp.asarray(v) for k, v in mb.items()} for mb in micro]

    def loss(ps):
        total = 0.0
        for mb in jm:
            h = mb["x"]
            for p in ps:
                h = jexec.dense_stage(p, h)
            total = total + jexec.mse_loss(h, mb)
        return total / len(jm)

    value, grads = jax.value_and_grad(loss)(jp)
    return float(value), grads


def held(loss, grads, want_loss, want_grads):
    assert abs(float(loss) - want_loss) < LOSS_TOL
    for g, w in zip(grads, want_grads):
        for k in ("w", "b"):
            assert_allclose(g[k].numpy(), np.asarray(w[k]), **GRAD_TOL)


@pytest.fixture(scope="module")
def case():
    S, M, Bt, D = 3, 6, 4, 8       # the reference's pipe_case widths
    params, micro = inputs(S, M, Bt, D, seed=2)
    jl, jg = jexec.pipelined_value_and_grad_plan(
        [jexec.dense_stage] * S, jexec.mse_loss,
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        [{k: jnp.asarray(v) for k, v in mb.items()} for mb in micro],
        mode="rounds")
    return S, M, params, micro, (float(jl), jg), jax_monolithic(params,
                                                                micro)


@pytest.mark.parametrize("mode", MODES)
def test_modes_match_reference_and_monolithic(case, mode):
    S, M, params, micro, (jl, jg), (ml, mg) = case
    tp, tm = pipe.pipeline_inputs(params, micro, device="cpu")
    pw_kernel.reset_counts()
    loss, grads = pipe.pipelined_value_and_grad_plan(
        [pipe.dense_stage] * S, pipe.mse_loss, tp, tm, mode=mode,
        device="cpu")
    held(loss, grads, jl, jg)
    held(loss, grads, ml, mg)
    assert pw_kernel.PLAIN_CALLS["pipe_walk"] == (mode == "engine")
    assert pw_kernel.LAUNCHES["pipe_walk"] == 0


def test_schedule_replay_matches_reference(case):
    S, M, params, micro, _, (ml, mg) = case
    tp, tm = pipe.pipeline_inputs(params, micro, device="cpu")
    sched = pipe.synthesize_schedule(S, M)
    loss, grads = pipe.pipelined_value_and_grad(
        [pipe.dense_stage] * S, pipe.mse_loss, tp, tm, sched, device="cpu")
    jl, jg = jexec.pipelined_value_and_grad(
        [jexec.dense_stage] * S, jexec.mse_loss,
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        [{k: jnp.asarray(v) for k, v in mb.items()} for mb in micro],
        jpipe.synthesize_schedule(S, M))
    held(loss, grads, float(jl), jg)
    held(loss, grads, ml, mg)


@pytest.mark.parametrize("S,M,Bt,D", [(1, 3, 4, 8), (3, 1, 4, 8),
                                      (2, 3, 1, 8), (2, 3, 3, 40)],
                         ids=["S1", "M1", "Bt1", "D40"])
def test_edge_shapes_match_monolithic(S, M, Bt, D):
    params, micro = inputs(S, M, Bt, D, seed=S + M + Bt + D)
    ml, mg = jax_monolithic(params, micro)
    tp, tm = pipe.pipeline_inputs(params, micro, device="cpu")
    for mode in ("rounds", "engine"):
        loss, grads = pipe.pipelined_value_and_grad_plan(
            [pipe.dense_stage] * S, pipe.mse_loss, tp, tm, mode=mode,
            device="cpu")
        held(loss, grads, ml, mg)


def test_engine_is_deterministic(case):
    S, M, params, micro, _, _ = case
    tp, tm = pipe.pipeline_inputs(params, micro, device="cpu")
    runs = [pipe.pipelined_value_and_grad_plan(
        [pipe.dense_stage] * S, pipe.mse_loss, tp, tm, mode="engine",
        device="cpu") for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for g0, g1 in zip(runs[0][1], runs[1][1]):
        assert torch.equal(g0["w"], g1["w"]) and torch.equal(g0["b"],
                                                              g1["b"])


# ---------------------------------------------------------------------------
# the plain walk row by row, and the CUDA walk's host side
# ---------------------------------------------------------------------------

def walk_state(S, M, Bt, D, seed):
    params, micro = inputs(S, M, Bt, D, seed)
    statics = tuple(torch.tensor(np.stack([t[k] for t in trees]))
                    for trees, k in ((params, "w"), (params, "b"),
                                     (micro, "x"), (micro, "y")))
    buffers = (torch.zeros(S * M, Bt, D), torch.zeros(S * M, Bt, D),
               torch.zeros(S, D, D), torch.zeros(S, D), torch.zeros(M, 1))
    return statics, buffers


def row_f64(row, statics, buffers, inv_m):
    """One row recomputed in float64 from the float32 state: the buffers it
    writes, as {name: (index, value)}."""
    et, s, m, a_in, a_out, first, last = (int(v) for v in row[:7])
    w, b, x, y = (t.double().numpy() for t in statics)
    acts, cots, gw, gb, _ = (t.double().numpy() for t in buffers)
    inp = x[m] if first else acts[a_in]
    if et == engine.PIPE_F:
        h = np.tanh(inp @ w[s] + b[s])
        out = {"acts": (a_out, h)}
        if last:
            diff = h - y[m]
            out["loss"] = (m, np.array([np.mean(diff * diff)]))
            out["cots"] = (a_out, 2.0 * diff / diff.size)
        return out
    if et == engine.PIPE_B:
        h = acts[a_out]
        g = cots[a_out] * (1.0 - h * h)
        out = {"gw": (s, gw[s] + inp.T @ g), "gb": (s, gb[s] + g.sum(0))}
        if not first:
            out["cots"] = (a_in, g @ w[s].T)
        return out
    return {"gw": (s, gw[s] * inv_m), "gb": (s, gb[s] * inv_m)}


@pytest.mark.parametrize("S,M,Bt,D", [(3, 6, 4, 8), (1, 2, 1, 40)],
                         ids=["3x6", "S1"])
def test_plain_walk_rows_match_float64(S, M, Bt, D):
    _, _, _, tab = lowered(pipe, pexec, engine, S, M)
    statics, buffers = walk_state(S, M, Bt, D, seed=7)
    names = ("acts", "cots", "gw", "gb", "loss")
    for q, row in enumerate(tab.desc):
        want = row_f64(row, statics, buffers, 1.0 / M)
        before = [t.clone() for t in buffers]
        engine.pipe_walk_plain(tab.desc, (q, q + 1), statics, buffers,
                               1.0 / M)
        for name, buf, old in zip(names, buffers, before):
            if name in want:
                idx, val = want[name]
                assert_allclose(buf[idx].double().numpy(), val, **GRAD_TOL,
                                err_msg=f"row {q} {row.tolist()} {name}")
                buf, old = buf.clone(), old.clone()
                buf[idx] = old[idx] = 0
            assert torch.equal(buf, old), f"row {q} wrote {name}"


def test_tile_offsets_count_each_rows_tiles():
    _, _, _, tab = lowered(pipe, pexec, engine, 8, 64)
    bt, dim = 32, 2048
    offs = pw_kernel.tile_offsets(tab.desc, bt, dim)
    n = np.diff(offs.astype(np.int64))
    ntf = pw_kernel.f_tiles(bt, dim) * pw_kernel.k_splits(dim)
    ngw, nu = pw_kernel.gw_tiles(dim), pw_kernel.u_tiles(dim)
    assert ntf == 8 * 4 and ngw == 32 * 16 and nu == 512
    et, first = tab.desc[:, 0], tab.desc[:, 5] > 0
    assert (n[et == engine.PIPE_F] == ntf).all()
    assert (n[(et == engine.PIPE_B) & first] == ngw).all()
    assert (n[(et == engine.PIPE_B) & ~first] == ngw + ntf).all()
    assert (n[et == engine.PIPE_U] == nu).all()
    assert offs.dtype == np.int32 and offs[0] == 0
    assert pw_kernel.f_tiles(1, 40) == 1 and pw_kernel.f_tiles(33, 65) == 2
    assert pw_kernel.f_tiles(33, 257) == 4
    assert pw_kernel.k_splits(40) == 1 and pw_kernel.k_splits(513) == 2
    assert pw_kernel.k_splits(512) == 1
    assert pw_kernel.gw_tiles(65) == 2 and pw_kernel.u_tiles(91) == 2
    noop = np.array([[engine.PIPE_NOOP, 0, 0, 0, 0, 0, 0]], np.int32)
    assert pw_kernel.tile_offsets(noop, bt, dim).tolist() == [0, 0]


def walk_work(work):
    """What the one launch does with a work list, as the kernel finds it:
    per phase, each tile t's segment by a binary search over the segment
    offsets; returns [(phase, row, kind, slot, tile in its segment)]."""
    done = []
    for p in range(len(work.phase_segs) - 1):
        s0, s1 = int(work.phase_segs[p]), int(work.phase_segs[p + 1])
        for t in range(int(work.seg_offs[s0]), int(work.seg_offs[s1])):
            lo, hi = s0, s1
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if work.seg_offs[mid] <= t:
                    lo = mid
                else:
                    hi = mid
            row, kind, slot = (int(v) for v in work.segs[lo])
            done.append((p, row, kind, slot, t - int(work.seg_offs[lo])))
    return done


@pytest.mark.parametrize("S,M,bt,dim", [(8, 64, 32, 2048), (3, 6, 33, 65),
                                        (1, 2, 1, 40)],
                         ids=["full", "ragged", "S1"])
def test_work_list_walks_every_tile_once_longest_first(S, M, bt, dim):
    """The host's work list for the one-launch walk: every row's tiles
    once, in the phase that holds the row, each phase's segments in the
    order COT, F, GW, U (rows in table order within a kind), slots the
    rows' places in their phases, empty phases dropped; the launch's grid
    and scratch bounds are the longest phase's tiles and rows."""
    _, _, _, tab = lowered(pipe, pexec, engine, S, M)
    bounds = [int(b) for b in tab.phase_offsets]
    work = pw_kernel.work_list(tab.desc, bounds, bt, dim)
    done = walk_work(work)
    offs = pw_kernel.tile_offsets(tab.desc, bt, dim)
    per_row = np.bincount([d[1] for d in done], minlength=len(tab.desc))
    assert per_row.tolist() == np.diff(offs).tolist()
    assert len(set(d[1:3] + d[4:] for d in done)) == len(done)
    live = [p for p in range(len(bounds) - 1)
            if offs[bounds[p + 1]] > offs[bounds[p]]]
    assert len(work.phase_segs) - 1 == len(live)
    tiles = {p: 0 for p in range(len(live))}
    for p, row, kind, slot, _ in done:
        q0, q1 = bounds[live[p]], bounds[live[p] + 1]
        assert q0 <= row < q1 and slot == row - q0
        tiles[p] += 1
    for p in range(len(live)):
        s0, s1 = work.phase_segs[p], work.phase_segs[p + 1]
        keys = [(k, r) for r, k, _ in work.segs[s0:s1].tolist()]
        assert keys == sorted(keys)
    et, first = tab.desc[:, 0], tab.desc[:, 5] > 0
    want_kinds = {(q, k) for q in range(len(et)) for k, hit in (
        (pw_kernel.SEG_COT, et[q] == engine.PIPE_B and not first[q]),
        (pw_kernel.SEG_F, et[q] == engine.PIPE_F),
        (pw_kernel.SEG_GW, et[q] == engine.PIPE_B),
        (pw_kernel.SEG_U, et[q] == engine.PIPE_U)) if hit}
    assert {(int(r), int(k)) for r, k, _ in work.segs} == want_kinds
    assert work.max_tiles == max(tiles.values())
    assert work.max_rows == max(np.diff(bounds))
    assert work.segs.dtype == work.seg_offs.dtype == np.int32


def test_work_list_takes_a_range_of_phases():
    """A phase range of the table (as a caller walking part of a plan
    passes it) gives only those phases' rows; no phase, no work."""
    _, _, _, tab = lowered(pipe, pexec, engine, 3, 6)
    bounds = [int(b) for b in tab.phase_offsets]
    part = pw_kernel.work_list(tab.desc, bounds[2:5], 4, 8)
    rows = {r for _, r, _, _, _ in walk_work(part)}
    assert rows == set(range(bounds[2], bounds[4]))
    none = pw_kernel.work_list(tab.desc, (3, 3), 4, 8)
    assert none.max_tiles == 0 and len(none.phase_segs) == 1
    scratch = pw_kernel.scratch(18, 6, part.max_rows, 33, 513, "cpu")
    assert [tuple(t.shape) for t in scratch] == [
        (18, 33, 513), (6, 6), (6,), (part.max_rows, 2, 6, 32 * 256),
        (part.max_rows, 6)]
    assert not scratch[2].any() and not scratch[4].any()


def test_round_fn_refuses_out_of_range_rows():
    _, _, _, tab = lowered(pipe, pexec, engine, 3, 6)
    statics, buffers = walk_state(3, 6, 4, 8, seed=1)
    bad = tab.desc.copy()
    bad[0, 4] = 3 * 6                     # an out_slot past the slabs
    fn = engine.pipe_round_fn(1.0 / 6)
    with pytest.raises(ValueError, match="column 4"):
        fn(torch.as_tensor(bad), tuple(tab.phase_offsets), statics, buffers)
    with pytest.raises(ValueError, match="phase bounds"):
        fn(torch.as_tensor(tab.desc), (0, len(tab.desc) + 1), statics,
           buffers)


def test_row_access_matches_reference():
    _, _, _, tab = lowered(pipe, pexec, engine, 4, 8)
    for row in tab.desc.tolist():
        assert engine.pipe_row_access(row) == jengine.pipe_row_access(row)


# ---------------------------------------------------------------------------
# rejections and the device default
# ---------------------------------------------------------------------------

def test_engine_rejects_non_canonical_family(case):
    S, M, params, micro, _, _ = case
    tp, tm = pipe.pipeline_inputs(params, micro, device="cpu")

    def other_stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    with pytest.raises(BackendUnsupported, match="canonical dense"):
        pipe.pipelined_value_and_grad_plan(
            [other_stage] * S, pipe.mse_loss, tp, tm, mode="engine",
            device="cpu")
    # the host modes run any stage function
    loss, _ = pipe.pipelined_value_and_grad_plan(
        [other_stage] * S, pipe.mse_loss, tp, tm, mode="rounds",
        device="cpu")
    assert abs(float(loss) - case[5][0]) < LOSS_TOL


def test_engine_rejects_mismatched_param_count(case):
    S, M, params, micro, _, _ = case
    tp, tm = pipe.pipeline_inputs(params, micro, device="cpu")
    with pytest.raises(BackendUnsupported, match="canonical dense"):
        pipe.pipelined_value_and_grad_plan(
            [pipe.dense_stage] * S, pipe.mse_loss, tp[:-1], tm,
            mode="engine", device="cpu")


def test_unknown_event_kind_raises_and_updates_are_noops(case):
    S, M, params, micro, _, (ml, _) = case
    tp, tm = pipe.pipeline_inputs(params, micro, device="cpu")
    ps = pipe.synthesize_schedule(S, M)
    assert any(kind == "U" for lane in ps.lanes for kind, *_ in lane)
    loss, _ = pipe.pipelined_value_and_grad(
        [pipe.dense_stage] * S, pipe.mse_loss, tp, tm, ps, device="cpu")
    assert abs(float(loss) - ml) < LOSS_TOL
    ps.lanes[0].insert(0, ("Z", 0, 0, -1.0, -0.5))
    with pytest.raises(ValueError, match="unknown pipeline event"):
        pipe.pipelined_value_and_grad(
            [pipe.dense_stage] * S, pipe.mse_loss, tp, tm, ps, device="cpu")


def test_inputs_are_float32_on_the_device_asked_for(case):
    _, _, params, micro, _, _ = case
    tp, tm = pipe.pipeline_inputs(
        [{k: v.astype(np.float64) for k, v in p.items()} for p in params],
        micro, device="cpu")
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for tree in tp + tm for t in tree.values())
    assert np.array_equal(tp[0]["w"].numpy(), params[0]["w"])


def test_device_defaults_to_cuda_and_raises_without_card(case):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    S, M, params, micro, _, _ = case
    pw_kernel.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        pipe.pipeline_inputs(params, micro)
    tp, tm = pipe.pipeline_inputs(params, micro, device="cpu")
    for mode in ("rounds", "engine"):
        with pytest.raises(RuntimeError, match="CUDA"):
            pipe.pipelined_value_and_grad_plan(
                [pipe.dense_stage] * S, pipe.mse_loss, tp, tm, mode=mode)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipe.pipelined_value_and_grad(
            [pipe.dense_stage] * S, pipe.mse_loss, tp, tm,
            pipe.synthesize_schedule(S, M))
    assert pw_kernel.PLAIN_CALLS["pipe_walk"] == 0
