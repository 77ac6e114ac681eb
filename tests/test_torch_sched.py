"""The port's static scheduling layer on the CPU against the reference:
``core.weights``, ``core.static_sched`` and ``engine.measure_round_times``.

* ``toposort``, ``critical_path_weights`` and ``critical_path_length``
  equal the reference's on seeded random DAGs (exactly: the same Python
  arithmetic), and a cycle raises the same ``ValueError``;
* ``conflict_rounds`` equals the reference's round for round (tasks and
  lanes) on the QR graphs of ``tests/test_plan.py``, on pipeline graphs
  and on random conflicting graphs; ``validate_rounds`` accepts them and
  refuses a round with a conflict or a dependency inside it;
  ``list_schedule``'s makespan equals the reference's;
* twins of ``tests/test_backends.py::TestSimulatorReplay`` on the port's
  CPU engine (the plain walk): the replayed one-worker makespan is the
  sum of the measured round (item) times, within a factor 5 of the fused
  ``execute_plan`` time, and a four-worker replay lies between the
  longest task and the serial sum;
* ``measure_round_times`` leaves the caller's buffers untouched and its
  ``buffers`` equal ``execute_plan``'s bitwise, for QR and for
  Barnes-Hut (walked through each round's launch groups).
"""

import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.pipeline import qsched_pipeline as jpipe  # noqa: E402
from repro.apps import qr as jqr  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.apps import barneshut as bh  # noqa: E402
from repro_torch.apps import qr  # noqa: E402
from repro_torch.pipeline import qsched_pipeline as tpipe  # noqa: E402

# the replay's stated bound (the reference test's): the additive round
# model predicts the fused time within a factor 5 either way
RATIO = (0.2, 5.0)


def random_spec(rng, n_max=40, nres_max=10):
    """A random DAG with hierarchical resources and locks, as plain data
    (``tests/test_plan.py::random_sched``'s draw), so the same graph can
    be built in both packages."""
    n = rng.randint(1, n_max)
    nres = rng.randint(1, nres_max)
    parents = [rng.randrange(-1, r) if r else -1 for r in range(nres)]
    owners = [rng.randrange(-1, 4) for _ in range(nres)]

    def chain(r):
        out = {r}
        while parents[r] != -1:
            r = parents[r]
            out.add(r)
        return out

    costs = [rng.uniform(0.1, 10.0) for _ in range(n)]
    deps = [(i, j) for j in range(1, n)
            for i in rng.sample(range(j), min(j, rng.randint(0, 3)))]
    locks = []
    for i in range(n):
        if rng.random() < 0.7:
            taken = set()
            for r in rng.sample(range(nres), rng.randint(1, min(3, nres))):
                if any(r in chain(q) or q in chain(r) for q in taken):
                    continue
                taken.add(r)
                locks.append((i, r))
    return n, parents, owners, costs, deps, locks


def build(mod, spec):
    n, parents, owners, costs, deps, locks = spec
    s = mod.QSched(nr_queues=4)       # owners are drawn in -1..3
    for p, o in zip(parents, owners):
        s.addres(owner=o, parent=p)
    for i in range(n):
        s.addtask(data=i, cost=costs[i])
    for i, j in deps:
        s.addunlock(i, j)
    for i, r in locks:
        s.addlock(i, r)
    return s


def adjacency(spec):
    n, _, _, costs, deps, _ = spec
    unlocks = [[] for _ in range(n)]
    for i, j in deps:
        unlocks[i].append(j)
    return n, unlocks, costs


def rounds_as_lists(rounds):
    return [(r.tasks, r.lanes) for r in rounds]


# --- weights ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_weights_equal_reference(seed):
    rng = random.Random(seed)
    for _ in range(10):
        n, unlocks, costs = adjacency(random_spec(rng))
        assert tcore.toposort(n, unlocks) == jcore.toposort(n, unlocks)
        assert (tcore.critical_path_weights(n, unlocks, costs)
                == jcore.critical_path_weights(n, unlocks, costs))
        assert (tcore.critical_path_length(n, unlocks, costs)
                == jcore.critical_path_length(n, unlocks, costs))
    assert tcore.critical_path_length(0, [], []) == 0.0


def test_cycle_raises_as_reference():
    unlocks = [[1], [2], [0], []]
    with pytest.raises(ValueError) as want:
        jcore.toposort(4, unlocks)
    with pytest.raises(ValueError) as got:
        tcore.toposort(4, unlocks)
    assert str(got.value) == str(want.value)
    assert "cycle" in str(got.value)


# --- conflict rounds ---------------------------------------------------------------

@pytest.mark.parametrize("lanes", [1, 4, 8])
@pytest.mark.parametrize("mt,nt", [(5, 5), (6, 6), (10, 10)])
def test_conflict_rounds_equal_reference_on_qr(mt, nt, lanes):
    ts, _ = qr.make_qr_graph(mt, nt, nr_queues=lanes)
    js, _ = jqr.make_qr_graph(mt, nt, nr_queues=lanes)
    got = tcore.conflict_rounds(ts, lanes)
    assert rounds_as_lists(got) == rounds_as_lists(
        jcore.conflict_rounds(js, lanes))
    tcore.validate_rounds(ts, got)
    assert (tcore.list_schedule(ts, lanes).makespan
            == jcore.list_schedule(js, lanes).makespan)


@pytest.mark.parametrize("S,M,window", [(3, 6, False), (4, 8, True),
                                        (8, 16, True)])
def test_conflict_rounds_equal_reference_on_pipeline(S, M, window):
    ts, _ = tpipe.build_pipeline_graph(S, M, per_stage_window=window)
    js, _ = jpipe.build_pipeline_graph(S, M, per_stage_window=window)
    got = tcore.conflict_rounds(ts, S)
    assert rounds_as_lists(got) == rounds_as_lists(
        jcore.conflict_rounds(js, S))
    tcore.validate_rounds(ts, got)
    assert (tcore.list_schedule(ts, S).makespan
            == jcore.list_schedule(js, S).makespan)


def test_conflict_rounds_equal_reference_on_random_graphs():
    rng = random.Random(2)
    for case in range(30):
        spec = random_spec(rng)
        lanes = rng.randint(1, 6)
        cap = rng.choice([None, 3])
        ts, js = build(tcore, spec), build(jcore, spec)
        got = tcore.conflict_rounds(ts, lanes, cap)
        assert rounds_as_lists(got) == rounds_as_lists(
            jcore.conflict_rounds(js, lanes, cap)), case
        tcore.validate_rounds(ts, got)
        assert (tcore.list_schedule(ts, lanes).makespan
                == jcore.list_schedule(js, lanes).makespan), case


def test_validate_rounds_refuses_conflicts_and_inner_dependencies():
    s = tcore.QSched()
    r = s.addres()
    a = s.addtask(cost=1.0)
    b = s.addtask(cost=1.0)
    s.addlock(a, r)
    s.addlock(b, r)
    with pytest.raises(AssertionError, match="conflicting"):
        tcore.validate_rounds(s, [tcore.Round([a, b], {0: [a, b]})])
    tcore.validate_rounds(s, tcore.conflict_rounds(s, 2))

    s = tcore.QSched()
    a = s.addtask(cost=1.0)
    b = s.addtask(cost=1.0)
    s.addunlock(a, b)
    with pytest.raises(AssertionError, match="dep"):
        tcore.validate_rounds(s, [tcore.Round([a, b], {0: [a], 1: [b]})])
    with pytest.raises(AssertionError, match="missing"):
        tcore.validate_rounds(s, [tcore.Round([a], {0: [a]})])
    tcore.validate_rounds(s, tcore.conflict_rounds(s, 2))


# --- measured round times and their replay ------------------------------------------

def qr_case(n, b, seed, lanes=4):
    a = torch.as_tensor(np.random.default_rng(seed).standard_normal((n, n)),
                        dtype=torch.float32)
    tiles, mt, nt = qr._split_tiles(a, b)
    sched, _ = qr.make_qr_graph(mt, nt, nr_queues=lanes)
    plan = tcore.lower(sched, lanes)
    state = qr._TileState(dict(tiles))
    tables = engine.lower_tables(plan, sched, state.batch_registry(),
                                 arg_width=engine.QR_ARG_WIDTH,
                                 row_access=engine.qr_row_access)
    stack = torch.stack([tiles[i, j] for j in range(nt) for i in range(mt)])
    return sched, plan, tables, stack


def test_replayed_makespan_predicts_fused_execute():
    """Twin of the reference's test of the same name, on the plain walk:
    the one-worker replay of the measured round times is their sum
    (exact), and it predicts the fused execute within a factor 5."""
    sched, plan, tables, stack = qr_case(96, 32, 0)
    fn = engine.qr_round_fn
    round_times = None
    for _ in range(3):          # elementwise best of 3 absorbs jitter
        times = engine.measure_round_times(
            tables, fn, (), (stack, torch.zeros_like(stack))).round_s
        round_times = (times if round_times is None
                       else [min(a, b) for a, b in zip(round_times, times)])
    assert len(round_times) == plan.nr_rounds
    res = tcore.replay_round_times(sched, plan, round_times, nr_workers=1)
    assert res.makespan == pytest.approx(sum(round_times), rel=1e-9)
    measured = float("inf")
    for _ in range(3):
        bufs = (stack.clone(), torch.zeros_like(stack))
        t0 = time.perf_counter()
        engine.execute_plan(tables, fn, (), bufs)
        measured = min(measured, time.perf_counter() - t0)
    ratio = res.makespan / measured
    assert RATIO[0] <= ratio <= RATIO[1], (
        f"predicted {res.makespan:.4f}s vs measured {measured:.4f}s")


def test_per_item_times_replay_lane_parallel_makespans():
    """Twin of the reference's test of the same name: the one-worker item
    replay is the sum of the item times, and a four-worker replay lies
    between the longest task and the serial sum."""
    sched, _, tables, stack = qr_case(96, 32, 1)
    timings = engine.measure_round_times(
        tables, engine.qr_round_fn, (), (stack, torch.zeros_like(stack)),
        per_item=True)
    assert timings.item_s is not None
    assert len(timings.item_s) == tables.nr_items
    assert (timings.item_s > 0).all()
    serial = tcore.replay_item_times(sched, tables.tids, timings.item_s,
                                     nr_workers=1)
    assert serial.makespan == pytest.approx(float(timings.item_s.sum()),
                                            rel=1e-9)
    par = tcore.replay_item_times(sched, tables.tids, timings.item_s,
                                  nr_workers=4)
    assert par.makespan <= serial.makespan + 1e-12
    per_task = np.zeros(sched.nr_tasks)
    np.add.at(per_task, np.asarray(tables.tids), timings.item_s)
    assert par.makespan >= per_task.max() - 1e-12


def test_measure_leaves_caller_buffers_and_equals_execute_plan():
    _, plan, tables, stack = qr_case(128, 32, 2)
    tmat = torch.zeros_like(stack)
    before = (stack.clone(), tmat.clone())
    timings = engine.measure_round_times(
        tables, engine.qr_round_fn, (), (stack, tmat), per_item=True)
    assert torch.equal(stack, before[0]) and torch.equal(tmat, before[1])
    want = engine.execute_plan(tables, engine.qr_round_fn, (),
                               (stack.clone(), torch.zeros_like(stack)))
    assert len(timings.round_s) == plan.nr_rounds
    for got, w in zip(timings.buffers, want):
        assert torch.equal(got, w)


def test_measure_traces_rounds_and_items():
    """With a tracer installed every timed round is an ``engine.round``
    span and every timed item a task record keyed by its task id."""
    from repro_torch import obs
    _, plan, tables, stack = qr_case(96, 32, 3)
    tr = obs.enable()
    try:
        engine.measure_round_times(tables, engine.qr_round_fn, (),
                                   (stack, torch.zeros_like(stack)),
                                   per_item=True)
    finally:
        obs.disable()
    rounds = [sp for sp in tr.spans if sp.name == "engine.round"]
    assert len(rounds) == plan.nr_rounds
    assert sorted(t.tid for t in tr.tasks) == sorted(tables.tids.tolist())


def test_measure_walks_launch_groups_for_barnes_hut():
    """Barnes-Hut's walk takes launch groups, not phases: with its
    ``row_keys`` each round and each item is cut into launch groups, and
    the rounds pass equals ``execute_plan`` over the whole table's groups
    bitwise; without them the phase schedule is refused."""
    x = np.random.default_rng(3).random((600, 3))
    m = np.random.default_rng(4).random(600) + 0.5
    g = bh.build_graph(bh.Octree(x, m, n_max=32), n_task=128, nr_queues=4)
    st = bh.BHState(g, device="cpu")
    hooks = st.engine_hooks()
    plan = tcore.lower(g.sched, 4)
    tables = engine.lower_tables(plan, g.sched, st.batch_registry(),
                                 arg_width=hooks.arg_width,
                                 row_access=hooks.row_access)
    bufs = hooks.buffers()
    before = [b.clone() for b in bufs]
    timings = engine.measure_round_times(
        tables, hooks.round_fn, hooks.statics(), bufs, per_item=True,
        row_keys=hooks.row_keys)
    assert all(torch.equal(b, w) for b, w in zip(bufs, before))
    assert len(timings.round_s) == tables.nr_rounds
    assert len(timings.item_s) == tables.nr_items
    want = engine.execute_plan(
        tables, hooks.round_fn, hooks.statics(),
        [b.clone() for b in bufs],
        groups=engine.launch_groups(tables, hooks.row_keys))
    for got, w in zip(timings.buffers, want):
        assert torch.equal(got, w)
    with pytest.raises(ValueError, match="launch groups"):
        engine.measure_round_times(tables, hooks.round_fn, hooks.statics(),
                                   bufs)


def test_engine_dispatches_per_plan_is_one_figure():
    assert engine.ENGINE_DISPATCHES_PER_PLAN == 1
    assert engine.QR_LAUNCHES_PER_PLAN is engine.ENGINE_DISPATCHES_PER_PLAN
    assert engine.PIPE_LAUNCHES_PER_PLAN is engine.ENGINE_DISPATCHES_PER_PLAN
    a = np.zeros((128, 128), np.float32)
    assert qr.dispatch_counts(a, 32)[1] == engine.ENGINE_DISPATCHES_PER_PLAN
