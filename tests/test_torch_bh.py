"""Port of the Barnes-Hut tree code (``repro_torch.apps.barneshut``, the BH
part of ``repro_torch.engine``) against the reference, on the CPU.

* Structure: the port's octree, task graph and task tables equal the
  reference's, array for array, on random particles and on a lattice.
* The launch-group pass on real tables: no write key crosses buckets
  within a group, per-destination order is kept, the plain walk in bucket
  order is bitwise the plain walk in table order, and a table that cannot
  be cut is refused.
* The walk's counts: the static the card's walk takes are the tree's leaf
  sizes, and a plain walk cut at them is bitwise the padded plain walk on
  every real particle (the premise of skipping pad sources on the card).
* The slice as a whole: ``solve(device="cpu")`` in all four modes against
  the reference's rounds mode on an 8³ lattice (1e-4 per-particle
  relative, the reference's cross-mode tolerance, tests/test_backends.py),
  against a float64 recomputation of the reference graph's own interaction
  lists (1e-4), against the direct sum in the direct limit (rtol 2e-4,
  atol 1e-5) and within test_barneshut.py's accuracy bounds.

The reference's ``solve`` runs once here (module fixture): its eager jnp
path recompiles for every ragged cell shape.
"""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.apps import barneshut as jbh  # noqa: E402
from repro.core import lower as jlower  # noqa: E402
from repro.kernels.nbody import ref as jref  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.apps import barneshut as bh  # noqa: E402
from repro_torch.core import lower  # noqa: E402
from repro_torch.kernels.nbody import kernel  # noqa: E402
from repro_torch.kernels.nbody import ref as kernel_ref  # noqa: E402

MODES = ("sequential", "threaded", "rounds", "engine")
TABLE_FIELDS = ("desc", "tids", "round_offsets", "phase_offsets",
                "round_phase_ptr")


def cloud(n, seed):
    rng = np.random.default_rng(seed)
    return rng.random((n, 3)), rng.random(n) + 0.5


def lattice(side, seed=None):
    """side³ particles at cell centres; random masses when seeded."""
    g = (np.arange(side) + 0.5) / side
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    m = (np.ones(len(x)) if seed is None
         else np.random.default_rng(seed).random(len(x)) + 0.5)
    return x, m


def rel_err(a, want):
    """Per-particle relative error of (3,N) accelerations."""
    a, want = np.asarray(a, np.float64), np.asarray(want, np.float64)
    num = np.linalg.norm(a - want, axis=0)
    return num / np.maximum(np.linalg.norm(want, axis=0), 1e-12)


def streams(s):
    out = [s._ttype, s._tdata, s._tcost, [r.owner for r in s.resources],
           [r.parent for r in s.resources]]
    for x in (s._deps, s._locks, s._uses):
        xa, xb = x.arrays()
        out += [xa.tolist(), xb.tolist()]
    return out


def both(x, m, n_max, n_task, lanes=4):
    """(reference graph, table), (port graph, table) of one input."""
    out = []
    for mod, eng, low, state in (
            (jbh, jengine, jlower, lambda g: jbh.BHState(g)),
            (bh, engine, lower, lambda g: bh.BHState(g, device="cpu"))):
        g = mod.build_graph(mod.Octree(x, m, n_max=n_max), n_task=n_task,
                            nr_queues=lanes)
        plan = low(g.sched, lanes)
        tab = eng.lower_tables(plan, g.sched, state(g).batch_registry(),
                               arg_width=eng.BH_ARG_WIDTH,
                               row_access=eng.bh_row_access)
        out.append((g, tab))
    return out


CASES = {"cloud2000": (cloud(2000, 21), 32, 128),
         "lattice16": (lattice(16), 64, 256)}


@pytest.fixture(scope="module", params=sorted(CASES))
def lowered(request):
    (x, m), n_max, n_task = CASES[request.param]
    return (x, m, n_max, n_task), both(x, m, n_max, n_task)


# ---------------------------------------------------------------------------
# structure, array for array
# ---------------------------------------------------------------------------

def test_octree_matches_reference(lowered):
    _, ((jg, _), (g, _)) = lowered
    jt, t = jg.tree, g.tree
    assert np.array_equal(t.x, jt.x) and np.array_equal(t.m, jt.m)
    assert len(t.cells) == len(jt.cells)
    for c, jc in zip(t.cells, jt.cells):
        assert (c.start, c.count, c.depth, c.parent, c.split, c.children,
                c.res, c.task_com) == (jc.start, jc.count, jc.depth,
                                       jc.parent, jc.split, jc.children,
                                       jc.res, jc.task_com)
        assert np.array_equal(c.loc, jc.loc) and c.h == jc.h


def test_graph_matches_reference(lowered):
    _, ((jg, _), (g, _)) = lowered
    assert g.counts == jg.counts
    for name in ("self_blocks", "self_pairs", "pair_pairs", "pc_lists",
                 "task_cell"):
        assert getattr(g, name) == getattr(jg, name), name
    assert streams(g.sched) == streams(jg.sched)


def test_tables_match_reference(lowered):
    _, ((_, jtab), (_, tab)) = lowered
    for f in TABLE_FIELDS:
        assert np.array_equal(getattr(tab, f), getattr(jtab, f)), f
    assert tab.stats == jtab.stats


def test_walk_runs_reference_lowered_table(lowered):
    """A table the reference lowered, carried across, walks to the same
    bits as the port's own table."""
    (x, m, n_max, n_task), ((_, jtab), (g, tab)) = lowered
    carried = engine.table_from_arrays(
        **{f: np.asarray(getattr(jtab, f)) for f in TABLE_FIELDS},
        arg_width=jtab.arg_width, nr_tasks=jtab.nr_tasks)
    outs = []
    for t in (carried, tab):
        st = bh.BHState(g, device="cpu")
        hooks = st.engine_hooks()
        outs.append(engine.execute_plan(
            t, hooks.round_fn, hooks.statics(), hooks.buffers(),
            groups=engine.launch_groups(t, engine.bh_row_keys)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the launch-group pass
# ---------------------------------------------------------------------------

def test_row_keys_are_row_access_as_integers(lowered):
    _, (_, (_, tab)) = lowered
    write, reads = engine.bh_row_keys(tab.desc)

    def code(key):
        return 2 * key[1] + (key[0] == "c")

    for q, row in enumerate(tab.desc.tolist()):
        r, w = engine.bh_row_access(row)
        assert [write[q]] == [code(k) for k in w]
        assert sorted(reads[q][reads[q] >= 0]) == sorted(code(k) for k in r)


def test_groups_keep_the_walk_invariant(lowered):
    _, (_, (_, tab)) = lowered
    lg = engine.launch_groups(tab, engine.bh_row_keys)
    order = lg.order
    assert np.array_equal(np.sort(order), np.arange(tab.nr_items))
    assert 1 <= lg.nr_groups <= tab.nr_rounds
    rows = tab.desc.tolist()
    bo, go = lg.bucket_offsets, lg.group_offsets
    seen_before = {}                 # write key -> last table row walked
    for gi in range(lg.nr_groups):
        owner = {}                   # write key -> bucket, in this group
        members = []
        for b in range(go[gi], go[gi + 1]):
            qs = order[bo[b]:bo[b + 1]]
            keys = {engine.bh_row_access(rows[q])[1] for q in qs}
            assert len(keys) == 1    # one write key per bucket
            (key,), = keys
            assert key not in owner
            owner[key] = b
            assert (np.diff(qs) > 0).all()      # table order in a bucket
            assert seen_before.get(key, -1) < qs[0]   # and across groups
            seen_before[key] = qs[-1]
            members += [(b, q) for q in qs]
        for b, q in members:         # nothing crosses buckets in a group
            r_keys, (w,) = engine.bh_row_access(rows[q])
            for k in r_keys:
                assert owner.get(k, b) == b, (q, k)


def test_plain_walk_in_bucket_order_is_bitwise_table_order(lowered):
    _, (_, (g, tab)) = lowered
    lg = engine.launch_groups(tab, engine.bh_row_keys)
    outs = []
    for desc in (tab.desc, tab.desc[lg.order]):
        st = bh.BHState(g, device="cpu")
        hooks = st.engine_hooks()
        xs, ms, _ = hooks.statics()
        acc, com, cmass = hooks.buffers()
        engine.bh_walk_plain(desc, xs, ms, acc, com, cmass, st.eps)
        outs.append((acc, com, cmass))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert outs[0][0].abs().sum() > 0


def test_walk_counts_are_the_leaf_counts(lowered):
    """The counts the walk takes (its third static) are the tree's leaf
    sizes, slot by slot, and the padded blocks hold exactly that many
    massive particles each."""
    _, (_, (g, _)) = lowered
    st = bh.BHState(g, device="cpu")
    xs, ms, counts = st.engine_hooks().statics()
    leaves = [c for c in g.tree.cells if not c.split]
    assert counts.dtype == torch.int32 and counts.shape == (len(leaves),)
    assert counts.tolist() == [c.count for c in leaves]
    assert counts.tolist() == (ms > 0).sum(1).tolist()
    assert int(counts.max()) == xs.shape[2]


def count_limited_walk(desc, xs, ms, counts, acc, com, cmass, eps):
    """The plain walk as the walk on the card runs it: a SELF or PP row
    pulls only its source leaf's real particles on its leaf's real
    targets."""
    for row in torch.as_tensor(desc).tolist():
        et, w = row[0], row[1]
        if et == engine.BH_SELF:
            n = int(counts[w])
            acc[w, :, :n] += kernel_ref.acc_self_ref(xs[w, :, :n],
                                                     ms[w, :n], eps)
        elif et == engine.BH_PP:
            s, n = row[2], int(counts[w])
            ns = int(counts[s])
            acc[w, :, :n] += kernel_ref.acc_pair_ref(
                xs[w, :, :n], xs[s, :, :ns], ms[s, :ns], eps)
        else:
            engine.bh_walk_plain([row], xs, ms, acc, com, cmass, eps)


def test_count_limited_walk_is_bitwise_the_padded_walk(lowered):
    """The premise of the walk on the card skipping pad sources: a pad has
    zero mass at a finite position, so it adds exactly 0, and a walk that
    stops at each leaf's real particles gives every real particle the
    bits the plain walk over the padded blocks gives it.  (cloud2000: 239
    of its 244 leaves hold fewer than the 32 particles of a block; the
    lattice's leaves are all full, so there the two walks are one.)"""
    _, (_, (g, tab)) = lowered
    st = bh.BHState(g, device="cpu")
    hooks = st.engine_hooks()
    xs, ms, counts = hooks.statics()
    padded, limited = hooks.buffers(), hooks.buffers()
    engine.bh_walk_plain(tab.desc, xs, ms, *padded, st.eps)
    count_limited_walk(tab.desc, xs, ms, counts, *limited, st.eps)
    real = torch.arange(xs.shape[2])[None, :] < counts[:, None]
    got, want = limited[0], padded[0]
    assert torch.equal(got.permute(0, 2, 1)[real], want.permute(0, 2, 1)[real])
    assert torch.equal(limited[1], padded[1])
    assert torch.equal(limited[2], padded[2])
    assert want.abs().sum() > 0


def test_bucket_order_takes_each_groups_buckets_longest_first(lowered):
    """The order the walk on the card takes buckets in: every bucket once,
    each inside its own launch group, a group's buckets by decreasing
    length, ties in bucket order."""
    _, (_, (_, tab)) = lowered
    lg = engine.launch_groups(tab, engine.bh_row_keys)
    order = engine.megakernel.bucket_order(lg)
    lengths = np.diff(lg.bucket_offsets)
    go = lg.group_offsets
    assert sorted(order.tolist()) == list(range(lg.nr_buckets))
    for g0, g1 in zip(go[:-1], go[1:]):
        part = order[g0:g1]
        assert ((part >= g0) & (part < g1)).all()
        key = list(zip(-lengths[part], part))
        assert key == sorted(key)


def test_pass_refuses_tables_it_cannot_cut(lowered):
    """One round holding a COM row and the PC rows that read it (a
    cross-bucket read-after-write), or a row without a write key, is
    refused rather than walked."""
    _, (_, (_, tab)) = lowered
    one_round = engine.table_from_arrays(
        desc=tab.desc, tids=tab.tids,
        round_offsets=np.array([0, tab.nr_items]),
        phase_offsets=np.array([0, tab.nr_items]),
        round_phase_ptr=np.array([0, 1]), arg_width=tab.arg_width,
        nr_tasks=tab.nr_tasks)
    with pytest.raises(ValueError, match="no launch group can hold it"):
        engine.launch_groups(one_round, engine.bh_row_keys)
    noop = tab.desc.copy()
    noop[0, 0] = engine.BH_NOOP
    forged = engine.table_from_arrays(
        desc=noop, **{f: getattr(tab, f) for f in TABLE_FIELDS[1:]},
        arg_width=tab.arg_width, nr_tasks=tab.nr_tasks)
    with pytest.raises(ValueError, match="no write key"):
        engine.launch_groups(forged, engine.bh_row_keys)


def test_walk_refuses_out_of_range_rows(lowered):
    _, (_, (g, tab)) = lowered
    st = bh.BHState(g, device="cpu")
    hooks = st.engine_hooks()
    lg = engine.launch_groups(tab, engine.bh_row_keys)
    bad = torch.as_tensor(tab.desc[lg.order].copy())
    pp = int((bad[:, 0] == engine.BH_PP).nonzero()[0, 0])
    bad[pp, 2] = len(st._leaf_slots()[0])       # one past the last leaf
    with pytest.raises(ValueError, match="indexes outside"):
        hooks.round_fn(bad, lg, hooks.statics(), hooks.buffers())


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lattice_case():
    """The reference's rounds mode on an 8³ lattice with random masses
    (uniform leaves, so its eager path compiles few shapes)."""
    x, m = lattice(8, seed=8)
    acc, st, _ = jbh.solve(x, m, n_max=8, n_task=64, backend="ref",
                           mode="rounds")
    return x, m, np.asarray(acc), np.asarray(st.result())


@pytest.mark.parametrize("mode", MODES)
def test_modes_match_reference_rounds(lattice_case, mode):
    x, m, want, _ = lattice_case
    acc, _, _ = bh.solve(x, m, n_max=8, n_task=64, mode=mode, nr_workers=4,
                         device="cpu")
    assert rel_err(acc.numpy(), want).max() < 1e-4


def test_state_result_matches_reference_result(lattice_case):
    """``BHState.result()`` is the accelerations in the tree's sorted
    order, as the reference's: ``acc`` itself, equal to the reference
    state's ``result()`` on the same lattice."""
    x, m, _, want = lattice_case
    _, st, _ = bh.solve(x, m, n_max=8, n_task=64, mode="rounds",
                        device="cpu")
    assert st.result() is st.acc
    assert st.result().shape == want.shape
    assert rel_err(st.result().numpy(), want).max() < 1e-4


def interaction_lists_f64(g, eps=jref.DEFAULT_EPS):
    """Float64 accelerations of the graph's own interaction lists: direct
    self blocks and pairs (both directions) and each leaf's COM sources,
    COMs from float64 prefix sums of the float32 particles."""
    t = g.tree
    x = t.x.astype(np.float32).astype(np.float64)
    m = t.m.astype(np.float32).astype(np.float64)
    acc = np.zeros_like(x)

    def rng(c):
        return slice(t.cells[c].start, t.cells[c].start + t.cells[c].count)

    def pull(xi, xj, mj, self_set=False):
        dx = xj[:, None, :] - xi[:, :, None]
        w = ((dx * dx).sum(0) + eps * eps) ** -1.5 * mj[None, :]
        if self_set:
            np.fill_diagonal(w, 0.0)
        return np.einsum("dij,ij->di", dx, w)

    for cells in g.self_blocks.values():
        for c in cells:
            r = rng(c)
            acc[:, r] += pull(x[:, r], x[:, r], m[r], self_set=True)
    for pairs in list(g.self_pairs.values()) + list(g.pair_pairs.values()):
        for a, b in pairs:
            ra, rb = rng(a), rng(b)
            acc[:, ra] += pull(x[:, ra], x[:, rb], m[rb])
            acc[:, rb] += pull(x[:, rb], x[:, ra], m[ra])
    cm = np.concatenate([[0.0], np.cumsum(m)])
    cxm = np.concatenate([np.zeros((3, 1)), np.cumsum(x * m, 1)], 1)
    for tid, srcs in g.pc_lists.items():
        if not srcs:
            continue
        lo = np.array([t.cells[s].start for s in srcs])
        hi = lo + np.array([t.cells[s].count for s in srcs])
        ms = cm[hi] - cm[lo]
        r = rng(g.task_cell[tid][1])
        acc[:, r] += pull(x[:, r], (cxm[:, hi] - cxm[:, lo]) / ms, ms)
    return acc


@pytest.fixture(scope="module")
def bh_case():
    """The reference's bh_case input (tests/test_backends.py) and the
    float64 sums of the reference graph's interaction lists."""
    x, m = cloud(1200, 3)
    g = jbh.build_graph(jbh.Octree(x, m, n_max=32), n_task=128, nr_queues=4)
    return x, m, interaction_lists_f64(g)


@pytest.mark.parametrize("mode", MODES)
def test_modes_match_float64_interaction_lists(bh_case, mode):
    x, m, want = bh_case
    kernel.reset_counts()
    acc, st, _ = bh.solve(x, m, n_max=32, n_task=128, mode=mode,
                          nr_workers=4, device="cpu")
    assert acc.dtype == torch.float32 and acc.shape == (3, 1200)
    assert rel_err(acc.numpy(), want).max() < 1e-4
    assert all(v == 0 for v in kernel.LAUNCHES.values())
    if mode == "engine":              # one plain walk over the whole plan
        assert kernel.PLAIN_CALLS == {"acc_pair": 0, "acc_self": 0,
                                      "bh_walk": 1}
    else:
        assert kernel.PLAIN_CALLS["acc_pair"] > 0
        assert kernel.PLAIN_CALLS["bh_walk"] == 0


@pytest.mark.parametrize("mode", ["sequential", "engine"])
def test_direct_limit_exact(mode):
    """With n_max >= N the tree is one leaf: a pure direct sum."""
    x, m = cloud(200, 7)
    acc, st, _ = bh.solve(x, m, n_max=256, n_task=512, mode=mode,
                          device="cpu")
    want = jref.acc_direct_ref(jnp.asarray(st.x.numpy()),
                               jnp.asarray(st.m.numpy()))
    assert_allclose(acc.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)


def test_accuracy_vs_direct_sum():
    x, m = cloud(1500, 6)
    acc, st, _ = bh.solve(x, m, n_max=32, n_task=256, mode="engine",
                          device="cpu")
    exact = jref.acc_direct_ref(jnp.asarray(st.x.numpy()),
                                jnp.asarray(st.m.numpy()))
    rel = rel_err(acc.numpy(), exact)
    assert np.median(rel) < 2e-2 and rel.mean() < 5e-2


def test_engine_writeback_restores_sorted_order():
    """The padded leaf blocks scatter back with one index: an engine run's
    COM rows equal the sequential mode's and acc has no pad left in it."""
    x, m = cloud(700, 11)
    _, seq, _ = bh.solve(x, m, n_max=24, n_task=96, device="cpu")
    _, eng, _ = bh.solve(x, m, n_max=24, n_task=96, mode="engine",
                         device="cpu")
    assert eng.acc.shape == seq.acc.shape
    assert_allclose(eng.com.numpy(), seq.com.numpy(), rtol=1e-6, atol=1e-7)
    assert_allclose(eng.cmass.numpy(), seq.cmass.numpy(), rtol=1e-6)
    assert rel_err(eng.acc.numpy(), seq.acc.numpy()).max() < 1e-4


def test_threaded_locks_alone_prevent_lost_updates():
    """16 workers, more than the cores, with a 1 µs switch interval, add in
    place into one shared ``acc``; only the hierarchical resource locks
    keep their ``+=`` apart.  Every task body records the cells it locks
    and waits a little inside them, so two tasks whose cells nest (or
    coincide) running at once would show here, and a lost update would
    break the match with the sequential mode."""
    x, m = cloud(1200, 9)
    want, _, _ = bh.solve(x, m, n_max=32, n_task=128, device="cpu")
    g = bh.build_graph(bh.Octree(x, m, n_max=32), n_task=128, nr_queues=16)
    st = bh.BHState(g, device="cpu")
    cells = g.tree.cells

    def line(c):                     # c and its ancestors
        out = set()
        while c != -1:
            out.add(c)
            c = cells[c].parent
        return out

    held, clashes, guard = [], [], threading.Lock()
    body = st.exec_task

    def exec_task(ttype, data, tid=-1):
        mine = [(c, line(c)) for c in g.task_cell.get(tid, ())[1:]]
        with guard:
            clashes.extend((tid, h) for h, h_line in held
                           for c, c_line in mine
                           if h in c_line or c in h_line)
            held.extend(mine)
        time.sleep(2e-4)
        try:
            body(ttype, data, tid)
        finally:
            with guard:
                for e in mine:
                    held.remove(e)

    st.exec_task = exec_task
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run = threading.Thread(target=lambda: st.run("threaded",
                                                     nr_workers=16))
        run.start()
        run.join(timeout=120)
        assert not run.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not clashes, clashes[:4]
    assert rel_err(st.acc.numpy(), want.numpy()).max() < 1e-4
