"""Port of the scheduler and device-engine lowering for the tiled QR
(``repro_torch.core``, ``repro_torch.engine``) against the reference.

The graph streams, the plan rounds and the ragged task tables must be
identical to ``repro``'s, array for array.  The plain walk is then run on a
table the *reference* lowered (carried across with ``table_from_arrays``)
and held against the reference's ``rounds``-mode tiles: atol 1e-4,
rtol 1e-4, because the two frameworks round the same float32 recurrences
differently (the per-op tolerances of tests/test_kernels_qr.py,
compounded over the levels of a small grid).  The reference's ``engine``
mode is not used: it cannot run on the installed jax (``pl.load``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.apps import qr as jqr  # noqa: E402
from repro.core import lower as jlower  # noqa: E402
from repro.core import run_plan as jrun_plan  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.apps import qr  # noqa: E402
from repro_torch.core import lower  # noqa: E402

GRIDS = [(2, 2), (3, 4), (8, 8)]
TABLE_FIELDS = ("desc", "tids", "round_offsets", "phase_offsets",
                "round_phase_ptr")


def streams(s):
    out = [s._ttype, s._tdata, s._tcost,
           [r.owner for r in s.resources]]
    for x in (s._deps, s._locks, s._uses):
        xa, xb = x.arrays()
        out += [xa.tolist(), xb.tolist()]
    return out


def tables_of(mod_qr, mod_engine, mod_lower, mt, nt, lanes=4):
    s, _ = mod_qr.make_qr_graph(mt, nt, nr_queues=lanes)
    plan = mod_lower(s, lanes)
    reg = mod_qr._TileState({(i, j): None for i in range(mt)
                             for j in range(nt)},
                            *(("pallas",) if mod_qr is jqr else ())
                            ).batch_registry()
    return s, plan, mod_engine.lower_tables(
        plan, s, reg, arg_width=mod_engine.QR_ARG_WIDTH,
        row_access=mod_engine.qr_row_access)


@pytest.mark.parametrize("mt,nt", GRIDS)
def test_graph_streams_match_reference(mt, nt):
    ours = streams(qr.make_qr_graph(mt, nt, nr_queues=3)[0])
    assert ours == streams(jqr.make_qr_graph(mt, nt, nr_queues=3)[0])
    assert ours == streams(qr.make_qr_graph_loop(mt, nt, nr_queues=3)[0])


@pytest.mark.parametrize("mt,nt", GRIDS)
def test_lower_rounds_match_reference(mt, nt):
    ps = lower(qr.make_qr_graph(mt, nt, nr_queues=4)[0], 4, cache=False)
    pj = jlower(jqr.make_qr_graph(mt, nt, nr_queues=4)[0], 4, cache=False)
    assert ps.structural_hash == pj.structural_hash
    assert [r.tids for r in ps.rounds] == [r.tids for r in pj.rounds]
    assert ([[(b.ttype, b.tids) for b in r.batches] for r in ps.rounds]
            == [[(b.ttype, b.tids) for b in r.batches] for r in pj.rounds])
    assert [r.lanes for r in ps.rounds] == [r.lanes for r in pj.rounds]


@pytest.mark.parametrize("mt,nt", GRIDS)
def test_lower_tables_match_reference(mt, nt):
    _, _, ours = tables_of(qr, engine, lower, mt, nt)
    _, _, theirs = tables_of(jqr, jengine, jlower, mt, nt)
    for f in TABLE_FIELDS:
        x, y = getattr(ours, f), getattr(theirs, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert ours.stats == theirs.stats


def test_table_from_arrays_round_trips_and_validates():
    _, _, theirs = tables_of(jqr, jengine, jlower, 3, 4)
    fields = {f: getattr(theirs, f) for f in TABLE_FIELDS}
    t = engine.table_from_arrays(**fields, arg_width=theirs.arg_width,
                                 nr_tasks=theirs.nr_tasks,
                                 structural_hash=theirs.structural_hash)
    assert (t.nr_rounds, t.nr_phases, t.nr_items) == (
        theirs.nr_rounds, theirs.nr_phases, theirs.nr_items)
    for r in range(t.nr_rounds):
        assert np.array_equal(t.round_phases(r), theirs.round_phases(r))
    bad = dict(fields, phase_offsets=fields["phase_offsets"][:-1])
    with pytest.raises(ValueError, match="inconsistent"):
        engine.table_from_arrays(**bad, arg_width=3, nr_tasks=1)
    with pytest.raises(ValueError, match="desc"):
        engine.table_from_arrays(**fields, arg_width=2, nr_tasks=1)


@pytest.mark.parametrize("mt,nt,b", [(3, 4, 8), (4, 4, 16)])
def test_plain_walk_on_reference_table_matches_reference_rounds(mt, nt, b):
    """The port's walk, run on exactly the schedule the reference lowered,
    leaves every tile (R, the stored V and V2) and every T factor where the
    reference's rounds mode leaves them."""
    a = np.random.default_rng(mt * nt + b).standard_normal(
        (mt * b, nt * b)).astype(np.float32)
    jtiles, _, _ = jqr._split_tiles(jnp.asarray(a), b)
    js, jplan, jtables = tables_of(jqr, jengine, jlower, mt, nt)
    jstate = jqr._TileState(dict(jtiles), "pallas")
    jrun_plan(js, jstate.batch_registry(), "rounds", nr_workers=4,
              plan=jplan)

    state = qr._TileState.from_numpy(
        {k: np.asarray(v) for k, v in jtiles.items()}, device="cpu")
    hooks = state.engine_hooks()
    tables = engine.table_from_arrays(
        **{f: getattr(jtables, f) for f in TABLE_FIELDS},
        arg_width=jtables.arg_width, nr_tasks=jtables.nr_tasks)
    tiles, tmat = engine.execute_plan(tables, hooks.round_fn, (),
                                      hooks.buffers())
    hooks.writeback((tiles, tmat))
    tol = dict(atol=1e-4, rtol=1e-4)
    for key, tile in state.tiles.items():
        assert_allclose(tile.numpy(), np.asarray(jstate.tiles[key]),
                        err_msg=f"tile {key}", **tol)
    for k, t in jstate.t_diag.items():
        assert_allclose(tmat[k * mt + k].numpy(), np.asarray(t), **tol)
    for (i, k), t in jstate.t_ts.items():
        assert_allclose(tmat[k * mt + i].numpy(), np.asarray(t), **tol)


def test_tile_state_from_numpy_carries_t_factors():
    b = 4
    tiles = {(i, j): np.full((b, b), i + 10 * j, np.float32)
             for i in range(2) for j in range(3)}
    st = qr._TileState.from_numpy(tiles, device="cpu",
                                  t_diag={0: np.eye(b)},
                                  t_ts={(1, 0): 2 * np.eye(b)})
    assert (st.mt, st.nt, st.tiles[0, 0].device.type) == (2, 3, "cpu")
    assert st.tiles[1, 2].dtype == torch.float32
    assert float(st.tiles[1, 2][0, 0]) == 21.0
    assert torch.equal(st.t_ts[1, 0], 2 * torch.eye(b))
    stack, tmat = st.engine_hooks().buffers()
    assert stack.shape == (6, b, b) and float(stack[3][0, 0]) == 11.0


def test_noop_rows_are_noops():
    """QR_NOOP and any out-of-range type leave the state untouched."""
    g = torch.Generator().manual_seed(0)
    tiles = torch.randn((2, 4, 4), generator=g)
    tmat = torch.randn((2, 4, 4), generator=g)
    before = (tiles.clone(), tmat.clone())
    desc = torch.tensor([[engine.QR_NOOP, 0, 1, 0], [9, 1, 0, 1],
                         [-1, 0, 0, 0]], dtype=torch.int32)
    engine.qr_round_fn(desc, (0, 2, 3), (), (tiles, tmat))
    assert torch.equal(tiles, before[0]) and torch.equal(tmat, before[1])


@pytest.mark.parametrize("desc,bounds", [
    ([[engine.QR_GEQRF, 2, 0, 0]], (0, 1)),        # slot past the stack
    ([[engine.QR_LARFT, 0, -1, 0]], (0, 1)),       # negative slot
    ([[engine.QR_GEQRF, 0, 0, 0]], (0, 2)),        # bounds past the rows
])
def test_walk_refuses_out_of_range_tables(desc, bounds):
    tiles, tmat = torch.zeros((2, 4, 4)), torch.zeros((2, 4, 4))
    with pytest.raises(ValueError):
        engine.qr_round_fn(torch.tensor(desc, dtype=torch.int32), bounds,
                           (), (tiles, tmat))


def test_upload_phases_gives_the_walk_its_schedule():
    """The walk's device schedule: desc and the phase offsets in one int32
    buffer, the offsets ascending from row 0 to the last row, recorded in
    the phases beside the host copy the walk checks."""
    _, _, tab = tables_of(qr, engine, lower, 8, 8)
    desc, phases = engine.upload_phases(tab.desc, tab.phase_offsets, "cpu")
    offs = phases.device_offsets
    assert phases.device_desc is desc
    assert np.array_equal(phases.host_desc, tab.desc)
    assert phases.host_desc.dtype == np.int32
    assert isinstance(phases, tuple) and len(phases) == tab.nr_phases + 1
    assert np.array_equal(desc.numpy(), tab.desc)
    assert offs.dtype == torch.int32 and offs.tolist() == list(phases)
    assert offs.tolist() == [int(b) for b in tab.phase_offsets]
    assert offs[0] == 0 and offs[-1] == tab.nr_items
    assert bool((offs[1:] >= offs[:-1]).all())
    assert desc.untyped_storage().data_ptr() == \
        offs.untyped_storage().data_ptr()     # one upload


@pytest.mark.parametrize("row,bounds", [
    ([engine.QR_GEQRF, 36, 0, 0], (0, 1)),        # slot past the stack
    ([engine.QR_SSRFT, 0, 1, -2], (0, 1)),        # negative slot
    ([engine.QR_GEQRF, 0, 0, 0], (0, 1, 0)),      # bounds not ascending
    ([engine.QR_GEQRF, 0, 0, 0], (0, 2)),         # bounds past the rows
])
def test_host_check_refuses_bad_tables(row, bounds):
    """``check_qr_table`` reads only the host copy: no card, no walk."""
    with pytest.raises(ValueError):
        engine.check_qr_table(np.array([row], dtype=np.int32), bounds, 36)
    engine.check_qr_table(np.array([[engine.QR_GEQRF, 35, 0, 0]],
                                   dtype=np.int32), (0, 1), 36)


def test_execute_plan_checks_the_host_table_before_the_walk():
    """execute_plan hands the walk a table whose range is checked on the
    host before anything is walked; a good table is walked once."""
    from repro_torch.kernels.qr_tile import kernel
    _, _, tab = tables_of(qr, engine, lower, 2, 2)
    _, _, bad = tables_of(qr, engine, lower, 2, 2)
    bad.desc[:, 1] = 9                      # every row's first slot
    tiles, tmat = torch.zeros((4, 4, 4)), torch.zeros((4, 4, 4))
    kernel.reset_counts()
    with pytest.raises(ValueError, match="outside the 4-tile stack"):
        engine.execute_plan(bad, engine.qr_round_fn, (), (tiles, tmat))
    assert kernel.PLAIN_CALLS["qr_walk"] == 0
    assert not tiles.any() and not tmat.any()
    engine.execute_plan(tab, engine.qr_round_fn, (), (tiles, tmat))
    assert kernel.PLAIN_CALLS["qr_walk"] == 1
