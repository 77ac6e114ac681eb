"""Task-based tiled QR decomposition (paper §4.1, Buttari et al. 2009):
the port of ``repro/apps/qr.py``.

Four task types on an ``mt × nt`` grid of (b,b) tiles, ``min(mt,nt)``
levels.  Dependency structure follows the paper's §4.1 table (the fully
deterministic variant):

  | task    | where        | depends on                          | locks        | uses          |
  | DGEQRF  | i=j=k        | (i,j,k-1)                           | (k,k)        |               |
  | DLARFT  | i=k, j>k     | (i,j,k-1), (k,k,k)                  |              | (k,k), (k,j)  |
  | DTSQRF  | i>k, j=k     | (i,j,k-1), (i-1,j,k)                | (i,k), (k,k) |               |
  | DSSRFT  | i>k, j>k     | (i,j,k-1), (i-1,j,k), (i,k,k)       | (i,j), (k,j) | (i,k)         |

Tiles are resources, initially assigned to queues in column-major order.
``make_qr_graph``, ``make_qr_graph_loop``, ``paper_counts`` and the graph
half of ``dispatch_counts`` are copies of the reference (the parity tests
assert identical streams).

Execution modes, all dispatched through the port's backend registry
(``core/backends.py``) — this module contains no mode branching:
  * ``sequential`` — SequentialExecutor drains the scheduler in priority
    order, one tile-op launch per task;
  * ``rounds``     — the shared ExecutionPlan lowering: conflict-free
    rounds whose LARFT/SSRFT groups run as one batched launch over stacked
    tiles (the reference's vmap);
  * ``engine``     — the plan lowers to the ragged task table and the QR
    walk kernel runs it in one cooperative launch, a grid-wide barrier
    between write-colored phases, over a (ntiles, b, b) tile stack
    updated in place;
  * ``threaded``   — the paper's thread pool; on a card every worker
    launches on the caller's stream.

Tiles are torch tensors on one device: the ops launch the CUDA kernels
for CUDA tensors and run the plain versions for CPU tensors
(``kernels/qr_tile/ops.py``).  Where the reference rebuilt immutable
tiles, the port rebinds the dict entries to new tensors (host modes) or
updates the tile stack in place (engine).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import engine, resolve_device
from repro_torch.core import BatchSpec, EngineHooks, QSched, lower, run_plan
from repro_torch.kernels.qr_tile import ops

T_GEQRF, T_LARFT, T_TSQRF, T_SSRFT = range(4)
TASK_NAMES = {T_GEQRF: "DGEQRF", T_LARFT: "DLARFT",
              T_TSQRF: "DTSQRF", T_SSRFT: "DSSRFT"}
# relative costs from the paper's Fig 14 addtask calls
COSTS = {T_GEQRF: 2.0, T_LARFT: 3.0, T_TSQRF: 3.0, T_SSRFT: 5.0}


def _add_resources(s: QSched, mt: int, nt: int,
                   nr_queues: int) -> Dict[Tuple[int, int], int]:
    ntiles = mt * nt
    rid: Dict[Tuple[int, int], int] = {}
    for j in range(nt):          # column-major initial queue assignment
        for i in range(mt):
            owner = (j * mt + i) * nr_queues // ntiles
            rid[i, j] = s.addres(owner=owner)
    return rid


def make_qr_graph(mt: int, nt: int, nr_queues: int = 1,
                  reown: bool = True) -> Tuple[QSched, Dict[Tuple[int, int], int]]:
    """Build the QuickSched graph for an mt×nt tile grid, one vectorized
    level-k slab at a time (identical id/edge streams to the per-call
    reference ``make_qr_graph_loop``)."""
    s = QSched(nr_queues=nr_queues, reown=reown)
    rid = _add_resources(s, mt, nt, nr_queues)
    # tile (i,j) -> resource id, column-major creation order
    last = np.full((mt, nt), -1, dtype=np.int64)   # tid grid, prev level

    def res(i, j):               # rid[i, j] as index arithmetic
        return j * mt + i

    for k in range(min(mt, nt)):
        nk = nt - k - 1          # DLARFT count (j = k+1..nt-1)
        mk = mt - k - 1          # DTSQRF count (i = k+1..mt-1)
        base = s.nr_tasks
        js = np.arange(k + 1, nt, dtype=np.int64)
        is_ = np.arange(k + 1, mt, dtype=np.int64)
        g_tid = base
        larft = base + 1 + np.arange(nk, dtype=np.int64)
        blk = base + 1 + nk + np.arange(mk, dtype=np.int64)[:, None] * (1 + nk)
        tsqrf = blk[:, 0]                                    # (mk,)
        ssrft = blk + 1 + np.arange(nk, dtype=np.int64)[None, :]   # (mk, nk)

        # tasks, creation order: GEQRF, LARFTs, then per i: TSQRF + SSRFTs
        types = ([T_GEQRF] + [T_LARFT] * nk
                 + ([T_TSQRF] + [T_SSRFT] * nk) * mk)
        costv = ([COSTS[T_GEQRF]] + [COSTS[T_LARFT]] * nk
                 + ([COSTS[T_TSQRF]] + [COSTS[T_SSRFT]] * nk) * mk)
        js_l = js.tolist()
        datas = ([(k, k, k)] + [(k, j, k) for j in js_l]
                 + [d for i in range(k + 1, mt)
                    for d in [(i, k, k)] + [(i, j, k) for j in js_l]])
        s.addtasks(types, costv, datas)

        # dependencies, creation order
        dep_src, dep_dst = [], []
        if k > 0:
            dep_src.append(np.asarray([last[k, k]]))
            dep_dst.append(np.asarray([g_tid]))
        if nk:
            if k > 0:            # per j: (GEQRF, larft_j), (last[k,j], larft_j)
                dep_src.append(np.stack(
                    [np.full(nk, g_tid, np.int64), last[k, k + 1:]],
                    axis=1).ravel())
                dep_dst.append(np.repeat(larft, 2))
            else:
                dep_src.append(np.full(nk, g_tid, np.int64))
                dep_dst.append(larft)
        if mk:
            prev_col0 = np.concatenate(([g_tid], tsqrf[:-1]))  # cur[i-1, k]
            prev_row = (np.vstack([larft[None, :], ssrft[:-1]])
                        if nk else np.empty((mk, 0), np.int64))  # cur[i-1, j]
            if k > 0:
                # per i: [(cur[i-1,k], t), (last[i,k], t)]
                #        + per j [(tsqrf_i, s), (cur[i-1,j], s), (last[i,j], s)]
                a_src = np.stack([prev_col0, last[k + 1:, k]], axis=1)
                b_src = np.stack([np.broadcast_to(tsqrf[:, None], (mk, nk)),
                                  prev_row, last[k + 1:, k + 1:]], axis=2)
                dep_src.append(np.concatenate(
                    [a_src, b_src.reshape(mk, -1)], axis=1).ravel())
                a_dst = np.stack([tsqrf, tsqrf], axis=1)
                dep_dst.append(np.concatenate(
                    [a_dst, np.repeat(ssrft, 3, axis=1)], axis=1).ravel())
            else:
                a_src = prev_col0[:, None]
                b_src = np.stack([np.broadcast_to(tsqrf[:, None], (mk, nk)),
                                  prev_row], axis=2)
                dep_src.append(np.concatenate(
                    [a_src, b_src.reshape(mk, -1)], axis=1).ravel())
                dep_dst.append(np.concatenate(
                    [tsqrf[:, None], np.repeat(ssrft, 2, axis=1)],
                    axis=1).ravel())
        if dep_src:
            s.addunlocks(np.concatenate(dep_src), np.concatenate(dep_dst))

        # locks: (GEQRF, (k,k)); per i: (t, (i,k)), (t, (k,k));
        #        per j: (s, (i,j)), (s, (k,j))
        lock_t = [np.asarray([g_tid])]
        lock_r = [np.asarray([res(k, k)])]
        if mk:
            a_t = np.stack([tsqrf, tsqrf], axis=1)
            a_r = np.stack([res(is_, k), np.full(mk, res(k, k), np.int64)],
                           axis=1)
            b_t = np.repeat(ssrft, 2, axis=1)
            b_r = np.stack([res(is_[:, None], js[None, :]),
                            np.broadcast_to(res(k, js)[None, :], (mk, nk))],
                           axis=2).reshape(mk, -1)
            lock_t.append(np.concatenate([a_t, b_t], axis=1).ravel())
            lock_r.append(np.concatenate([a_r, b_r], axis=1).ravel())
        s.addlocks(np.concatenate(lock_t), np.concatenate(lock_r))

        # uses: per j: (larft_j, (k,k)), (larft_j, (k,j));
        #       per i,j: (ssrft_ij, (i,k))
        if nk:
            use_t = [np.repeat(larft, 2)]
            use_r = [np.stack([np.full(nk, res(k, k), np.int64), res(k, js)],
                              axis=1).ravel()]
            if mk:
                use_t.append(ssrft.ravel())
                use_r.append(np.repeat(res(is_, k), nk))
            s.adduses(np.concatenate(use_t), np.concatenate(use_r))

        # fold this level's tids into the grid for level k+1
        last[k, k] = g_tid
        if nk:
            last[k, k + 1:] = larft
        if mk:
            last[k + 1:, k] = tsqrf
            if nk:
                last[k + 1:, k + 1:] = ssrft
    return s, rid


def make_qr_graph_loop(mt: int, nt: int, nr_queues: int = 1,
                       reown: bool = True) -> Tuple[QSched, Dict[Tuple[int, int], int]]:
    """Reference per-call builder (paper Fig 14 shape) — kept as the oracle
    for the vectorized ``make_qr_graph`` (asserted stream-identical in
    tests) and as readable documentation of the dependency table."""
    s = QSched(nr_queues=nr_queues, reown=reown)
    rid = _add_resources(s, mt, nt, nr_queues)
    tid: Dict[Tuple[int, int], int] = {}
    for k in range(min(mt, nt)):
        t = s.addtask(T_GEQRF, data=(k, k, k), cost=COSTS[T_GEQRF])
        s.addlock(t, rid[k, k])
        if (k, k) in tid:
            s.addunlock(tid[k, k], t)
        tid[k, k] = t
        for j in range(k + 1, nt):
            t = s.addtask(T_LARFT, data=(k, j, k), cost=COSTS[T_LARFT])
            s.adduse(t, rid[k, k])
            s.adduse(t, rid[k, j])
            s.addunlock(tid[k, k], t)
            if (k, j) in tid:
                s.addunlock(tid[k, j], t)
            tid[k, j] = t
        for i in range(k + 1, mt):
            t = s.addtask(T_TSQRF, data=(i, k, k), cost=COSTS[T_TSQRF])
            s.addlock(t, rid[i, k])
            s.addlock(t, rid[k, k])
            s.addunlock(tid[i - 1, k], t)   # chain: serializes R_kk updates
            if (i, k) in tid:
                s.addunlock(tid[i, k], t)
            tid[i, k] = t
            for j in range(k + 1, nt):
                t = s.addtask(T_SSRFT, data=(i, j, k), cost=COSTS[T_SSRFT])
                s.addlock(t, rid[i, j])
                s.addlock(t, rid[k, j])
                s.adduse(t, rid[i, k])
                s.addunlock(tid[i, k], t)       # the DTSQRF whose V2 we apply
                s.addunlock(tid[i - 1, j], t)   # chain: row-k tile update order
                if (i, j) in tid:
                    s.addunlock(tid[i, j], t)
                tid[i, j] = t
    return s, rid


# ----------------------------------------------------------------------------
# numerical execution over tiles
# ----------------------------------------------------------------------------

def _split_tiles(a: torch.Tensor, b: int):
    """Tiles of ``a`` as contiguous clones (a slice of ``a`` would be a view,
    and the in-place paths would then write into the caller's matrix)."""
    m, n = a.shape
    mt, nt = m // b, n // b
    if mt * b != m or nt * b != n:
        raise ValueError(f"matrix {m}x{n} is not a whole number of "
                         f"{b}x{b} tiles")
    return {(i, j): a[i * b:(i + 1) * b, j * b:(j + 1) * b].clone()
            for i in range(mt) for j in range(nt)}, mt, nt


def _assemble_r(tiles, mt, nt, b, dtype, device):
    r = torch.zeros((mt * b, nt * b), dtype=dtype, device=device)
    for i in range(mt):
        for j in range(i, nt):
            t = tiles[i, j] if i < j else torch.triu(tiles[i, j])
            r[i * b:(i + 1) * b, j * b:(j + 1) * b] = t
    return r


class _TileState:
    """Tile dict ``(i, j) -> (b,b) tensor`` plus the T factors of the
    diagonal (``t_diag[k]``) and TS (``t_ts[i, k]``) reflectors, all on one
    device."""

    def __init__(self, tiles: Dict[Tuple[int, int], torch.Tensor]):
        self.tiles = tiles
        self.t_diag: Dict[int, torch.Tensor] = {}
        self.t_ts: Dict[Tuple[int, int], torch.Tensor] = {}
        self.mt = 1 + max(i for i, _ in tiles)
        self.nt = 1 + max(j for _, j in tiles)

    @classmethod
    def from_numpy(cls, tiles: Mapping[Tuple[int, int], np.ndarray],
                   device=None,
                   t_diag: Optional[Mapping[int, np.ndarray]] = None,
                   t_ts: Optional[Mapping[Tuple[int, int], np.ndarray]] = None
                   ) -> "_TileState":
        """State carried across from numpy tiles (for example a reference
        run's tile dict and T factors), as float32 on ``device``."""
        dev = resolve_device(device)

        def put(x):
            return torch.tensor(np.asarray(x), dtype=torch.float32,
                                device=dev)

        state = cls({k: put(v) for k, v in tiles.items()})
        state.t_diag = {k: put(v) for k, v in (t_diag or {}).items()}
        state.t_ts = {k: put(v) for k, v in (t_ts or {}).items()}
        return state

    def exec_task(self, ttype, data):
        i, j, k = data
        tl = self.tiles
        if ttype == T_GEQRF:
            rv, tau, t = ops.geqrf(tl[k, k])
            tl[k, k] = rv
            self.t_diag[k] = t
        elif ttype == T_LARFT:
            tl[k, j] = ops.apply_qt(tl[k, k], self.t_diag[k], tl[k, j])
        elif ttype == T_TSQRF:
            r, v2, tau, t = ops.tsqrf(torch.triu(tl[k, k]), tl[i, k])
            tl[k, k] = torch.triu(r) + torch.tril(tl[k, k], -1)  # keep V below
            tl[i, k] = v2
            self.t_ts[i, k] = t
        elif ttype == T_SSRFT:
            c1, c2 = ops.apply_tsqt(tl[i, k], self.t_ts[i, k],
                                    tl[k, j], tl[i, j])
            tl[k, j] = c1
            tl[i, j] = c2
        else:
            raise ValueError(f"unknown task type {ttype}")

    def batch_registry(self):
        """BatchSpecs for the ExecutionPlan: LARFT/SSRFT groups stack their
        tiles and run one batched launch (one block per tile); GEQRF is
        singular per round and TSQRF batches would mix conflicting
        same-column updates, so both stay per-task.  Each spec also
        carries its engine ``encode`` — the descriptor-row lowering the
        ``engine`` mode walks (task types map to themselves; args are
        column-major tile indices)."""
        tl = self.tiles

        def larft_batch(tids, datas):
            kk = torch.stack([tl[k, k] for (k, j, _) in datas])
            tt = torch.stack([self.t_diag[k] for (k, j, _) in datas])
            cc = torch.stack([tl[k, j] for (k, j, _) in datas])
            out = ops.apply_qt(kk, tt, cc)
            for (k, j, _), o in zip(datas, out):
                tl[k, j] = o

        def ssrft_batch(tids, datas):
            v2 = torch.stack([tl[i, k] for (i, j, k) in datas])
            tt = torch.stack([self.t_ts[i, k] for (i, j, k) in datas])
            c1 = torch.stack([tl[k, j] for (i, j, k) in datas])
            c2 = torch.stack([tl[i, j] for (i, j, k) in datas])
            o1, o2 = ops.apply_tsqt(v2, tt, c1, c2)
            for (i, j, k), x1, x2 in zip(datas, o1, o2):
                tl[k, j] = x1
                tl[i, j] = x2

        def one(ttype):
            return lambda tid, d: self.exec_task(ttype, d)

        mt = self.mt

        def res(i, j):
            return j * mt + i

        def enc_geqrf(tid, d):
            i, j, k = d
            return [(engine.QR_GEQRF, res(k, k))]

        def enc_larft(tid, d):
            i, j, k = d
            return [(engine.QR_LARFT, res(k, k), res(k, j))]

        def enc_tsqrf(tid, d):
            i, j, k = d
            return [(engine.QR_TSQRF, res(k, k), res(i, k))]

        def enc_ssrft(tid, d):
            i, j, k = d
            return [(engine.QR_SSRFT, res(i, k), res(k, j), res(i, j))]

        return {
            T_GEQRF: BatchSpec(run_one=one(T_GEQRF), encode=enc_geqrf),
            T_LARFT: BatchSpec(run_one=one(T_LARFT), run_batch=larft_batch,
                               encode=enc_larft),
            T_TSQRF: BatchSpec(run_one=one(T_TSQRF), encode=enc_tsqrf),
            T_SSRFT: BatchSpec(run_one=one(T_SSRFT), run_batch=ssrft_batch,
                               encode=enc_ssrft),
        }

    def engine_hooks(self) -> EngineHooks:
        """Engine-family hooks for the backend registry: stack the tile
        dict into a (ntiles, b, b) buffer (column-major tile index,
        matching the resource ids), walk it in place, and rebind the tile
        dict to views of the stack."""
        mt, nt = self.mt, self.nt

        def buffers():
            tiles = torch.stack([self.tiles[i, j]
                                 for j in range(nt) for i in range(mt)])
            return tiles, torch.zeros_like(tiles)

        def writeback(out):
            tiles, _ = out
            for j in range(nt):
                for i in range(mt):
                    self.tiles[i, j] = tiles[j * mt + i]

        return EngineHooks(
            arg_width=engine.QR_ARG_WIDTH,
            round_fn=engine.qr_round_fn, statics=tuple,
            buffers=buffers, writeback=writeback,
            row_access=engine.qr_row_access)


def run_qr(a, tile: int = 32, mode: str = "sequential", nr_queues: int = 1,
           device=None):
    """Compute the R factor of ``a`` (a tensor or array, taken as float32)
    with the QuickSched task graph on any registered execution backend.
    Runs on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``).  Returns (R, sched), R a tensor on that device."""
    dev = resolve_device(device)
    a = torch.as_tensor(a, dtype=torch.float32).to(dev)
    tiles, mt, nt = _split_tiles(a, tile)
    sched, _ = make_qr_graph(mt, nt, nr_queues=nr_queues)
    state = _TileState(tiles)
    run_plan(sched, state.batch_registry(), mode,
             nr_workers=max(nr_queues, 1), engine=state.engine_hooks())
    r = _assemble_r(state.tiles, mt, nt, tile, a.dtype, dev)
    return r, sched


def dispatch_counts(a, tile: int = 32, nr_queues: int = 1):
    """(host dispatches of the per-round path, engine walk launches) for
    ``a``'s QR plan.  Only ``a``'s shape is read: no tile is computed and
    no device is touched.  The second figure is one, as the reference's
    (one jitted dispatch): the walk is one cooperative launch a plan."""
    mt, nt = a.shape[0] // tile, a.shape[1] // tile
    sched, _ = make_qr_graph(mt, nt, nr_queues=nr_queues)
    plan = lower(sched, nr_lanes=max(nr_queues, 1))
    state = _TileState({(i, j): torch.empty(0)
                        for i in range(mt) for j in range(nt)})
    host = engine.count_host_dispatches(plan, sched, state.batch_registry())
    return host, engine.ENGINE_DISPATCHES_PER_PLAN


def paper_counts(mt: int = 32, nt: int = 32):
    """Structural counts for the paper's 2048² / 64² benchmark matrix."""
    s, _ = make_qr_graph(mt, nt)
    return {
        "tasks": s.nr_tasks,
        "deps": s.nr_deps,
        "resources": len(s.resources),
        "locks": s.nr_locks,
        "uses": s.nr_uses,
    }
