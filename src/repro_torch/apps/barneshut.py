"""Task-based Barnes-Hut tree code (paper §4.2): the port of
``repro/apps/barneshut.py``.

Particles are sorted hierarchically so every cell owns a *contiguous* slice
of the global particle array (paper Fig 10) — cells at every level can hand
their particle block straight to a kernel.  Cells are *hierarchical
resources* (cell.res.parent = parent cell's res), so a task locking a cell
conflicts with tasks locking any ancestor or descendant — exactly the
write-set semantics of force accumulation.

Task types (paper Fig 16 + §4.2):
  * ``T_SELF``  — all pairwise interactions inside one task-stop cell;
                  locks the cell.
  * ``T_PAIR``  — interactions spanning two neighbouring cells; locks both.
  * ``T_PC``    — particle-cell (centre-of-mass) interactions for one
                  *leaf* cell; locks the leaf.
  * ``T_COM``   — centre-of-mass of one cell; children's COM tasks unlock
                  the parent's (bottom-up); every T_PC depends on the root
                  COM.

``Cell``, ``Octree``, ``BHGraph``, ``build_graph``, the ``T_*`` types and
``TASK_NAMES`` are copies of the reference: the port sorts the caller's
numpy particles into exactly the reference's order and builds the same
graph, task for task (tested array for array).

Execution modes, all dispatched through the port's backend registry
(``core/backends.py``) — this module contains no mode branching:
  * ``sequential`` — SequentialExecutor drains the scheduler in priority
    order, one interaction launch per cell block (``kernels/nbody/ops``);
  * ``rounds``     — the shared ExecutionPlan lowering: bulk-synchronous
    conflict-free rounds, every task on its own (cell blocks are ragged);
  * ``engine``     — tasks expand into direct-interaction work items over
    zero-mass-padded leaf blocks, the plan lowers to a task table, and the
    Barnes-Hut walk kernel runs it, one launch per launch group
    (``engine.descriptors.launch_groups``);
  * ``threaded``   — the paper's thread pool: workers add in place into
    the one shared ``acc`` tensor, and the hierarchical resource locks are
    the only thing that prevents lost ``+=`` updates.  On a card every
    worker launches on the caller's stream.

Every mode adds in place into one ``acc`` tensor on the run's device, so
the reference's ``accumulate="jnp"|"numpy"`` switch has no counterpart,
and its ``backend="ref"|"pallas"`` switch is the tensors' device: the ops
launch the CUDA kernels for CUDA tensors and run the plain versions for
CPU tensors.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import engine, resolve_device
from repro_torch.core import BatchSpec, EngineHooks, QSched, run_plan
from repro_torch.kernels.nbody import ops
from repro_torch.kernels.nbody.ref import DEFAULT_EPS

T_SELF, T_PAIR, T_PC, T_COM = range(4)
TASK_NAMES = {T_SELF: "self", T_PAIR: "pair_pp", T_PC: "pair_pc",
              T_COM: "com"}


@dataclass
class Cell:
    cid: int
    loc: np.ndarray          # lower corner (3,)
    h: float                 # edge length (cubic cells)
    start: int               # first particle index (contiguous block)
    count: int
    depth: int
    parent: int = -1
    split: bool = False
    children: List[int] = field(default_factory=list)
    res: int = -1
    task_com: int = -1


class Octree:
    """Recursive octree with hierarchical particle sort (paper Fig 10)."""

    def __init__(self, x: np.ndarray, m: np.ndarray, n_max: int = 100):
        assert x.shape[1] == 3
        self.n = x.shape[0]
        self.n_max = n_max
        self.x = np.array(x, dtype=np.float64)
        self.m = np.array(m, dtype=np.float64)
        self.cells: List[Cell] = []
        lo = self.x.min(axis=0)
        width = float((self.x.max(axis=0) - lo).max()) * (1 + 1e-9) + 1e-30
        sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))
        self._build(lo, width, 0, self.n, 0, -1)
        self.x = self.x.T.copy()  # → (3, N) kernel layout after sorting

    def _build(self, loc, h, start, count, depth, parent) -> int:
        cid = len(self.cells)
        cell = Cell(cid, np.array(loc), h, start, count, depth, parent)
        self.cells.append(cell)
        if count > self.n_max:
            cell.split = True
            seg = slice(start, start + count)
            xs = self.x[seg]
            mid = loc + h / 2
            octant = ((xs[:, 0] >= mid[0]).astype(np.int8) * 4
                      + (xs[:, 1] >= mid[1]).astype(np.int8) * 2
                      + (xs[:, 2] >= mid[2]).astype(np.int8))
            order = np.argsort(octant, kind="stable")
            self.x[seg] = xs[order]
            self.m[seg] = self.m[seg][order]
            counts = np.bincount(octant, minlength=8)
            off = start
            for o in range(8):
                c = int(counts[o])
                if c == 0:
                    continue
                cloc = loc + np.array([h / 2 * ((o >> 2) & 1),
                                       h / 2 * ((o >> 1) & 1),
                                       h / 2 * (o & 1)])
                child = self._build(cloc, h / 2, off, c, depth + 1, cid)
                cell.children.append(child)
                off += c
        return cid

    def neighbours(self, a: int, b: int) -> bool:
        ca, cb = self.cells[a], self.cells[b]
        tol = 1e-9 * (ca.h + cb.h)
        for d in range(3):
            if (ca.loc[d] > cb.loc[d] + cb.h + tol
                    or cb.loc[d] > ca.loc[d] + ca.h + tol):
                return False
        return True

    def leaves_of(self, c: int) -> List[int]:
        cell = self.cells[c]
        if not cell.split:
            return [c]
        out: List[int] = []
        stack = [c]
        while stack:
            k = stack.pop()
            ck = self.cells[k]
            if ck.split:
                stack.extend(ck.children)
            else:
                out.append(k)
        return out


@dataclass
class BHGraph:
    sched: QSched
    tree: Octree
    # per-task work lists (indices into tree.cells)
    self_blocks: Dict[int, List[int]]                  # tid -> cells (direct self)
    self_pairs: Dict[int, List[Tuple[int, int]]]       # tid -> (a,b) direct pairs
    pair_pairs: Dict[int, List[Tuple[int, int]]]       # tid -> (a,b) direct pairs
    pc_lists: Dict[int, List[int]]                     # tid -> com source cells
    task_cell: Dict[int, Tuple]                        # tid -> cell payload
    counts: Dict[str, int]


def build_graph(tree: Octree, n_task: int = 5000, nr_queues: int = 1,
                reown: bool = False) -> BHGraph:
    assert n_task >= tree.n_max, "n_task must be >= n_max for stop-cell containment"
    s = QSched(nr_queues=nr_queues, reown=reown)
    # resources: one per cell, hierarchical; ownership by parts-array slice
    for c in tree.cells:
        owner = c.start * nr_queues // max(tree.n, 1)
        parent_res = tree.cells[c.parent].res if c.parent != -1 else -1
        c.res = s.addres(owner=owner, parent=parent_res)

    # --- COM tasks (bottom-up dependencies) -------------------------------
    for c in tree.cells:
        # leaves reduce over their particles; inner cells combine 8 children
        cost = float(c.count) if not c.split else float(len(c.children))
        c.task_com = s.addtask(T_COM, data=("com", c.cid), cost=cost)
        s.adduse(c.task_com, c.res)
    for c in tree.cells:
        if c.parent != -1:
            s.addunlock(c.task_com, tree.cells[c.parent].task_com)
    root_com = tree.cells[0].task_com

    self_blocks: Dict[int, List[int]] = {}
    self_pairs: Dict[int, List[Tuple[int, int]]] = {}
    pair_pairs: Dict[int, List[Tuple[int, int]]] = {}
    com_per_leaf: Dict[int, List[int]] = {}
    task_cell: Dict[int, Tuple] = {}

    def com_add(a: int, b: int) -> None:
        for leaf in tree.leaves_of(a):
            com_per_leaf.setdefault(leaf, []).append(b)

    # --- inner dual walk: collect direct work for one task ----------------
    def walk_self(c: int, tid: int) -> None:
        cell = tree.cells[c]
        if cell.split:
            ch = cell.children
            for a in ch:
                walk_self(a, tid)
            for i in range(len(ch)):
                for j in range(i + 1, len(ch)):
                    walk_pair(ch[i], ch[j], tid, self_pairs)
        else:
            self_blocks.setdefault(tid, []).append(c)

    def walk_pair(a: int, b: int, tid: int, sink) -> None:
        if not tree.neighbours(a, b):
            com_add(a, b)
            com_add(b, a)
            return
        ca, cb = tree.cells[a], tree.cells[b]
        if ca.split and cb.split:
            for i in ca.children:
                for j in cb.children:
                    walk_pair(i, j, tid, sink)
        elif ca.split:
            for i in ca.children:
                walk_pair(i, b, tid, sink)
        elif cb.split:
            for j in cb.children:
                walk_pair(a, j, tid, sink)
        else:
            sink.setdefault(tid, []).append((a, b))

    # --- task creation (paper Fig 16 stop conditions) ---------------------
    def make_tasks(ci: int, cj: Optional[int]) -> None:
        if cj is None:
            cell = tree.cells[ci]
            if cell.split and cell.count > n_task:
                ch = cell.children
                for a in ch:
                    make_tasks(a, None)
                for i in range(len(ch)):
                    for j in range(i + 1, len(ch)):
                        make_tasks(ch[i], ch[j])
            else:
                tid = s.addtask(T_SELF, data=("self", ci),
                                cost=float(cell.count) ** 2)
                s.addlock(tid, cell.res)
                task_cell[tid] = ("self", ci)
                walk_self(ci, tid)
        else:
            if not tree.neighbours(ci, cj):
                com_add(ci, cj)
                com_add(cj, ci)
                return
            a, b = tree.cells[ci], tree.cells[cj]
            if a.split and b.split and a.count * b.count > n_task * n_task:
                for i in a.children:
                    for j in b.children:
                        make_tasks(i, j)
            else:
                tid = s.addtask(T_PAIR, data=("pair", ci, cj),
                                cost=float(a.count) * float(b.count))
                s.addlock(tid, a.res)
                s.addlock(tid, b.res)
                task_cell[tid] = ("pair", ci, cj)
                walk_pair(ci, cj, tid, pair_pairs)

    make_tasks(0, None)

    # --- particle-cell tasks: one per *leaf* (paper: 32 768 for 1M) -------
    pc_lists: Dict[int, List[int]] = {}
    for c in tree.cells:
        if c.split:
            continue
        srcs = com_per_leaf.get(c.cid, [])
        tid = s.addtask(T_PC, data=("pc", c.cid), cost=float(c.count))
        s.addlock(tid, c.res)
        s.addunlock(root_com, tid)  # all COMs ready before any pc walk
        task_cell[tid] = ("pc", c.cid)
        pc_lists[tid] = srcs

    by_type: Dict[int, int] = {}
    for t in s.tasks:
        by_type[t.type] = by_type.get(t.type, 0) + 1
    counts = {
        "tasks": s.nr_tasks,
        "self": by_type.get(T_SELF, 0),
        "pair_pp": by_type.get(T_PAIR, 0),
        "pair_pc": by_type.get(T_PC, 0),
        "com": by_type.get(T_COM, 0),
        "resources": len(s.resources),
        "locks": s.nr_locks,
        "deps": s.nr_deps,
    }
    return BHGraph(s, tree, self_blocks, self_pairs, pair_pairs, pc_lists,
                   task_cell, counts)




# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

class BHState:
    """Holds (3,N) positions, masses, accelerations and per-cell COM rows
    as float32 tensors on one device, and executes tasks by id.

    ``acc`` (3,N) is in the tree's sorted particle order; ``com``
    (ncells+1, 3) and ``cmass`` (ncells+1, 1) hold one row per cell plus a
    zero row, the pad target of the engine's gathers.  Task bodies add in
    place (``add_`` on a cell's slice), in every mode."""

    def __init__(self, g: BHGraph, eps: float = DEFAULT_EPS, device=None):
        dev = resolve_device(device)
        self.g = g
        self.eps = eps
        self.x = torch.tensor(g.tree.x, dtype=torch.float32, device=dev)
        self.m = torch.tensor(g.tree.m, dtype=torch.float32, device=dev)
        ncells = len(g.tree.cells)
        self.acc = torch.zeros_like(self.x)                   # (3, N)
        self.com = torch.zeros((ncells + 1, 3), dtype=torch.float32,
                               device=dev)
        self.cmass = torch.zeros((ncells + 1, 1), dtype=torch.float32,
                                 device=dev)
        self._leaves = None          # leaf-block layout, lazy
        self._gathers = None         # device index of COM gathers, lazy
        self._lazy_lock = threading.Lock()   # threaded workers build it

    def _rng(self, cid: int) -> slice:
        c = self.g.tree.cells[cid]
        return slice(c.start, c.start + c.count)

    # -- COM gathers ---------------------------------------------------------
    def _gather_index(self):
        """One device tensor of every cell list the host modes gather COM
        rows by (each inner cell's children, each PC task's sources) and
        the host slice of each list, so a task body gathers with a view
        and never copies an index to the device."""
        if self._gathers is None:
            with self._lazy_lock:
                if self._gathers is None:
                    lists = {("children", c.cid): c.children
                             for c in self.g.tree.cells if c.split}
                    lists.update({("pc", tid): srcs for tid, srcs
                                  in self.g.pc_lists.items() if srcs})
                    where, flat, n = {}, [], 0
                    for key, ids in lists.items():
                        where[key] = slice(n, n + len(ids))
                        flat.extend(ids)
                        n += len(ids)
                    idx = torch.tensor(flat, dtype=torch.int64,
                                       device=self.x.device)
                    self._gathers = (idx, where)
        return self._gathers

    def _get_coms(self, key) -> Tuple[torch.Tensor, torch.Tensor]:
        """COM positions (3,K) and masses (K,) of the cells of one list."""
        idx, where = self._gather_index()
        ids = idx[where[key]]
        return self.com[ids].T, self.cmass[ids, 0]

    # -- task bodies ---------------------------------------------------------
    def exec_task(self, ttype: int, data, tid: int = -1) -> None:
        g, eps = self.g, self.eps
        if ttype == T_COM:
            cid = data[1]
            if g.tree.cells[cid].split:
                xs, ms = self._get_coms(("children", cid))
            else:
                r = self._rng(cid)
                xs, ms = self.x[:, r], self.m[r]
            tot = ms.sum()
            self.com[cid] = (xs @ ms) / tot.clamp_min(1e-30)
            self.cmass[cid] = tot
            return
        if ttype == T_SELF:
            for c in g.self_blocks.get(tid, []):
                r = self._rng(c)
                self.acc[:, r].add_(ops.acc_self(self.x[:, r], self.m[r],
                                                 eps))
            for a, b in g.self_pairs.get(tid, []):
                self._direct_pair(a, b)
        elif ttype == T_PAIR:
            for a, b in g.pair_pairs.get(tid, []):
                self._direct_pair(a, b)
        elif ttype == T_PC:
            if not g.pc_lists.get(tid):
                return
            r = self._rng(data[1])
            xj, mj = self._get_coms(("pc", tid))
            self.acc[:, r].add_(ops.acc_pair(self.x[:, r], xj, mj, eps))
        else:
            raise ValueError(f"unknown task type {ttype}")

    def _direct_pair(self, a: int, b: int) -> None:
        ra, rb = self._rng(a), self._rng(b)
        x, m, eps = self.x, self.m, self.eps
        self.acc[:, ra].add_(ops.acc_pair(x[:, ra], x[:, rb], m[rb], eps))
        self.acc[:, rb].add_(ops.acc_pair(x[:, rb], x[:, ra], m[ra], eps))

    # -- engine lowering -------------------------------------------------------
    def _leaf_slots(self):
        """Leaf-block layout for the device engine: leaf cells in cid
        order, each owning a zero-mass-padded (3, P) particle block (P =
        max leaf count).  Returns (leaves, slot of each leaf cid, P, each
        sorted particle's flat index ``slot * P + position`` into the
        padded blocks, and each block's real particle count as an int32
        tensor, both on the state's device).  The leaves tile the sorted
        particles in cid order (depth-first build), which the flat index
        relies on."""
        if self._leaves is None:
            with self._lazy_lock:
                if self._leaves is None:
                    cells = self.g.tree.cells
                    leaves = [c.cid for c in cells if not c.split]
                    starts = np.array([cells[c].start for c in leaves])
                    counts = np.array([cells[c].count for c in leaves])
                    if not np.array_equal(starts, np.cumsum(counts)
                                          - counts):
                        raise AssertionError("leaves do not tile the "
                                             "sorted particles in cid order")
                    P = int(counts.max())
                    k = np.repeat(np.arange(len(leaves)), counts)
                    pos = np.arange(self.g.tree.n) - np.repeat(starts, counts)
                    slot = {cid: s for s, cid in enumerate(leaves)}
                    flat = torch.as_tensor(k * P + pos, device=self.x.device)
                    real = torch.as_tensor(counts.astype(np.int32),
                                           device=self.x.device)
                    self._leaves = (leaves, slot, P, flat, real)
        return self._leaves

    def batch_registry(self) -> Dict[int, BatchSpec]:
        """BatchSpecs for the ExecutionPlan ``rounds`` mode.  Cell blocks
        are ragged (per-cell particle counts differ), so every type runs
        per-task; the plan still provides the bulk-synchronous round
        structure and the lane assignment.

        Each spec also carries its engine ``encode``: a task expands into
        its direct-interaction work items over the padded leaf layout —
        self blocks, one row per pair *direction* (so every row has exactly
        one write target), COM reductions (leaf or ≤8-children inner), and
        particle-cell rows whose ragged COM-source lists chunk into
        ≤8-cell rows padded with the zero-mass dummy cell.  The encoders
        resolve the leaf layout lazily, so the host modes never build
        it."""
        def one(ttype):
            return lambda tid, data: self.exec_task(ttype, data, tid)

        g = self.g
        cells = g.tree.cells
        ncells = len(cells)          # dummy pad cell id == ncells
        kmax = engine.BH_MAX_CHILDREN

        def slot_of(cid):
            return self._leaf_slots()[1][cid]

        def pad_cells(ids):
            return list(ids) + [ncells] * (kmax - len(ids))

        def enc_com(tid, data):
            c = cells[data[1]]
            if c.split:
                return [(engine.BH_COM_INNER, c.cid, *pad_cells(c.children))]
            return [(engine.BH_COM_LEAF, c.cid, slot_of(c.cid))]

        def enc_pairs(pairs):
            rows = []
            for a, b in pairs:
                rows.append((engine.BH_PP, slot_of(a), slot_of(b)))
                rows.append((engine.BH_PP, slot_of(b), slot_of(a)))
            return rows

        def enc_self(tid, data):
            rows = [(engine.BH_SELF, slot_of(c))
                    for c in g.self_blocks.get(tid, [])]
            return rows + enc_pairs(g.self_pairs.get(tid, []))

        def enc_pair(tid, data):
            return enc_pairs(g.pair_pairs.get(tid, []))

        def enc_pc(tid, data):
            srcs = g.pc_lists.get(tid, [])
            la = slot_of(data[1]) if srcs else -1
            return [(engine.BH_PC, la, *pad_cells(srcs[i:i + kmax]))
                    for i in range(0, len(srcs), kmax)]

        enc = {T_SELF: enc_self, T_PAIR: enc_pair, T_PC: enc_pc,
               T_COM: enc_com}
        return {t: BatchSpec(run_one=one(t), encode=enc[t])
                for t in (T_SELF, T_PAIR, T_PC, T_COM)}

    def engine_hooks(self) -> EngineHooks:
        """Engine-family hooks for the backend registry: the Barnes-Hut
        walk over zero-mass-padded leaf blocks, one launch per launch
        group (``row_keys``).  The statics are the blocks, built on the
        device with one scatter, and each block's real particle count
        (the walk on the card skips the pads); ``writeback`` gathers the
        real particles' accelerations back with the same precomputed
        index.  Building the hooks costs nothing until the engine runs."""
        dev = self.x.device

        def statics():
            leaves, _, P, flat, counts = self._leaf_slots()
            xs = torch.zeros((3, len(leaves) * P), dtype=torch.float32,
                             device=dev)
            ms = torch.zeros(len(leaves) * P, dtype=torch.float32,
                             device=dev)
            xs[:, flat] = self.x
            ms[flat] = self.m
            return (xs.view(3, len(leaves), P).permute(1, 0, 2).contiguous(),
                    ms.view(len(leaves), P), counts)

        def buffers():
            leaves, _, P, _, _ = self._leaf_slots()
            return (torch.zeros((len(leaves), 3, P), dtype=torch.float32,
                                device=dev),
                    torch.zeros_like(self.com), torch.zeros_like(self.cmass))

        def writeback(out):
            acc, self.com, self.cmass = out
            flat = self._leaf_slots()[3]
            self.acc = acc.permute(1, 0, 2).reshape(3, -1)[:, flat]

        return EngineHooks(
            arg_width=engine.BH_ARG_WIDTH,
            round_fn=engine.bh_round_fn(self.eps), statics=statics,
            buffers=buffers, writeback=writeback,
            row_access=engine.bh_row_access, row_keys=engine.bh_row_keys)

    # -- drivers ---------------------------------------------------------------
    def run(self, mode: str = "sequential", nr_workers: int = 1) -> None:
        """Execute on any registered backend (``sequential``, ``threaded``,
        ``rounds``, ``engine``).  Concurrent backends add into the shared
        ``acc`` with no lock of their own: the resource locks acquired by
        ``gettask`` are what serialise overlapping writes."""
        run_plan(self.g.sched, self.batch_registry(), mode,
                 nr_workers=max(nr_workers, 1),
                 engine=self.engine_hooks())


def solve(x: np.ndarray, m: np.ndarray, n_max: int = 100,
          n_task: int = 5000, mode: str = "sequential", nr_workers: int = 1,
          eps: float = DEFAULT_EPS, device=None):
    """End-to-end Barnes-Hut: build tree + graph, execute, return
    (acc (3,N) in sorted order, state, graph).  Runs on ``device``
    (default ``cuda``; raises without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    tree = Octree(x, m, n_max=n_max)
    g = build_graph(tree, n_task=n_task, nr_queues=max(nr_workers, 1))
    st = BHState(g, eps=eps, device=dev)
    st.run(mode=mode, nr_workers=nr_workers)
    return st.acc, st, g
