"""Quickstart of the PyTorch/CUDA port (``repro_torch``): build a task graph
with dependencies AND conflicts, run it, then factor a matrix through the
scheduler on the card, per task and on the device-resident engine.  The
twin of ``examples/quickstart.py``, with the same steps and printed lines.

    PYTHONPATH=src python examples/quickstart_torch.py               # H100
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain

On ``cuda`` the tiled QR runs the hand-written tile kernels (geqrf, tsqrf,
apply_qt, apply_tsqt) one launch a task, and the engine walks the whole
plan in one cooperative launch (``qr_walk``); on ``cpu`` both take their
plain PyTorch versions.  Without a card the default device raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps import qr
from repro_torch.core import QSched, SequentialExecutor, simulate

N, TILE = 96, 32
SCALING_WORKERS = (1, 4, 16, 64)


def main(argv=None) -> dict:
    """Run the four steps; returns the numbers they print."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. the paper's Figure 2 graph: dependencies + a conflict ------------
    s = QSched(nr_queues=2)
    shared = s.addres()                      # the conflict: a shared resource
    a = s.addtask(data="A", cost=1.0)
    b = s.addtask(data="B", cost=1.0)
    c = s.addtask(data="C", cost=1.0)
    for t in (b, c):
        s.addunlock(a, t)                    # B, C depend on A
        s.addlock(t, shared)                 # B, C conflict (not together)

    order = []
    SequentialExecutor(s).run(lambda ty, data: order.append(data))
    print("execution order:", order)

    res = simulate(s, nr_workers=2)
    print(f"2 workers, makespan={res.makespan} "
          f"(B and C serialized by the conflict)")

    # --- 2. something real: tiled QR through the scheduler --------------------
    a_mat = torch.as_tensor(np.random.default_rng(0).standard_normal((N, N)),
                            dtype=torch.float32).to(dev)
    r, sched = qr.run_qr(a_mat, tile=TILE, mode="sequential", device=dev)
    gram_err = float((r.T @ r - a_mat.T @ a_mat).abs().max())
    print(f"tiled QR via QuickSched: {sched.nr_tasks} tasks, "
          f"|R^T R - A^T A| = {gram_err:.2e}")

    # --- 3. the same QR on the device-resident engine ------------------------
    # The plan lowers to descriptor task tables and the whole factorization
    # runs as ONE cooperative launch of the QR walk, against one host
    # dispatch per task/batch per round.
    r_eng, _ = qr.run_qr(a_mat, tile=TILE, mode="engine", device=dev)
    engine_gap = float((r_eng - r).abs().max())
    host, eng = qr.dispatch_counts(a_mat, tile=TILE)
    print(f"engine mode: |R_engine - R| = {engine_gap:.2e}; "
          f"host dispatches {host} -> {eng} ({host / eng:.0f}x fewer)")

    # --- 4. strong scaling of the same graph (simulated workers) -------------
    t1 = simulate(qr.make_qr_graph(16, 16, nr_queues=1)[0], 1).makespan
    speedups = {}
    for n in SCALING_WORKERS:
        s2, _ = qr.make_qr_graph(16, 16, nr_queues=n)
        speedups[n] = t1 / simulate(s2, n).makespan
        print(f"  {n:3d} workers: simulated speedup {speedups[n]:6.2f}")

    return {"order": order, "makespan": res.makespan,
            "a": a_mat, "r": r, "r_engine": r_eng,
            "nr_tasks": sched.nr_tasks, "gram_err": gram_err,
            "engine_gap": engine_gap, "host_dispatches": host,
            "engine_dispatches": eng, "speedups": speedups}


if __name__ == "__main__":
    main()
