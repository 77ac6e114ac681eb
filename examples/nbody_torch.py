"""Barnes-Hut N-body through the PyTorch/CUDA port's scheduler (paper
§4.2): octree, hierarchical resource conflicts, COM dependency tree,
accuracy against the direct sum.  The twin of ``examples/nbody.py``, with
the same steps and printed lines.

    PYTHONPATH=src python examples/nbody_torch.py [n_particles]          # H100
    PYTHONPATH=src python examples/nbody_torch.py 2000 --device cpu      # plain

On ``cuda`` every pair and self task launches the hand-written
``acc_pair`` / ``acc_self`` kernel (the default sequential mode, one launch
a task); on ``cpu`` they take their plain PyTorch versions.  Without a card
the default device raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.apps import barneshut as bh
from repro_torch.core import simulate
from repro_torch.kernels.nbody.ref import DEFAULT_EPS

N_MAX, N_TASK = 64, 1000
SCALING_WORKERS = (1, 8, 32, 64)
DIRECT_CHUNK = 256    # targets a step of the direct sum: (3, 256, N) floats


def direct_sum(x: torch.Tensor, m: torch.Tensor, eps: float = DEFAULT_EPS,
               chunk: int = DIRECT_CHUNK) -> torch.Tensor:
    """The O(N^2) direct sum of ``kernels.nbody.ref.acc_direct_ref`` (the
    same expression: every source, self-pairs excluded) over targets a
    chunk at a time, so no (3, N, N) temporary is made (4.8 GB at 20k)."""
    n = x.shape[1]
    out = torch.empty_like(x)
    for i0 in range(0, n, chunk):
        i1 = min(n, i0 + chunk)
        dx = x[:, None, :] - x[:, i0:i1, None]           # (3, c, N)
        r2 = (dx * dx).sum(0) + eps * eps
        w = r2 ** -1.5 * m[None, :]
        rows = torch.arange(i1 - i0, device=x.device)
        w[rows, rows + i0] = 0.0                          # self pairs
        out[:, i0:i1] = torch.einsum("dij,ij->di", dx, w)
    return out


def relative_errors(acc: torch.Tensor, exact: torch.Tensor) -> np.ndarray:
    """Per particle ‖acc − exact‖ / ‖exact‖ (the reference's measure)."""
    num = torch.linalg.vector_norm(acc - exact, dim=0)
    den = torch.linalg.vector_norm(exact, dim=0).clamp_min(1e-12)
    return (num / den).cpu().numpy()


def main(argv=None) -> dict:
    """Solve, measure the error, simulate the scaling; returns the numbers
    it prints."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=20_000,
                    help="particles (default 20,000)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    n = args.n
    rng = np.random.default_rng(0)
    x = rng.random((n, 3))
    m = rng.random(n) + 0.5

    t0 = time.time()
    acc, state, graph = bh.solve(x, m, n_max=N_MAX, n_task=N_TASK,
                                 device=args.device)
    if acc.device.type == "cuda":
        torch.cuda.synchronize()
    solve_s = time.time() - t0
    counts = dict(graph.counts)
    print(f"N={n}: solved in {solve_s:.1f}s; "
          f"tasks={counts['tasks']} "
          f"(self={counts['self']} pair={counts['pair_pp']} "
          f"pc={counts['pair_pc']} com={counts['com']})")

    # accuracy against the O(N^2) direct sum over every target, in the
    # tree's sorted order (acc's order)
    exact = direct_sum(state.x, state.m)
    rel = relative_errors(acc, exact)
    print(f"median relative force error vs direct sum: "
          f"{float(np.median(rel)):.2e}")

    # simulated strong scaling (paper Fig 11)
    efficiency = {}
    for workers in SCALING_WORKERS:
        tree = bh.Octree(x, m, n_max=N_MAX)
        g = bh.build_graph(tree, n_task=N_TASK, nr_queues=workers)
        r = simulate(g.sched, workers)
        efficiency[workers] = r.total_cost / (workers * r.makespan)
        print(f"  {workers:3d} workers: efficiency "
              f"{efficiency[workers]:.2%}")

    return {"n": n, "solve_s": solve_s, "counts": counts,
            "x": x, "m": m, "acc": acc, "state": state, "exact": exact,
            "rel": rel, "median_rel": float(np.median(rel)),
            "mean_rel": float(rel.mean()), "efficiency": efficiency}


if __name__ == "__main__":
    main()
