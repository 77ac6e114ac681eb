#!/usr/bin/env python3
"""The walks (K9, K8) or the QR kernels (K1-K5) of two checkouts side by
side on one card.

    python3 tools/compare_walks.py ROOT TAG [--qr]

Times, in the checkout at ROOT (its own ``chip_smoke.py`` and
``src/repro_torch``), the K9 walk of a whole (8, 64, 32, 2048) pipeline
plan through ``engine.pipe_round_fn`` (CUDA events, five runs) and the
K8 launches alone over the paper's 1M-particle Barnes-Hut plan (one
``bh_walk`` launch a launch group, between two events, five runs), and
prints one line tagged TAG.  It takes either form of the K8 binding (with
or without the leaf counts and the bucket order).  The 1M plan is
lowered once and kept in ``COMPARE_WALKS_CACHE`` (by default
``build/compare_walks/bh1m.pt`` under ROOT), which later runs reuse; run
two checkouts in turns (A, B, B, A) with one cache to compare them.

With ``--qr`` it times instead K1-K4 at b = 64, 128, 256 and 512 (batch
1, the kernel launches alone with their outputs allocated beforehand, 50
of them in one CUDA graph, median of 3) and K5 over the 2048² / 64², 1024²
/ 128², 1024² / 256² and 2048² / 512² plans (``chip_smoke.walk_times``:
median of 3 after a warm-up, beside the barrier floor).
"""

from __future__ import annotations

import inspect
import os
import pathlib
import statistics
import sys


def qr_kernels(torch, np, cs, tag: str) -> None:
    from repro_torch.kernels.qr_tile import kernel, ops
    dev = torch.device("cuda")
    out = []
    for b in (64, 128, 256, 512):
        rng = np.random.default_rng(7)
        x, c1, c2 = (torch.tensor(rng.standard_normal((1, b, b)),
                                  dtype=torch.float32, device=dev)
                     for _ in range(3))
        r0 = torch.triu(x)
        rv, _, t = ops.geqrf(x)
        _, v2, _, t2 = ops.tsqrf(r0, c1)
        o1, o2, o3 = (torch.empty_like(x) for _ in range(3))
        tv = torch.empty((1, b), device=dev)
        fns = {"geqrf": lambda: kernel.geqrf(x, o1, tv, o2),
               "tsqrf": lambda: kernel.tsqrf(r0, c1, o1, o2, tv, o3),
               "apply_qt": lambda: kernel.apply_qt(rv, t, c1, o1),
               "apply_tsqt": lambda: kernel.apply_tsqt(v2, t2, c1, c2, o1,
                                                        o2)}
        for name, fn in fns.items():
            ms = cs.median_of(lambda: cs.graph_ms(torch, fn))
            out.append(f"{name}@{b} {ms:.5f}")
    for n, b in ((2048, 64), (1024, 128), (1024, 256), (2048, 512)):
        mat = torch.tensor(np.random.default_rng(n).standard_normal((n, n)),
                           dtype=torch.float32, device=dev)
        _, ms, floor, *_ = cs.walk_times(torch, mat, b)
        out.append(f"qr_walk@{n}/{b} {ms:.4f} (floor {floor:.4f})")
    print(f"[compare] {tag} ({torch.cuda.get_device_name(0)}): "
          + ", ".join(out), flush=True)


def main(root: pathlib.Path, tag: str, qr: bool = False) -> None:
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    os.chdir(root)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch import engine
    from repro_torch.kernels.nbody import kernel as nbk
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if qr:
        qr_kernels(torch, np, cs, tag)
        return
    cs.phase_build()
    S, M, Bt, D = cs.PIPE_FULL
    tab, statics, fresh = cs.pipe_state(torch, S, M, Bt, D, seed=0)
    desc, bounds = engine.upload_phases(tab.desc, tab.phase_offsets, "cuda")
    walk = engine.pipe_round_fn(1.0 / M)

    def events(fn):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    def k9():
        bufs = fresh()
        return events(lambda: walk(desc, bounds, statics, bufs))

    k9()
    t9 = [k9() for _ in range(5)]
    cache = pathlib.Path(os.environ.get("COMPARE_WALKS_CACHE", root / "build"
                                        / "compare_walks" / "bh1m.pt"))
    if not cache.exists():
        x, m = cs.bh_inputs(np, cs.N_PAPER)
        _, keep = cs.staged_solve(torch, x, m, cs.NTASK_PAPER, "engine")
        lg, st = keep["lg"], keep["st"]
        leaves = st._leaf_slots()[0]
        cells = st.g.tree.cells
        cache.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"desc": keep["tab"].desc[lg.order],
                    "bo": lg.bucket_offsets, "go": lg.group_offsets,
                    "xs": keep["statics"][0].cpu(),
                    "ms": keep["statics"][1].cpu(),
                    "counts": np.array([cells[c].count for c in leaves],
                                       np.int32),
                    "ncells": len(cells), "eps": st.eps}, cache)
    d = torch.load(cache, weights_only=False)
    desc8 = torch.as_tensor(d["desc"], device="cuda")
    xs, ms = d["xs"].to("cuda"), d["ms"].to("cuda")
    counts = torch.as_tensor(d["counts"], device="cuda")
    L, _, P = xs.shape
    bo, go = d["bo"], d["go"].tolist()
    eps2 = d["eps"] ** 2
    with_counts = "counts" in inspect.signature(nbk.bh_walk).parameters
    if with_counts:
        groups = engine.LaunchGroups(order=None, bucket_offsets=bo,
                                     group_offsets=d["go"])
        order = engine.megakernel.bucket_order(groups)
        both = torch.as_tensor(np.concatenate([bo, order]).astype(np.int32),
                               device="cuda")
        ptr, order = both[:len(bo)], both[len(bo):]
    else:
        ptr = torch.as_tensor(bo.astype(np.int32), device="cuda")

    def k8():
        acc = torch.zeros((L, 3, P), device="cuda")
        com = torch.zeros((d["ncells"] + 1, 3), device="cuda")
        cmass = torch.zeros((d["ncells"] + 1, 1), device="cuda")

        def launches():
            for b0, b1 in zip(go, go[1:]):
                if with_counts:
                    nbk.bh_walk(desc8, ptr, order, b0, b1, xs, ms, counts,
                                acc, com, cmass, eps2)
                else:
                    nbk.bh_walk(desc8, ptr, b0, b1, xs, ms, acc, com, cmass,
                                eps2)
        return events(launches)

    k8()
    t8 = [k8() for _ in range(5)]
    print(f"[compare] {tag} ({torch.cuda.get_device_name(0)}): K9 plan ms "
          f"median {statistics.median(t9):.3f} {[round(t, 3) for t in t9]}; "
          f"K8 1M launches alone ms median {statistics.median(t8):.3f} "
          f"{[round(t, 3) for t in t8]}", flush=True)


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]).resolve(), sys.argv[2],
         "--qr" in sys.argv[3:])
