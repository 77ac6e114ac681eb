"""Predicted-vs-measured QR task timelines in one Perfetto view, on the
PyTorch/CUDA port.  The twin of ``examples/trace_qr.py``, with the same
steps, arguments and printed lines.

The paper's evaluation figures are per-thread task timelines (Figs 6/7)
plus scheduler-overhead accounting.  This demo reproduces that artifact
end to end with the port's observability tier (``repro_torch.obs``):

1. build the tiled-QR task graph and lower it through the plan + engine
   table pipeline (the tracer records the build/prepare/lower/encode
   spans along the way);
2. measure every engine work item with ``measure_round_times
   (per_item=True)`` — the paper's per-task tic/toc, one launch of the QR
   walk an item on the card (its plain version on the CPU), recorded as
   task events on the **measured** process track;
3. replay the measured item costs through the discrete-event simulator
   at ``--lanes`` workers and emit its timeline as the **predicted**
   process track, aligned to the measured clock;
4. export both tracks plus the metrics snapshot as Chrome trace-event
   JSON — drag it into https://ui.perfetto.dev (or chrome://tracing).

    PYTHONPATH=src python examples/trace_qr_torch.py --out trace_qr.json
    PYTHONPATH=src python examples/trace_qr_torch.py --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import engine, obs, resolve_device
from repro_torch.apps import qr
from repro_torch.core import lower
from repro_torch.core.simulator import replay_item_times, timeline_to_tracer

TYPE_NAMES = {qr.T_GEQRF: "GEQRF", qr.T_LARFT: "LARFT",
              qr.T_TSQRF: "TSQRF", qr.T_SSRFT: "SSRFT"}


def main(argv=None) -> dict:
    """Trace, replay and export; returns the numbers it prints.  The
    global tracer it installs is put back as it was before it returns."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=96, help="matrix size")
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=4,
                    help="simulated workers for the predicted track")
    ap.add_argument("--out", default="trace_qr.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the QR walk kernel) or cpu (its plain "
                         "version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    before = obs.get_tracer()
    tracer = obs.enable(process="measured")
    try:
        a = torch.as_tensor(np.random.default_rng(args.seed)
                            .standard_normal((args.n, args.n)),
                            dtype=torch.float32).to(dev)
        tiles, mt, nt = qr._split_tiles(a, args.tile)
        sched, _ = qr.make_qr_graph(mt, nt, nr_queues=args.lanes)
        plan = lower(sched, args.lanes)
        state = qr._TileState(dict(tiles))
        tables = engine.lower_tables(
            plan, sched, state.batch_registry(),
            arg_width=engine.QR_ARG_WIDTH, row_access=engine.qr_row_access)
        stack = torch.stack([tiles[i, j] for j in range(nt)
                             for i in range(mt)])

        # measured: one task record per engine work item (paper tic/toc)
        timings = engine.measure_round_times(
            tables, engine.qr_round_fn, (), (stack, torch.zeros_like(stack)),
            per_item=True)

        # predicted: replay the measured per-item costs through the
        # discrete-event model at --lanes workers, on the measured clock
        result = replay_item_times(sched, tables.tids, timings.item_s,
                                   nr_workers=args.lanes)
        t_origin = min(t.t0 for t in tracer.tasks)
        n_pred = timeline_to_tracer(result, process="predicted",
                                    t_origin=t_origin)

        info = obs.write_chrome_trace(args.out, registry=obs.get_registry(),
                                      type_names=TYPE_NAMES)
    finally:
        obs.set_tracer(before)
    measured_s = float(timings.item_s.sum())
    print(f"qr {args.n}x{args.n} tile {args.tile}: {sched.nr_tasks} tasks, "
          f"{tables.nr_items} items")
    print(f"measured serial {measured_s * 1e3:.1f}ms; predicted "
          f"{args.lanes}-lane makespan {result.makespan * 1e3:.1f}ms "
          f"(speedup {measured_s / result.makespan:.2f}x, "
          f"{n_pred} predicted events)")
    print(f"trace: {args.out} ({info['events']} events, processes="
          f"{info['processes']}) — open in https://ui.perfetto.dev")
    return {"nr_tasks": sched.nr_tasks, "nr_items": tables.nr_items,
            "sched": sched, "tables": tables, "item_s": timings.item_s,
            "measured_s": measured_s, "makespan": result.makespan,
            "n_pred": n_pred, "out": args.out, "info": info,
            "tasks_by_process": {
                p: sum(t.process == p for t in tracer.tasks)
                for p in ("measured", "predicted")}}


if __name__ == "__main__":
    main()
