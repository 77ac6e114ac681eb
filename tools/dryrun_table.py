#!/usr/bin/env python3
"""The dry run's records as one markdown table.

    python3 tools/dryrun_table.py DIR

Reads every ``<mesh>_<arch>_<shape>.json`` record that
``python -m repro_torch.launch.dryrun --out DIR`` wrote and prints a row
an architecture, a column a (mesh, shape) cell, each entry ``FLOPs a
device / argument GiB a device / collective operand GiB a device``, then
the skipped and failed cells, the collective counts' range, the depth
extrapolation's largest error against the full count and the seconds
the cells took.  The numbers are the dry run's predictions over the
reference's mesh shapes, not times or sizes of any device.
"""

from __future__ import annotations

import json
import pathlib
import sys

MESHES = ("single", "multi")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def entry(rec: dict) -> str:
    if rec["status"] != "ok":
        return rec["status"]
    full = rec["full"]
    return (f"{full['flops_per_device']:.3g} / "
            f"{full['memory']['argument_bytes'] / 2**30:.3g} / "
            f"{full['collective_operand_bytes_per_device'] / 2**30:.3g}")


def main(out_dir: pathlib.Path) -> None:
    recs = {(r["mesh"], r["arch"], r["shape"]): r
            for r in (json.loads(p.read_text())
                      for p in sorted(out_dir.glob("*.json")))}
    archs = sorted({a for _, a, _ in recs})
    cols = [(m, s) for m in MESHES for s in SHAPES]
    print("| arch | " + " | ".join(f"{m} {s}" for m, s in cols) + " |")
    print("|---" * (len(cols) + 1) + "|")
    for a in archs:
        print(f"| {a} | " + " | ".join(
            entry(recs[(m, a, s)]) if (m, a, s) in recs else "—"
            for m, s in cols) + " |")
    ok = [r for r in recs.values() if r["status"] == "ok"]
    bad = sorted(f"{k[0]}/{k[1]}/{k[2]}: {r.get('error', '')[:80]}"
                 for k, r in recs.items() if r["status"] == "error")
    skipped = sum(r["status"] == "skipped" for r in recs.values())
    counts = [sum(v["count"] for v in r["full"]["collectives"].values())
              for r in ok]
    errs = [r["extrapolated"]["rel_err_flops"] for r in ok
            if r.get("extrapolated", {}).get("rel_err_flops") is not None]
    secs = [r.get("build_seconds", 0) + r.get("run_seconds", 0) for r in ok]
    print(f"\n{len(ok)} ok, {skipped} skipped, {len(bad)} errors"
          + "".join(f"\n- {b}" for b in bad))
    if ok:
        print(f"collectives a cell {min(counts)}–{max(counts)}; "
              f"extrapolation error at most "
              f"{max(errs) if errs else float('nan'):.2e} over {len(errs)} "
              f"cells; {min(secs):.1f}–{max(secs):.1f} s a cell (build and "
              f"run, probes not counted)")


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]))
