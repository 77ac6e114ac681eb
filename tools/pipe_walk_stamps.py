#!/usr/bin/env python3
"""Where K9's time goes: per-tile device timestamps of the pipeline walk.

    python3 tools/pipe_walk_stamps.py

Run from the root of a checkout on a machine with one sm_90 card.  It
copies ``src/repro_torch/kernels/pipe_walk/csrc/pipe_walk.cu`` into
``build/repro_torch/variants/stamp/`` with a ``%globaltimer`` stamp (ns,
one clock for every SM) taken by thread 0 of a block at the start and the
end of each tile and after each grid barrier, walks the (8, 64, 32, 2048)
plan of ``chip_smoke.py`` through ``engine.pipe_round_fn`` with that
copy, and prints, for each tile kind, the tiles' durations; for the
phases, their busy span (first tile start to last tile end), the gaps
between them (the grid barrier) and the share of the resident blocks'
time spent in tiles.  The shipped source is not changed; the stamps cost
two global stores a tile.
"""

from __future__ import annotations

import ctypes
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

NMAX = 1 << 19      # tiles the stamp arrays hold (the plan has ~3.3e5)
STAMP = "unsigned long long {v}; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"({v}));"
PATCHES = [
    ("namespace cg = cooperative_groups;",
     "namespace cg = cooperative_groups;\n"
     f"__device__ unsigned long long g_stamp[3][{NMAX}];"),
    ("      if (t >= t1) break;\n",
     "      if (t >= t1) break;\n      " + STAMP.format(v="t_a") + "\n"),
    ("        default:\n          break;\n      }\n    }\n",
     "        default:\n          break;\n      }\n"
     "      " + STAMP.format(v="t_b") + "\n"
     f"      if (threadIdx.x == 0 && t < {NMAX}) {{ g_stamp[0][t] = t_a; "
     "g_stamp[1][t] = t_b; g_stamp[2][t] = blockIdx.x; }\n    }\n"),
    ('extern "C" {',
     'extern "C" {\nint pipe_stamps(unsigned long long* dst) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp));\n}'),
]


def main():
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch import _build, engine
    from repro_torch.kernels.pipe_walk import kernel as pw
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    text = pw.SOURCE.read_text()
    for old, new in PATCHES:
        if old not in text:
            sys.exit(f"pipe_walk.cu has no {old!r}")
        text = text.replace(old, new, 1)
    src = _build.build_dir() / "variants" / "stamp" / "pipe_walk.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    pw.SOURCE, pw._LIB = src, None
    S, M, Bt, D = cs.PIPE_FULL
    tab, statics, fresh = cs.pipe_state(torch, S, M, Bt, D, seed=0)
    desc, bounds = engine.upload_phases(tab.desc, tab.phase_offsets, "cuda")
    work = pw.work_list(tab.desc, bounds, Bt, D)
    walk = engine.pipe_round_fn(1.0 / M)
    for _ in range(2):                 # the second walk is the one read
        bufs = fresh()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        walk(desc, bounds, statics, bufs)
        e1.record()
        torch.cuda.synchronize()
    st = np.zeros((3, NMAX), np.uint64)
    fn = pw.lib().pipe_stamps
    fn.argtypes = [ctypes.c_void_p]
    if fn(st.ctypes.data) != 0:
        sys.exit("cudaMemcpyFromSymbol failed")
    nt = int(work.seg_offs[-1])
    a = st[0, :nt].astype(np.int64)
    b = st[1, :nt].astype(np.int64)
    b, a = b - a.min(), a - a.min()
    kind = np.zeros(nt, int)
    phase = np.zeros(nt, int)
    for s in range(len(work.segs)):
        kind[work.seg_offs[s]:work.seg_offs[s + 1]] = work.segs[s, 1]
    for q in range(len(work.phase_segs) - 1):
        phase[work.seg_offs[work.phase_segs[q]]:
              work.seg_offs[work.phase_segs[q + 1]]] = q
    grid = int(st[2, :nt].max()) + 1
    dur = (b - a) / 1e3
    print(f"{torch.cuda.get_device_name(0)}; walk {e0.elapsed_time(e1):.3f} "
          f"ms (CUDA events, the stamped copy), {nt} tiles, {grid} blocks")
    names = {pw.SEG_COT: "cot_in", pw.SEG_F: "F", pw.SEG_GW: "gW",
             pw.SEG_U: "U"}
    for k, name in names.items():
        sel = kind == k
        q = np.percentile(dur[sel], [10, 50, 90])
        print(f"{name}: {int(sel.sum())} tiles, us p10 {q[0]:.2f} p50 "
              f"{q[1]:.2f} p90 {q[2]:.2f} mean {dur[sel].mean():.2f}; "
              f"{dur[sel].sum() / 1e3:.1f} block-ms")
    nph = len(work.phase_segs) - 1
    span = np.array([(b[phase == q].max() - a[phase == q].min()) / 1e3
                     for q in range(nph)])
    gaps = np.array([(a[phase == q + 1].min() - b[phase == q].max()) / 1e3
                     for q in range(nph - 1)])
    busy = np.array([dur[phase == q].sum() / (grid * span[q])
                     for q in range(nph)])
    print(f"phases {nph}: busy span us p50 {np.median(span):.1f} max "
          f"{span.max():.1f}, sum {span.sum() / 1e3:.3f} ms; gaps us mean "
          f"{gaps.mean():.2f}, sum {gaps.sum() / 1e3:.3f} ms; blocks busy "
          f"{busy.mean():.3f} of each phase's span (mean)")


if __name__ == "__main__":
    main()
