#!/usr/bin/env python3
"""The QR kernels' outputs of two checkouts, compared bit for bit on one card.

    python3 tools/qr_bits.py ROOT OUT.pt      # run the checkout at ROOT
    python3 tools/qr_bits.py --compare A.pt B.pt

The first form builds the kernels of the checkout at ROOT (its own
``chip_smoke.py`` and ``src/repro_torch``), runs K1-K4 on two seeded
tiles at each b in ``SIZES`` (the shared-memory bodies' 64 and the blocked
bodies up to 1024) and K5 over the ``WALKS`` plans, and saves every output
to OUT.pt; the second prints how many of the saved outputs differ.  Two
checkouts whose arithmetic at these sizes is the same give no difference.
"""

from __future__ import annotations

import os
import pathlib
import sys

SIZES = (64, 65, 100, 128, 256, 300, 512, 1000, 1024)
WALKS = ((1024, 128), (1024, 256), (2048, 512))


def run(root: pathlib.Path, out: pathlib.Path) -> None:
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    os.chdir(root)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch import engine
    from repro_torch.kernels.qr_tile import ops
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    cs.phase_build()
    got = {}
    for b in SIZES:
        rng = np.random.default_rng(b)
        a, c1, c2, r = (torch.tensor(rng.standard_normal((2, b, b)),
                                     dtype=torch.float32, device="cuda")
                        for _ in range(4))
        rv, tau, t = ops.geqrf(a)
        r1, v2, tau2, t2 = ops.tsqrf(torch.triu(r), c1)
        q = ops.apply_qt(rv, t, c2)
        s1, s2 = ops.apply_tsqt(v2, t2, c1, c2)
        for k, v in dict(rv=rv, tau=tau, t=t, r1=r1, v2=v2, tau2=tau2,
                         t2=t2, q=q, s1=s1, s2=s2).items():
            got[f"{k}@{b}"] = v.cpu()
    for n, b in WALKS:
        tab = cs.plan_tables(torch, n, b)
        mat = torch.tensor(np.random.default_rng(n + b).standard_normal(
            (n, n)), dtype=torch.float32, device="cuda")
        tiles, tmat = cs.stack_of(torch, mat, b)
        desc, phases = engine.upload_phases(tab.desc, tab.phase_offsets,
                                            "cuda")
        engine.qr_round_fn(desc, phases, (), (tiles, tmat))
        got[f"walk_tiles@{n}/{b}"] = tiles.cpu()
        got[f"walk_tmat@{n}/{b}"] = tmat.cpu()
    torch.save(got, out)
    print(f"[qr-bits] {len(got)} outputs of {root} "
          f"({torch.cuda.get_device_name(0)}) saved to {out}", flush=True)


def compare(a: pathlib.Path, b: pathlib.Path) -> None:
    import torch
    x, y = torch.load(a), torch.load(b)
    differ = [k for k in x if not torch.equal(x[k], y[k])]
    print(f"[qr-bits] {len(x)} outputs compared, {len(differ)} differ"
          + (f": {differ}" if differ else ""), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(pathlib.Path(sys.argv[2]), pathlib.Path(sys.argv[3]))
    else:
        run(pathlib.Path(sys.argv[1]).resolve(),
            pathlib.Path(sys.argv[2]).resolve())
