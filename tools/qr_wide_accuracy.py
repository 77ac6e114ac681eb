#!/usr/bin/env python3
"""How far K1-K4 past b = 64 lie from float64, beside their plain float32
versions, on one card.

    python3 tools/qr_wide_accuracy.py [B ...]

For each tile size B (default 256, 512 and 1000) the tool runs the four
ops on seeded random tiles (40 at b <= 256, 10 above; seeds 1000 on),
tsqrf with a random upper triangle as R, the applies on the plain
version's factors, and holds each output against the float64 version of
its plain function (``ref.*_ref`` on the same float32 inputs, upcast), and
the plain float32 version against it too.  A distance is max |x - y| /
(2e-5 + 1e-4 |y|), the card tests' kernel-vs-plain limit being 1.  It
prints, per op and b, over the tiles and the op's outputs: the largest and
median distance of the kernel from float64, of the plain version from
float64 and of the kernel from the plain version, how many tiles lie past
1 in each, and on how many tiles the kernel lies further from float64
than the plain version.
"""

from __future__ import annotations

import pathlib
import statistics
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def dist(got, want) -> float:
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (2e-5 + 1e-4 * w.abs())).max())


def main(sizes) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels.qr_tile import ops, ref
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    for b in sizes:
        n = 40 if b <= 256 else 10

        def rand(k):
            return torch.tensor(np.stack([
                np.random.default_rng(1000 + 4 * s + k).standard_normal(
                    (b, b)) for s in range(n)]), dtype=torch.float32,
                device=dev)

        a, c1, c2, r = rand(0), rand(1), rand(2), torch.triu(rand(3))
        plain_f = [ref.geqrf_ref(x) for x in a]
        plain_t = [ref.tsqrf_ref(x, y) for x, y in zip(r, c1)]
        rv = torch.stack([p[0] for p in plain_f])
        t = torch.stack([p[2] for p in plain_f])
        v2 = torch.stack([p[1] for p in plain_t])
        t2 = torch.stack([p[3] for p in plain_t])
        got = {"geqrf": ops.geqrf(a), "tsqrf": ops.tsqrf(r, c1),
               "apply_qt": (ops.apply_qt(rv, t, c2),),
               "apply_tsqt": ops.apply_tsqt(v2, t2, c1, c2)}
        torch.cuda.synchronize()
        d = lambda *x: [y.double() for y in x]     # noqa: E731
        for name, outs in got.items():
            dk, dp, dkp = [], [], []
            for i in range(n):
                if name == "geqrf":
                    plain, exact = plain_f[i], ref.geqrf_ref(a[i].double())
                elif name == "tsqrf":
                    plain = plain_t[i]
                    exact = ref.tsqrf_ref(*d(r[i], c1[i]))
                elif name == "apply_qt":
                    plain = (ref.apply_qt_ref(rv[i], t[i], c2[i]),)
                    exact = (ref.apply_qt_ref(*d(rv[i], t[i], c2[i])),)
                else:
                    plain = ref.apply_tsqt_ref(v2[i], t2[i], c1[i], c2[i])
                    exact = ref.apply_tsqt_ref(*d(v2[i], t2[i], c1[i],
                                                  c2[i]))
                mine = [o[i] for o in outs]
                dk.append(max(dist(g, e) for g, e in zip(mine, exact)))
                dp.append(max(dist(p, e) for p, e in zip(plain, exact)))
                dkp.append(max(dist(g, p) for g, p in zip(mine, plain)))

            def s(v):
                return (f"max {max(v):.3f} median {statistics.median(v):.3f}"
                        f" past 1 on {sum(x > 1 for x in v)}")
            print(f"[accuracy] {name} b = {b}, {n} tiles: kernel vs float64 "
                  f"{s(dk)}; plain vs float64 {s(dp)}; kernel vs plain "
                  f"{s(dkp)}; kernel further from float64 than plain on "
                  f"{sum(x > y for x, y in zip(dk, dp))}", flush=True)


if __name__ == "__main__":
    main([int(x) for x in sys.argv[1:]] or [256, 512, 1000])
