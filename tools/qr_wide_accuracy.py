#!/usr/bin/env python3
"""How far K1-K4 past b = 64 lie from float64, beside their plain float32
versions, on one card.

    python3 tools/qr_wide_accuracy.py [B ...] [--card-data] [--time B ...]

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
than the plain version (the card test
``test_wide_kernels_no_further_from_float64_than_plain`` fails on any).

``--card-data`` adds, per b, the kernel's distance from its plain version
on the data of ``tests/test_torch_gpu.py::test_kernels_match_plain_on_card``
at batch 1 and 8 (seeds b + k, the guard tiles), which that test holds to
1.

``--time B`` (repeatable) times K1-K4 at tile size B, batch 1: CUDA
events over 10 launches (2 past b = 1024) after a warm-up, the median of
3, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def dist(got, want) -> float:
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (2e-5 + 1e-4 * w.abs())).max())


def float64_distances(b):
    import numpy as np
    import torch
    from repro_torch.kernels.qr_tile import ops, ref
    dev = torch.device("cuda")
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
                exact = ref.apply_tsqt_ref(*d(v2[i], t2[i], c1[i], c2[i]))
            mine = [o[i] for o in outs]
            dks = [dist(g, e) for g, e in zip(mine, exact)]
            dps = [dist(p, e) for p, e in zip(plain, exact)]
            dk.append(max(dks))
            dp.append(max(dps))
            dkp.append(max(dist(g, p) for g, p in zip(mine, plain)))
            fails = sum(x > max(1.0, y) for x, y in zip(dks, dps))
            if fails:
                print(f"[accuracy] {name} b = {b} tile {i}: kernel "
                      f"from float64 past max(1, plain's) on {fails} "
                      f"outputs ({[round(x, 3) for x in dks]} against "
                      f"{[round(y, 3) for y in dps]})", flush=True)

        def s(v):
            return (f"max {max(v):.3f} median {statistics.median(v):.3f}"
                    f" past 1 on {sum(x > 1 for x in v)}")
        print(f"[accuracy] {name} b = {b}, {n} tiles: kernel vs "
              f"float64 {s(dk)}; plain vs float64 {s(dp)}; kernel vs plain "
              f"{s(dkp)}; kernel further from float64 than plain on "
              f"{sum(x > y for x, y in zip(dk, dp))}", flush=True)


def card_data_distances(b):
    """The kernel's distance from its plain version on the data of
    test_kernels_match_plain_on_card (the test holds it to 1)."""
    import numpy as np
    import torch
    from repro_torch.kernels.qr_tile import ops, ref
    dev = torch.device("cuda")
    for n in (1, 8):
        a, c1, c2, r = (torch.tensor(
            np.random.default_rng(b + k).standard_normal((n, b, b)),
            dtype=torch.float32, device=dev) for k in range(4))
        r = torch.triu(r)
        if n == 8:
            for x in (a, c1, c2):
                x[1, :, min(3, b - 1)] = 0.0
                x[2] = torch.triu(x[2])
                x[3] = 0.0
        rv, tau, t = ops.geqrf(a)
        r1, v2, tau2, t2 = ops.tsqrf(r, c1)
        q1 = ops.apply_qt(rv, t, c2)
        s1, s2 = ops.apply_tsqt(v2, t2, c1, c2)
        torch.cuda.synchronize()
        worst = dict.fromkeys(("geqrf", "tsqrf", "apply_qt", "apply_tsqt"),
                              (0.0, ""))
        for i in range(n):
            pairs = {
                "geqrf": ((rv[i], tau[i], t[i]), ref.geqrf_ref(a[i]),
                          ("RV", "tau", "T")),
                "tsqrf": ((r1[i], v2[i], tau2[i], t2[i]),
                          ref.tsqrf_ref(r[i], c1[i]),
                          ("R'", "V2", "tau", "T")),
                "apply_qt": ((q1[i],), (ref.apply_qt_ref(rv[i], t[i],
                                                         c2[i]),), ("C",)),
                "apply_tsqt": ((s1[i], s2[i]), ref.apply_tsqt_ref(
                    v2[i], t2[i], c1[i], c2[i]), ("C1", "C2"))}
            for name, (got, want, labels) in pairs.items():
                for g, w, lab in zip(got, want, labels):
                    x = dist(g, w)
                    if x > worst[name][0]:
                        worst[name] = (x, f"tile {i} {lab}")
        print(f"[card-data] b = {b} batch {n}: kernel vs plain "
              + "; ".join(f"{k} {v:.3f} ({w})" for k, (v, w)
                          in worst.items()), flush=True)


def op_times(b, card):
    """K1-K4 at tile size b, batch 1, on seeded tiles (events)."""
    import numpy as np
    import torch
    from repro_torch.kernels.qr_tile import ops
    rng = np.random.default_rng(7)
    x, c1, c2 = (torch.tensor(rng.standard_normal((1, b, b)),
                              dtype=torch.float32, device="cuda")
                 for _ in range(3))
    r0 = torch.triu(x)
    rv, _, t = ops.geqrf(x)
    _, v2, _, t2 = ops.tsqrf(r0, c1)
    reps = 10 if b <= 1024 else 2
    out = []
    for name, fn in (("geqrf", lambda: ops.geqrf(x)),
                     ("tsqrf", lambda: ops.tsqrf(r0, c1)),
                     ("apply_qt", lambda: ops.apply_qt(rv, t, c2)),
                     ("apply_tsqt", lambda: ops.apply_tsqt(v2, t2, c1, c2))):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            torch.cuda.synchronize()
            runs.append(e0.elapsed_time(e1) / reps)
        out.append(f"{name} {statistics.median(runs):.5f}")
    print(f"[time] b = {b}, ms (median of 3): {'; '.join(out)}; "
          f"{card}", flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("sizes", nargs="*", type=int, default=[256, 512, 1000])
    p.add_argument("--card-data", action="store_true")
    p.add_argument("--time", action="append", type=int, default=[])
    args = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    for b in args.sizes:
        float64_distances(b)
        if args.card_data:
            card_data_distances(b)
    for b in args.time:
        op_times(b, card)


if __name__ == "__main__":
    main()
