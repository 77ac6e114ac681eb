#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one sm_90 card.  It
builds the port's CUDA kernels from the checkout's sources and drives the
main path, the paper's tiled QR (§4.1) at its benchmark size (2048² fp32,
64² tiles), through ``repro_torch.apps.qr.run_qr`` in all four execution
modes.  Phases, each fatal when it fails:

 1. the card: name and power limit (nvidia-smi), versions, capability 9.0;
 2. build the kernels (nvcc, sm_90a) and report the build time;
 3. K1-K4 (geqrf, tsqrf, apply_qt, apply_tsqt) against their plain
    PyTorch versions on the card, b in {16, 32, 64}, batch 1 and 8;
 4. K5 (the task-table walk) against the plain walk, 256² with 32² tiles;
 5. the main path: run_qr at 2048²/64² in sequential, threaded, rounds
    and engine modes on the card — bitwise equal across modes, R valid
    (Gram identity, float64 LAPACK up to signs), the engine's R equal to
    the plain path's on the CPU within tolerance, and the launch counters
    showing that every kernel ran and no plain version ran on the card;
 6. timings (CUDA events, median of 3 after warm-up): run_qr per mode at
    2048² and engine mode at 4096², launches per plan, each kernel at
    b = 64 beside its bound, its plain version and a PyTorch yardstick
    (torch.geqrf, torch.ormqr, torch.linalg.qr — never called by the port).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script imports
nothing of jax and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_MAIN, B_MAIN = 2048, 64        # the paper's benchmark matrix and tile
N_LARGE = 4096
LANES = 4
MODES = ("sequential", "threaded", "rounds", "engine")
FP32_PEAK = 67e12     # H100 SXM fp32 outside the tensor cores (data sheet)
HBM_RATE = 3.35e12    # H100 SXM HBM3 bytes/s (data sheet)

# tolerances, each with its reason
OP_TOL = dict(atol=2e-5, rtol=1e-4)   # the reference's kernel-vs-oracle
WALK_TOL = 1e-4   # per tile, max|Δ| / max(1, max|plain|): the walk and the
#                   plain walk sum in different orders over 8 levels
GRAM_TOL = 1e-5   # ‖RᵀR−AᵀA‖_F/‖A‖_F²: well under n·u = 1.2e-4 (u = 2⁻²⁴)
LAPACK_TOL = 1e-4  # ‖R·S − R64‖_F/‖R64‖_F, S the signs; 5e-7 at 512² (CPU)
CPU_TOL = 1e-4    # ‖R_engine − R_cpu‖_F/‖R_cpu‖_F: two float32 orders
LIB_TOL = dict(atol=1e-4, rtol=1e-3)  # yardstick vs kernel: another
#                   algorithm (blocked LAPACK-style) summing in another order;
#                   it shows only that the yardstick computes the same function


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def median_of(fn, reps=3):
    return statistics.median(fn() for _ in range(reps))


# ---------------------------------------------------------------------------
# operation and byte counts (what the function must do and move)
# ---------------------------------------------------------------------------

def macs(op, b):
    """Multiply-adds of each tile op as the kernels do them (triangular
    factors exploited): the least work of this algorithm."""
    if op == "geqrf":       # dots incl. the T recurrence, update, T column
        return sum((b - 1) * (b - j) + (b - j) * (b - j - 1)
                   + j * (j + 1) // 2 for j in range(b))
    if op == "tsqrf":
        return sum((b - 1) * b + b * (b - j - 1) + j * (j + 1) // 2
                   for j in range(b))
    if op == "apply_qt":    # Vᵀ C (unit lower), Tᵀ W (upper), V W2
        return b * (b * (b - 1) // 2) * 2 + b * (b * (b + 1) // 2)
    if op == "apply_tsqt":  # V2ᵀ C2, Tᵀ W, V2 X
        return 2 * b ** 3 + b * (b * (b + 1) // 2)
    raise KeyError(op)


def tile_bytes(op, b, n=1):
    """Bytes in + out of one call on n tiles (each read/written once)."""
    t, v = b * b * 4, b * 4
    per = {"geqrf": t + 2 * t + v, "tsqrf": 2 * t + 3 * t + v,
           "apply_qt": 3 * t + t, "apply_tsqt": 4 * t + 2 * t}[op]
    return per * n


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {cap} devices {torch.cuda.device_count()}")
    if cap != (9, 0):
        fail(f"needs compute capability (9, 0), got {cap}")
    return card


def phase_build():
    from repro_torch import _build
    from repro_torch.kernels.qr_tile import kernel
    t0 = time.perf_counter()
    kernel.lib()
    log(f"[build] kernels built (nvcc, sm_90a) and loaded in "
        f"{time.perf_counter() - t0:.2f} s into {_build.build_dir()}")


def phase_ops(torch, np):
    """K1-K4 against the plain versions on the card; returns max |err|."""
    from repro_torch.kernels.qr_tile import ops, ref
    errs = dict.fromkeys(("geqrf", "tsqrf", "apply_qt", "apply_tsqt"), 0.0)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def check(name, got, want):
        for g, w in zip(got, want):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            if not np.isfinite(g).all():
                fail(f"{name}: non-finite kernel output")
            np.testing.assert_allclose(g, w, err_msg=name, **OP_TOL)
            errs[name] = max(errs[name], float(np.abs(g - w).max()))

    for b in (16, 32, 64):
        for n in (1, 8):
            x = [torch.tensor(rng.standard_normal((n, b, b)), dtype=torch.float32,
                              device=dev) for _ in range(3)]
            a, c1, c2 = x
            if n == 8:                 # Householder guards: zero column,
                a[1, :, 3] = 0.0       # already-triangular tile
                a[2] = torch.triu(a[2])
            got = ops.geqrf(a)
            plain = [ref.geqrf_ref(t) for t in a]
            for i, p in enumerate(plain):
                check("geqrf", [g[i] for g in got], p)
            rv, t = torch.stack([p[0] for p in plain]), torch.stack(
                [p[2] for p in plain])
            r0 = torch.triu(a)
            got = ops.tsqrf(r0, c1)
            plain = [ref.tsqrf_ref(r, y) for r, y in zip(r0, c1)]
            for i, p in enumerate(plain):
                check("tsqrf", [g[i] for g in got], p)
            v2, t2 = torch.stack([p[1] for p in plain]), torch.stack(
                [p[3] for p in plain])
            got = ops.apply_qt(rv, t, c2)
            for i in range(n):
                check("apply_qt", [got[i]],
                      [ref.apply_qt_ref(rv[i], t[i], c2[i])])
            got = ops.apply_tsqt(v2, t2, c1, c2)
            for i in range(n):
                check("apply_tsqt", [g[i] for g in got],
                      ref.apply_tsqt_ref(v2[i], t2[i], c1[i], c2[i]))
            torch.cuda.synchronize()
    log("[ops] K1-K4 match their plain versions, b in (16, 32, 64), batch "
        f"1 and 8, atol 2e-5 rtol 1e-4; max |err| {errs}")
    return errs


def plan_tables(torch, n, b):
    from repro_torch import engine
    from repro_torch.apps import qr
    from repro_torch.core import lower
    mt = n // b
    s, _ = qr.make_qr_graph(mt, mt, nr_queues=LANES)
    plan = lower(s, LANES)
    st = qr._TileState({(i, j): torch.empty(0) for i in range(mt)
                        for j in range(mt)})
    return engine.lower_tables(plan, s, st.batch_registry(),
                               arg_width=engine.QR_ARG_WIDTH,
                               row_access=engine.qr_row_access)


def stack_of(torch, a, b):
    """Column-major (ntiles, b, b) tile stack of a and a zero T stack."""
    mt = a.shape[0] // b
    tiles = torch.stack([a[i * b:(i + 1) * b, j * b:(j + 1) * b]
                         for j in range(mt) for i in range(mt)]).contiguous()
    return tiles, torch.zeros_like(tiles)


def phase_walk(torch, np):
    from repro_torch import engine
    n, b = 256, 32
    tables = plan_tables(torch, n, b)
    a = torch.tensor(np.random.default_rng(1).standard_normal((n, n)),
                     dtype=torch.float32, device="cuda")
    tiles, tmat = stack_of(torch, a, b)
    p_tiles, p_tmat = tiles.clone(), tmat.clone()
    desc = torch.as_tensor(tables.desc, device="cuda")
    bounds = tuple(int(x) for x in tables.phase_offsets)
    engine.qr_round_fn(desc, bounds, (), (tiles, tmat))
    engine.qr_walk_plain(tables.desc, bounds, p_tiles, p_tmat)
    torch.cuda.synchronize()
    worst = worst_abs = 0.0
    for got, want in ((tiles, p_tiles), (tmat, p_tmat)):
        for g, w in zip(got, want):
            d = float((g - w).abs().max())
            if not np.isfinite(d):
                fail("walk: non-finite tile")
            worst_abs = max(worst_abs, d)
            worst = max(worst, d / max(1.0, float(w.abs().max())))
    if worst > WALK_TOL:
        fail(f"walk vs plain walk: tile error {worst:.3e} > {WALK_TOL}")
    log(f"[walk] K5 matches the plain walk at {n}² / {b}² tiles "
        f"({tables.nr_items} rows, {tables.nr_phases} phases): worst tile "
        f"max|Δ|/max(1,max|plain|) {worst:.3e} (bound {WALK_TOL}), max|Δ| "
        f"{worst_abs:.3e}")
    return {"abs": worst_abs, "rel": worst}


def run_mode(torch, qr, a, mode):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, _ = qr.run_qr(a, tile=B_MAIN, mode=mode, nr_queues=LANES,
                     device="cuda")
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def phase_main(torch, np):
    from repro_torch.apps import qr
    from repro_torch.kernels.qr_tile import kernel
    a_np = np.random.default_rng(2048).standard_normal(
        (N_MAIN, N_MAIN)).astype(np.float32)
    a = torch.tensor(a_np, device="cuda")
    rs, per_mode, total = {}, {}, dict.fromkeys(kernel.LAUNCHES, 0)
    for mode in MODES:
        kernel.reset_counts()
        rs[mode], secs = run_mode(torch, qr, a, mode)
        per_mode[mode] = dict(kernel.LAUNCHES)
        if any(kernel.PLAIN_CALLS.values()):
            fail(f"{mode}: a plain version ran on the card "
                 f"{kernel.PLAIN_CALLS}")
        for k, v in kernel.LAUNCHES.items():
            total[k] += v
        log(f"[main] {mode}: {secs:.3f} s (first run), launches "
            f"{per_mode[mode]}")
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    for mode in MODES[1:]:
        if not torch.equal(rs[mode], rs["sequential"]):
            d = float((rs[mode] - rs["sequential"]).abs().max())
            fail(f"{mode} R differs from sequential (max |Δ| {d:.3e})")
    r = rs["engine"].double().cpu().numpy()
    a64 = a_np.astype(np.float64)
    if not np.isfinite(r).all() or np.abs(np.tril(r, -1)).max() != 0.0:
        fail("R is not a finite upper-triangular matrix")
    gram = float(np.linalg.norm(r.T @ r - a64.T @ a64)
                 / np.linalg.norm(a64) ** 2)
    r64 = np.linalg.qr(a64, mode="r")
    s = np.sign(np.diag(r)) * np.sign(np.diag(r64))
    lap = float(np.linalg.norm(r * s[:, None] - r64) / np.linalg.norm(r64))
    t0 = time.perf_counter()
    r_cpu, _ = qr.run_qr(a_np, tile=B_MAIN, mode="engine", device="cpu")
    cpu_s = time.perf_counter() - t0
    r_cpu = r_cpu.double().numpy()
    vs_cpu = float(np.linalg.norm(r - r_cpu) / np.linalg.norm(r_cpu))
    log(f"[main] {N_MAIN}² / {B_MAIN}² tiles, {LANES} lanes: four modes "
        f"bitwise equal; Gram {gram:.3e} (bound {GRAM_TOL}); LAPACK fp64 "
        f"up to signs {lap:.3e} (bound {LAPACK_TOL}); engine vs plain CPU "
        f"path {vs_cpu:.3e} (bound {CPU_TOL}; CPU run {cpu_s:.1f} s)")
    for name, val, tol in (("Gram", gram, GRAM_TOL), ("LAPACK", lap,
                           LAPACK_TOL), ("CPU", vs_cpu, CPU_TOL)):
        if not val < tol:
            fail(f"{name} check {val:.3e} >= {tol}")
    log(f"[main] launches over the four modes: {total}")
    return a, total, vs_cpu


def lib_check(torch, one, ra, rv2, cc):
    """The library yardsticks compute the kernels' functions on the timed
    inputs: R up to row signs, the applies element for element."""
    from repro_torch.kernels.qr_tile import ops
    b = one["x"].shape[-1]
    pairs = {
        "geqrf": (torch.triu(torch.geqrf(one["x"])[0]).abs(),
                  torch.triu(one["rv"]).abs()),
        "tsqrf": (torch.triu(torch.geqrf(ra)[0][..., :b, :]).abs(),
                  torch.triu(one["r1"]).abs()),
        "apply_qt": (torch.ormqr(one["rv"], one["tau"], one["c1"], left=True,
                                 transpose=True),
                     ops.apply_qt(one["rv"], one["t"], one["c1"])),
        "apply_tsqt": (torch.ormqr(rv2, one["tau2"], cc, left=True,
                                   transpose=True),
                       torch.cat(ops.apply_tsqt(one["v2"], one["t2"],
                                                one["c1"], one["c2"]), -2)),
    }
    for name, (lib, ours) in pairs.items():
        torch.testing.assert_close(lib, ours, msg=f"{name} yardstick",
                                   **LIB_TOL)
    log("[time] library yardsticks agree with the kernels "
        f"(atol {LIB_TOL['atol']}, rtol {LIB_TOL['rtol']})")


def events_ms(torch, fn, reps):
    """Mean device ms of fn over reps back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_timing(torch, np, a, launches, errs, walk_err, vs_cpu, card):
    from repro_torch import engine
    from repro_torch.apps import qr
    from repro_torch.kernels.qr_tile import kernel, ops, ref

    walls = {}
    for mode in MODES:
        walls[mode] = median_of(lambda: run_mode(torch, qr, a, mode)[1])
    big = torch.tensor(np.random.default_rng(4096).standard_normal(
        (N_LARGE, N_LARGE)), dtype=torch.float32, device="cuda")
    kernel.reset_counts()
    run_mode(torch, qr, big, "engine")                       # warm-up
    per_plan_large = kernel.LAUNCHES["qr_walk"]
    walls[f"engine@{N_LARGE}"] = median_of(
        lambda: run_mode(torch, qr, big, "engine")[1])
    del big
    tables = plan_tables(torch, N_MAIN, B_MAIN)
    lib_qr = events_ms(torch, lambda: torch.linalg.qr(a, mode="r"), 3)
    log(f"[time] run_qr wall s (median of 3): "
        + ", ".join(f"{k} {v:.4f}" for k, v in walls.items())
        + f"; torch.linalg.qr {N_MAIN}² {lib_qr:.3f} ms; walk launches per "
        f"plan {tables.nr_phases} at {N_MAIN}², {per_plan_large} at "
        f"{N_LARGE}²; {card}")

    # per-op kernels at b = 64, batch 1 (the run_one shape) and at the
    # largest batch the rounds mode gives them
    b, rng, dev = B_MAIN, np.random.default_rng(7), torch.device("cuda")

    def rand(n):
        return torch.tensor(rng.standard_normal((n, b, b)),
                            dtype=torch.float32, device=dev)

    def inputs(n):         # factors for the applies, from the kernels
        x, c1, c2 = rand(n), rand(n), rand(n)
        rv, tau, t = ops.geqrf(x)
        r1, v2, tau2, t2 = ops.tsqrf(torch.triu(x), c1)
        return dict(x=x, r0=torch.triu(x), rv=rv, tau=tau, t=t, c1=c1,
                    c2=c2, r1=r1, v2=v2, tau2=tau2, t2=t2,
                    out=torch.empty_like(x),
                    o2=torch.empty_like(x), o3=torch.empty_like(x),
                    tv=torch.empty(x.shape[:2], device=dev))

    def launchers(d):      # the bare launches: outputs preallocated
        return {
            "geqrf": lambda: kernel.geqrf(d["x"], d["out"], d["tv"], d["o2"]),
            "tsqrf": lambda: kernel.tsqrf(d["r0"], d["c1"], d["out"],
                                          d["o2"], d["tv"], d["o3"]),
            "apply_qt": lambda: kernel.apply_qt(d["rv"], d["t"], d["c1"],
                                                d["out"]),
            "apply_tsqt": lambda: kernel.apply_tsqt(d["v2"], d["t2"],
                                                    d["c1"], d["c2"],
                                                    d["out"], d["o2"]),
        }

    one = inputs(1)
    fns = launchers(one)
    plains = {
        "geqrf": lambda: ref.geqrf_ref(one["x"][0]),
        "tsqrf": lambda: ref.tsqrf_ref(torch.triu(one["x"][0]),
                                       one["c1"][0]),
        "apply_qt": lambda: ref.apply_qt_ref(one["rv"][0], one["t"][0],
                                             one["c1"][0]),
        "apply_tsqt": lambda: ref.apply_tsqt_ref(one["v2"][0], one["t2"][0],
                                                 one["c1"][0], one["c2"][0]),
    }
    # the library yardsticks, on the same inputs: tsqrf is the LAPACK QR of
    # the stacked [R; A] (the top reflector block stays e_j, R being upper
    # triangular), and apply_tsqt is ormqr with those stacked reflectors
    # [R'; V2] (R' has nothing below its diagonal) on [C1; C2]
    ra = torch.cat([one["r0"], one["c1"]], -2)
    rv2 = torch.cat([torch.triu(one["r1"]), one["v2"]], -2)
    cc = torch.cat([one["c1"], one["c2"]], -2)
    libs = {
        "geqrf": lambda: torch.geqrf(one["x"]),
        "tsqrf": lambda: torch.geqrf(ra),
        "apply_qt": lambda: torch.ormqr(one["rv"], one["tau"], one["c1"],
                                        left=True, transpose=True),
        "apply_tsqt": lambda: torch.ormqr(rv2, one["tau2"], cc, left=True,
                                          transpose=True),
    }
    lib_check(torch, one, ra, rv2, cc)
    replaces = {"geqrf": "src/repro/kernels/qr_tile/kernel.py:173",
                "tsqrf": "src/repro/kernels/qr_tile/kernel.py:190",
                "apply_qt": "src/repro/kernels/qr_tile/kernel.py:208",
                "apply_tsqt": "src/repro/kernels/qr_tile/kernel.py:221"}
    batch_main = {"apply_qt": 31, "apply_tsqt": 286}  # largest rounds batch
    source = "src/repro_torch/kernels/qr_tile/csrc/qr_tile.cu"
    rows = []
    for name, fn in fns.items():
        ms = median_of(lambda: events_ms(torch, fn, 50))
        plain = median_of(lambda: events_ms(torch, plains[name], 3))
        lib = (median_of(lambda: events_ms(torch, libs[name], 20))
               if name in libs else None)
        bms, by = bound_ms(2 * macs(name, b), tile_bytes(name, b))
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces[name],
                     "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                     "bound_ms": bms, "bound_by": by, "library_ms": lib})
        extra = ""
        if name in batch_main:
            nb = batch_main[name]
            fb = launchers(inputs(nb))[name]
            bms_b, by_b = bound_ms(2 * macs(name, b) * nb,
                                   tile_bytes(name, b, nb))
            extra = (f"; batch {nb}: {median_of(lambda: events_ms(torch, fb, 20)):.5f}"
                     f" ms, bound {bms_b:.5f} ms ({by_b})")
        log(f"[time] {name} b={b} batch 1: {ms:.5f} ms, bound {bms:.6f} ms "
            f"({by}), plain {plain:.3f} ms, library "
            f"{'-' if lib is None else f'{lib:.5f}'} ms{extra}")

    # K5: the whole walk of the 2048² plan, on fresh copies of the stack
    desc = torch.as_tensor(tables.desc, device=dev)
    bounds = tuple(int(x) for x in tables.phase_offsets)
    init = stack_of(torch, a, b)

    def walk_once():
        tiles, tmat = init[0].clone(), init[1].clone()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        engine.qr_round_fn(desc, bounds, (), (tiles, tmat))
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    walk_once()
    walk_ms = median_of(walk_once)
    tiles, tmat = init[0].clone(), init[1].clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.qr_walk_plain(tables.desc, bounds, tiles, tmat)
    torch.cuda.synchronize()
    walk_plain_ms = (time.perf_counter() - t0) * 1e3
    etypes = tables.desc[:, 0]
    names = ("geqrf", "apply_qt", "tsqrf", "apply_tsqt")   # QR_* order
    walk_flops = sum(2 * macs(nm, b) * int((etypes == k).sum())
                     for k, nm in enumerate(names))
    walk_bytes = tables.desc.nbytes + 3 * init[0].numel() * 4
    wbms, wby = bound_ms(walk_flops, walk_bytes)
    rows.append({"name": "qr_walk", "route": "cuda", "source": source,
                 "replaces": "src/repro/engine/megakernel.py:236",
                 "launches": launches["qr_walk"],
                 "max_abs_err": walk_err["abs"],
                 "max_rel_err_per_tile": walk_err["rel"],
                 "main_path_rel_fro_vs_cpu": vs_cpu,
                 "ms": walk_ms, "plain_ms": walk_plain_ms, "bound_ms": wbms,
                 "bound_by": wby, "library_ms": lib_qr})
    log(f"[time] qr_walk {N_MAIN}² plan ({tables.nr_items} rows, "
        f"{tables.nr_phases} launches): {walk_ms:.3f} ms (median of 3), "
        f"bound {wbms:.4f} ms ({wby}, {walk_flops / 1e9:.3f} GFLOP), plain "
        f"walk {walk_plain_ms:.1f} ms (one run), torch.linalg.qr "
        f"{lib_qr:.3f} ms; {card}")
    return rows


def main():
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    import repro_torch  # noqa: F401  (the checkout's port; sets TF32 off)
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        fail("TF32 is on")
    card = phase_device(torch)
    phase_build()
    errs = phase_ops(torch, np)
    walk_err = phase_walk(torch, np)
    a, launches, vs_cpu = phase_main(torch, np)
    rows = phase_timing(torch, np, a, launches, errs, walk_err, vs_cpu,
                        card)
    leaked = sorted(k for k in sys.modules if k == "jax"
                    or k.startswith("jax.") or k == "repro"
                    or k.startswith("repro."))
    if leaked:
        fail(f"imported {leaked}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
