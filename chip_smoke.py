#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one sm_90 card.  It
builds the port's CUDA kernels from the checkout's sources (one nvcc per
source, all at once) and drives the port's paths.  The tiled QR (paper
§4.1) at its benchmark size (2048² fp32, 64² tiles) through
``repro_torch.apps.qr.run_qr``; the Barnes-Hut tree code (§4.2) through
``repro_torch.apps.barneshut.solve`` at 100k particles in all four modes
and at the paper's 1M particles in engine mode; and continuous-batching
serving through ``repro_torch.serve.GenerateService`` of qwen3-1.7b and
starcoder2-7b as published (bf16, 28 and 32 layers) and of
deepseek-v3-671b (MoE + MLA) at full width cut to its first 5 layers
(bf16), random weights from seed 0; the
pipelined value-and-grad through ``repro_torch.pipeline`` at (S, M, Bt, D)
= (8, 64, 32, 2048) in all four modes; and the flash-attention op.
Phases, each fatal when it fails:

 1. the card: name and power limit (nvidia-smi), versions, capability 9.0;
 2. build the kernels (nvcc, sm_90a) and report the build time;
 3. K1-K4 (geqrf, tsqrf, apply_qt, apply_tsqt) against their plain
    PyTorch versions on the card, b in {1, 7, 16, 32, 33, 64, 96, 128}
    (past 64 the global-memory bodies), batch 1 and 8 (a zero column, a
    triangular and a zero tile among the 8);
 4. K5 (the QR task-table walk, one cooperative launch a plan) against the
    plain walk at 256² / 32² tiles, on the 2048² / 64² plan, whose
    longest phase (296 rows) is longer than the resident grid (264
    blocks), and at 1024² / 128², one launch each;
 5. the QR path: run_qr at 2048²/64² in sequential, threaded, rounds and
    engine modes on the card — bitwise equal across modes, R valid (Gram
    identity, float64 LAPACK up to signs), the engine's R equal to the
    plain path's on the CPU within tolerance, and the launch counters
    showing that every QR kernel ran, the engine's plan took one walk
    launch and no plain version ran on the card; then the same at
    1024² / 128² (the global-memory bodies; its launches counted apart);
 6. QR timings (CUDA events, median of 3 after warm-up): run_qr per mode
    at 2048² and engine mode at 4096², launches per plan (one), the walk
    of the 2048² plan beside its barrier floor (the same table with every
    row a QR_NOOP: 125 grid barriers, one launch) and of the 1024² /
    128² plan beside its own, each kernel at b = 64 and 128 beside its
    bound, its plain version and a PyTorch yardstick (torch.geqrf,
    torch.ormqr, torch.linalg.qr — never called by the port);
 7. K6/K7 (acc_pair, acc_self) against their plain versions on the card,
    Ni, Nj in {1, 30, 37, 58, 100, 128, 463, 1000}, with coincident
    particles and zero masses, two launches bitwise equal;
 8. K8 (the Barnes-Hut walk, one warp a bucket over each leaf's real
    particles) against the plain walk over the padded blocks at 20k
    particles, on every real particle (the pads' acc left at zero), two
    walks bitwise equal;
 9. the BH path at 100k particles (n_max 100, n_task 1000, seed 42): solve
    in the four modes on the card, pairwise within 1e-4 per particle, the
    engine within 1e-4 of the plain walk on the CPU, the counters showing
    K6, K7 and K8 launched and no N-body plain version on the card;
10. BH at the paper's 1M particles (n_max 100, n_task 5000, seed 42) in
    engine mode: a float64 recomputation of the interaction lists of 256
    sampled leaves within 1e-4, the float64 direct sum for 4,096 sampled
    targets inside test_barneshut.py's accuracy bounds, and bh_walk
    launches per plan at most the plan's rounds.  The host modes run at
    100k and not at 1M: at 1M they would make about 800k per-op launches
    from Python, more than this script's time limit holds;
11. BH timings: solve per mode at 100k and engine at 1M, split into tree,
    graph, lowering and execution; the walk over the whole 1M plan, with
    the pair interactions it evaluates beside those the data needs and
    those a walk over the padded blocks evaluates; K6 and
    K7 at the path's shapes, each beside its bound and plain version (no
    single PyTorch call computes softened gravity, so they have no
    library yardstick), and K6 at 30 x 0 (no source: its launch floor);
12. K10 (paged GQA decode) against its plain version on the card: the
    reduced and the published widths of qwen3-1.7b (16/8 heads) and
    starcoder2-7b (36/4), page 8 and 16, fp32 and bf16, bs 1, 3 and 8,
    n_rep 16 (32/2) and hd 20 (rows not on 16 bytes); 8 slots at
    positions 256-319 (up to 40 pages) at
    both head shapes; NaN unlisted pages, stale non-finite tails, two
    launches bitwise equal (the split walk merges in a fixed order), a
    second slot's pages bitwise untouched;
13. the serving path at full width on decode_path "auto", the launcher's
    workload (a: 4 slots, prompt 8, up to 32 new tokens, 12 requests) and
    one that walks and reuses 40 pages a slot (b: 8 slots, prompt 256, up
    to 64, 24 requests): every request done with its budget, the pool
    empty, path "kernel", degrade level 0, no retries, K10 launched layers
    x decode ticks times and no plain version; timings (wall, tok/s, TTFT
    median and p90, each tick's host plan and its round on the host and
    the device, peak memory) and a profiler window over steady ticks; bf16
    kernel vs gather logits over 16 teacher-forced steps; workload (a)
    token for token, kernel vs gather, in an fp32 copy of the config;
14. K10 timings at the path's shapes (one launch on each of 28 layer
    pools in a CUDA graph), and at (b)'s with starcoder2-7b's heads,
    beside its bound, its plain version and
    F.scaled_dot_product_attention over the window gathered beforehand
    (the yardstick, never called by the port);
14a. with qwen3 freed, starcoder2-7b as published (bf16, 32 layers, 36/4
    heads of 128, 10.1e9 weights) through GenerateService on "auto" (K10)
    for workload (a): every request done, the pool empty, path "kernel",
    K10 launched layers x ticks times, no plain version; its wall time and
    tok/s; bf16 kernel vs gather logits over 16 teacher-forced steps
    within the qwen3 limit, a planted fault above it at every step;
15. K11 (paged MLA decode) against its plain version on the card: H 4 /
    lat 32 / rope 16 (--reduced), lat 16 / rope 8, and H 128 / lat 512 /
    rope 64 (published), page 8 and 16, fp32 and bf16 (bf16: the
    tensor-core kernel), H 6 / lat 40 / rope 12 and H 3 / lat 20 / rope 4
    in bf16, bs 1, 3 and 8; 8 slots at positions 256-319 (up to 40
    pages); stale non-finite tails, NaN unlisted pages, a second slot's
    pages bitwise untouched, two bf16 launches bitwise equal;
16. the MoE + MLA serving path: deepseek-v3-671b at full width, 5 layers
    (3 dense, 2 MoE of 256 routed + 1 shared experts), bf16, after the
    qwen3 model is freed, through GenerateService on "auto" for the same
    two workloads: every request done with its budget, the pool empty,
    path "kernel", degrade level 0, no retries, K11 launched layers x
    decode ticks times, K10 never, no plain version; its timings and a
    profiler window (K11's and the expert products' shares); bf16 kernel
    vs gather logits over 16 teacher-forced steps (the median step within
    a limit that every step of a planted fault exceeds); workload (a)
    token for token in an fp32 copy of 1 dense + 1 MoE layer;
17. K11 timings at the path's shapes, workload (b)'s 8 slots x 37 pages
    and (a)'s 4 x 3 (28 layer pools in a CUDA graph), beside its bound
    (bytes), its plain version and F.scaled_dot_product_attention with one
    shared KV head (the yardstick, never called by the port);
18. K9 (the pipeline F/B/U walk) against its plain walk on the card at
    (S, M, Bt, D) in (3, 6, 4, 8), (8, 64, 4, 32) (the reference's widths),
    S, M or Bt = 1, D = 40 and 100: every state buffer within rtol 1e-5,
    atol 1e-6 (the reference's pipeline tolerance); at (8, 64, 32, 2048),
    (2, 3, 40, 600) and (3, 2, 65, 513), where the reductions split and
    Bt spans row tiles, every buffer within 1e-5 relative (Frobenius),
    a limit the plain walk under TF32 must fail; two runs bitwise equal;
19. the pipeline path at (8, 64, 32, 2048), fp32, weights N(0, 1/D) from
    seed 0: pipelined_value_and_grad_plan in the four modes, each against a
    float64 autograd of the monolithic loss (loss and every gradient leaf
    within 1e-5 relative, a limit the sequential mode under TF32 must
    fail), K9 launched once for the engine's plan (one cooperative launch
    over its 143 phases), no plain version, two engine runs bitwise equal;
20. pipeline timings: each mode's wall time, the K9 walk beside its bound
    (operations) and beside the row-by-row traffic floor (W_s re-read a
    row, gW_s read and written a B row), with the share of each it
    reaches, and beside K9 rebuilt with one reduction split a tile (what
    split-K gains), the plain walk, and the float32 autograd of the
    monolithic loss as context (no single PyTorch call computes K9's
    function);
21. K12 (flash attention) against its plain version on the card: fp32 and
    bf16, causal and not, (BH, S, hd) in (4, 128, 64), (4, 256, 64), (4,
    512, 64), (2, 128, 32), (2, 256, 128), blocks 64 and 128, and
    FA_WIDE: hd 48, 50, 112, 256, 320 and 512 (above 256 the chunked
    path), caller blocks 32, 96 and 256, Sq != Sk (124 cases); the op on a
    ragged S = 100, v = ones; then the op itself
    once at (B, S, H, hd) = (1, 4096, 16, 128), causal, bf16, launching
    K12 and no plain version;
22. K12 timings there beside its bound (operations at the bf16 rate), its
    plain version and F.scaled_dot_product_attention (the yardstick, never
    called by the port); the op's output there against the plain version,
    every row within 2e-2 relative, a limit an output without the last 64
    keys must fail; then at hd 112 (zamba2-7b's width), held the same way.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script imports
nothing of jax and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import contextlib
import itertools
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
N_WIDE, B_WIDE = 1024, 128       # tiles past 64: the global-memory bodies
# K1-K4 tile sizes: edges of the kernels' 4-row and 4-thread blocks, the
# reference tests' and run_qr's 32, the paper's 64, and tiles past 64
# (the global-memory bodies)
OP_SIZES = (1, 7, 16, 32, 33, 64, 96, 128)
N_LARGE = 4096
LANES = 4
MODES = ("sequential", "threaded", "rounds", "engine")
FP32_PEAK = 67e12     # H100 SXM fp32 outside the tensor cores (data sheet)
BF16_PEAK = 989e12    # H100 SXM bf16 dense on the tensor cores, float
#                       accumulation (data sheet): bf16 products are exact in
#                       float, so this rate computes the same function
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

N_BH, NTASK_BH = 100_000, 1000           # benchmarks/bh_scaling.py default
N_PAPER, NTASK_PAPER = 1_000_000, 5000   # the paper's benchmark (§4.2)
NMAX_BH, SEED_BH = 100, 42               # bh_scaling.py: n_max, its seed
N_WALK, NMAX_WALK, NTASK_WALK = 20_000, 64, 256   # K8 vs the plain walk
BH_TOL = 1e-4     # per particle ‖Δa‖/‖a‖: the reference's cross-mode
#                   tolerance (tests/test_backends.py), float32 sums in
#                   other orders
NB_RTOL, NB_ATOL = 2e-4, 1e-5   # K6-K8 vs plain, per target: ‖Δa‖ <=
#                   2e-4 ‖a‖ + 1e-5, the reference's kernel tolerance
#                   (tests/test_kernels_nbody.py) on each target's vector:
#                   a component that cancels to ~1 out of terms of ~10³
#                   keeps no relative precision in any float32 sum
ACC_MEDIAN, ACC_MEAN = 2e-2, 5e-2  # BH vs the direct sum, per-particle
#                   relative error: tests/test_barneshut.py's bounds
FLOPS_PER_PAIR = 19   # one softened pair: 3 sub, 3 mul + 3 add (r²),
#                   rsqrt, 3 mul (w³·m), 3 fma (a += Δx·w), rsqrt as one
SAMPLE_LEAVES, SAMPLE_TARGETS = 256, 4096


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


def bound_ms(flops, nbytes, peak=FP32_PEAK):
    """The least time for the work: operations at ``peak``, the card's rate
    for the operands' type, or bytes at the memory rate, the larger."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
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
    mods = kernel_modules()
    t0 = time.perf_counter()
    _build.build([k.SOURCE for k in mods])       # one nvcc each, in parallel
    for k in mods:
        k.lib()
    log(f"[build] {', '.join(k.SOURCE.name for k in mods)} built (nvcc, "
        f"sm_90a) and loaded in {time.perf_counter() - t0:.2f} s into "
        f"{_build.build_dir()}")


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

    for b in OP_SIZES:
        for n in (1, 8):
            x = [torch.tensor(rng.standard_normal((n, b, b)), dtype=torch.float32,
                              device=dev) for _ in range(4)]
            a, c1, c2, r0 = x
            r0 = torch.triu(r0)        # tsqrf's R: a random triangle (R = 0
            #                            leaves T and V2 ill-conditioned in
            #                            float32: no two orders agree there)
            if n == 8:                 # Householder guards in each op's
                for y in (a, c1, c2):  # dense input: zero column,
                    y[1, :, min(3, b - 1)] = 0.0   # already-triangular
                    y[2] = torch.triu(y[2])        # tile, zero tile
                    y[3] = 0.0
            got = ops.geqrf(a)
            plain = [ref.geqrf_ref(t) for t in a]
            for i, p in enumerate(plain):
                check("geqrf", [g[i] for g in got], p)
            rv, t = torch.stack([p[0] for p in plain]), torch.stack(
                [p[2] for p in plain])
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
    log(f"[ops] K1-K4 match their plain versions, b in {OP_SIZES}, batch "
        f"1 and 8 (zero column, triangular and zero tiles), atol 2e-5 rtol "
        f"1e-4; max |err| {errs}")
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


def walk_tiles(torch, np, tables, a, b):
    """K5 (one launch, as execute_plan hands it the table) and the plain
    walk from the same stack; returns the worst tile's max|Δ|/max(1,
    max|plain|), max|Δ| and the plain walk's ms (host clock, one run)."""
    from repro_torch import engine
    from repro_torch.kernels.qr_tile import kernel
    tiles, tmat = stack_of(torch, a, b)
    p_tiles, p_tmat = tiles.clone(), tmat.clone()
    desc, phases = engine.upload_phases(tables.desc, tables.phase_offsets,
                                        "cuda")
    kernel.reset_counts()
    engine.qr_round_fn(desc, phases, (), (tiles, tmat))
    torch.cuda.synchronize()
    if kernel.LAUNCHES["qr_walk"] != 1 or any(kernel.PLAIN_CALLS.values()):
        fail(f"walk at {a.shape[0]}²: launches {kernel.LAUNCHES}, plain "
             f"{kernel.PLAIN_CALLS}")
    t0 = time.perf_counter()
    engine.qr_walk_plain(tables.desc, tables.phase_offsets, p_tiles, p_tmat)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = worst_abs = 0.0
    for got, want in ((tiles, p_tiles), (tmat, p_tmat)):
        for g, w in zip(got, want):
            d = float((g - w).abs().max())
            if not np.isfinite(d):
                fail("walk: non-finite tile")
            worst_abs = max(worst_abs, d)
            worst = max(worst, d / max(1.0, float(w.abs().max())))
    if worst > WALK_TOL:
        fail(f"walk vs plain walk at {a.shape[0]}² / {b}²: tile error "
             f"{worst:.3e} > {WALK_TOL}")
    return worst, worst_abs, plain_ms


def phase_walk(torch, np):
    """K5 against the plain walk at 256² / 32², on the main path's
    2048² / 64² plan, whose longest phase is longer than the resident
    grid, and at 1024² / 128² (the global-memory bodies)."""
    from repro_torch.kernels.qr_tile import kernel
    out = {"abs": 0.0, "rel": 0.0}
    for n, b in ((256, 32), (N_MAIN, B_MAIN), (N_WIDE, B_WIDE)):
        tables = plan_tables(torch, n, b)
        grid = kernel.walk_grid(b)
        longest = int(tables.stats["max_phase_len"])
        if n == N_MAIN and not longest > grid:
            fail(f"the {n}² plan's longest phase ({longest} rows) fits the "
                 f"resident grid ({grid} blocks): it no longer tests turns")
        a = torch.tensor(np.random.default_rng(n + 1).standard_normal(
            (n, n)), dtype=torch.float32, device="cuda")
        worst, worst_abs, plain_ms = walk_tiles(torch, np, tables, a, b)
        out["abs"], out["rel"] = (max(out["abs"], worst_abs),
                                  max(out["rel"], worst))
        log(f"[walk] K5 (one launch, {grid} resident blocks at b = {b}) "
            f"matches the plain walk at {n}² / {b}² tiles ({tables.nr_items} "
            f"rows, {tables.nr_phases} phases, longest {longest}): worst "
            f"tile max|Δ|/max(1,max|plain|) {worst:.3e} (bound {WALK_TOL}), "
            f"max|Δ| {worst_abs:.3e}; plain walk {plain_ms:.1f} ms")
        if n == N_MAIN:
            out["plain_ms"], out["grid"] = plain_ms, grid
        if n == N_WIDE:
            out["plain_ms_wide"], out["grid_wide"] = plain_ms, grid
    return out


def run_mode(torch, qr, a, mode, tile=B_MAIN):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, _ = qr.run_qr(a, tile=tile, mode=mode, nr_queues=LANES,
                     device="cuda")
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def phase_main(torch, np):
    """run_qr at 2048² / 64² (the main path: its launches are the kernels
    line's), then at 1024² / 128² (the global-memory bodies), each in the
    four modes with every check."""
    a, total, vs_cpu = qr_modes(torch, np, N_MAIN, B_MAIN, "main")
    wide = qr_modes(torch, np, N_WIDE, B_WIDE, "main-wide")
    return a, total, vs_cpu, {"launches": wide[1], "vs_cpu": wide[2]}


def qr_modes(torch, np, n, b, tag):
    from repro_torch.apps import qr
    from repro_torch.kernels.qr_tile import kernel
    a_np = np.random.default_rng(n).standard_normal((n, n)).astype(
        np.float32)
    a = torch.tensor(a_np, device="cuda")
    rs, per_mode, total = {}, {}, dict.fromkeys(kernel.LAUNCHES, 0)
    for mode in MODES:
        kernel.reset_counts()
        rs[mode], secs = run_mode(torch, qr, a, mode, b)
        per_mode[mode] = dict(kernel.LAUNCHES)
        if any(kernel.PLAIN_CALLS.values()):
            fail(f"{mode}: a plain version ran on the card "
                 f"{kernel.PLAIN_CALLS}")
        for k, v in kernel.LAUNCHES.items():
            total[k] += v
        log(f"[{tag}] {mode}: {secs:.3f} s (first run), launches "
            f"{per_mode[mode]}")
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the {n}² / {b}² path: {missing}")
    if per_mode["engine"]["qr_walk"] != 1:
        fail(f"the engine's plan took {per_mode['engine']['qr_walk']} walk "
             f"launches, not one")
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
    r_cpu, _ = qr.run_qr(a_np, tile=b, mode="engine", device="cpu")
    cpu_s = time.perf_counter() - t0
    r_cpu = r_cpu.double().numpy()
    vs_cpu = float(np.linalg.norm(r - r_cpu) / np.linalg.norm(r_cpu))
    log(f"[{tag}] {n}² / {b}² tiles, {LANES} lanes: four modes "
        f"bitwise equal; Gram {gram:.3e} (bound {GRAM_TOL}); LAPACK fp64 "
        f"up to signs {lap:.3e} (bound {LAPACK_TOL}); engine vs plain CPU "
        f"path {vs_cpu:.3e} (bound {CPU_TOL}; CPU run {cpu_s:.1f} s)")
    for name, val, tol in (("Gram", gram, GRAM_TOL), ("LAPACK", lap,
                           LAPACK_TOL), ("CPU", vs_cpu, CPU_TOL)):
        if not val < tol:
            fail(f"{name} check {val:.3e} >= {tol}")
    log(f"[{tag}] launches over the four modes: {total}")
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


def graph_ms(torch, fn, reps=50):
    """Device ms per call of fn: reps calls captured in one CUDA graph and
    replayed between two events, so no host enqueue is in the timed
    region (a kernel shorter than its Python launch is otherwise timed by
    the host)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_timing(torch, np, a, launches, errs, walk_err, vs_cpu, wide,
                 card):
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
    kernel.reset_counts()
    run_mode(torch, qr, a, "engine")
    per_plan = kernel.LAUNCHES["qr_walk"]
    if (per_plan, per_plan_large) != (1, 1):
        fail(f"walk launches per plan {per_plan} at {N_MAIN}², "
             f"{per_plan_large} at {N_LARGE}²: not one")
    lib_qr = median_of(lambda: events_ms(
        torch, lambda: torch.linalg.qr(a, mode="r"), 3))
    log(f"[time] run_qr wall s (median of 3): "
        + ", ".join(f"{k} {v:.4f}" for k, v in walls.items())
        + f"; torch.linalg.qr {N_MAIN}² {lib_qr:.3f} ms; walk launches per "
        f"plan {per_plan} at {N_MAIN}² ({tables.nr_phases} phases), "
        f"{per_plan_large} at {N_LARGE}²; {card}")

    # per-op kernels at b = 64, batch 1 (the run_one shape) and at the
    # largest batch the rounds mode gives them; then at b = 128 (the
    # global-memory bodies), batch 1
    dev = torch.device("cuda")
    replaces = {"geqrf": "src/repro/kernels/qr_tile/kernel.py:173",
                "tsqrf": "src/repro/kernels/qr_tile/kernel.py:190",
                "apply_qt": "src/repro/kernels/qr_tile/kernel.py:208",
                "apply_tsqt": "src/repro/kernels/qr_tile/kernel.py:221"}
    batch_main = {"apply_qt": 31, "apply_tsqt": 286}  # largest rounds batch
    source = "src/repro_torch/kernels/qr_tile/csrc/qr_tile.cu"

    def op_times(b):
        rng = np.random.default_rng(7)

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
                "geqrf": lambda: kernel.geqrf(d["x"], d["out"], d["tv"],
                                              d["o2"]),
                "tsqrf": lambda: kernel.tsqrf(d["r0"], d["c1"], d["out"],
                                              d["o2"], d["tv"], d["o3"]),
                "apply_qt": lambda: kernel.apply_qt(d["rv"], d["t"],
                                                    d["c1"], d["out"]),
                "apply_tsqt": lambda: kernel.apply_tsqt(
                    d["v2"], d["t2"], d["c1"], d["c2"], d["out"], d["o2"]),
            }

        one = inputs(1)
        fns = launchers(one)
        plains = {
            "geqrf": lambda: ref.geqrf_ref(one["x"][0]),
            "tsqrf": lambda: ref.tsqrf_ref(torch.triu(one["x"][0]),
                                           one["c1"][0]),
            "apply_qt": lambda: ref.apply_qt_ref(one["rv"][0], one["t"][0],
                                                 one["c1"][0]),
            "apply_tsqt": lambda: ref.apply_tsqt_ref(
                one["v2"][0], one["t2"][0], one["c1"][0], one["c2"][0]),
        }
        # the library yardsticks, on the same inputs: tsqrf is the LAPACK
        # QR of the stacked [R; A] (the top reflector block stays e_j, R
        # being upper triangular), and apply_tsqt is ormqr with those
        # stacked reflectors [R'; V2] (R' has nothing below its diagonal)
        # on [C1; C2]
        ra = torch.cat([one["r0"], one["c1"]], -2)
        rv2 = torch.cat([torch.triu(one["r1"]), one["v2"]], -2)
        cc = torch.cat([one["c1"], one["c2"]], -2)
        libs = {
            "geqrf": lambda: torch.geqrf(one["x"]),
            "tsqrf": lambda: torch.geqrf(ra),
            "apply_qt": lambda: torch.ormqr(one["rv"], one["tau"],
                                            one["c1"], left=True,
                                            transpose=True),
            "apply_tsqt": lambda: torch.ormqr(rv2, one["tau2"], cc,
                                              left=True, transpose=True),
        }
        lib_check(torch, one, ra, rv2, cc)
        out = {}
        for name, fn in fns.items():
            ms = median_of(lambda: events_ms(torch, fn, 50 if b <= 64
                                             else 10))
            plain = median_of(lambda: events_ms(torch, plains[name], 3))
            lib = median_of(lambda: events_ms(torch, libs[name], 20))
            bms, by = bound_ms(2 * macs(name, b), tile_bytes(name, b))
            out[name] = (ms, plain, lib, bms, by)
            extra = ""
            if b == B_MAIN and name in batch_main:
                nb = batch_main[name]
                fb = launchers(inputs(nb))[name]
                bms_b, by_b = bound_ms(2 * macs(name, b) * nb,
                                       tile_bytes(name, b, nb))
                extra = (f"; batch {nb}: "
                         f"{median_of(lambda: events_ms(torch, fb, 20)):.5f}"
                         f" ms, bound {bms_b:.5f} ms ({by_b})")
            log(f"[time] {name} b={b} batch 1: {ms:.5f} ms, bound "
                f"{bms:.6f} ms ({by}), plain {plain:.3f} ms, library "
                f"{lib:.5f} ms{extra}; {card}")
        return out

    per_op = op_times(B_MAIN)
    per_op_wide = op_times(B_WIDE)
    rows = []
    for name, (ms, plain, lib, bms, by) in per_op.items():
        wms, wplain, wlib, wbms, _ = per_op_wide[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces[name],
                     "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                     "bound_ms": bms, "bound_by": by, "library_ms": lib,
                     "ms_b128": wms, "plain_ms_b128": wplain,
                     "bound_ms_b128": wbms, "library_ms_b128": wlib,
                     "launches_1024_b128": wide["launches"][name]})

    # K5: the whole walk of the 2048² plan, on fresh copies of the stack,
    # desc and offsets uploaded beforehand (as execute_plan does); beside
    # it the barrier floor: the same table with every row a no-op; then
    # the 1024² / 128² plan (the global-memory bodies)
    def walk_times(mat, b):
        tab = plan_tables(torch, mat.shape[0], b)
        init = stack_of(torch, mat, b)
        noops = tab.desc.copy()
        noops[:, 0] = engine.QR_NOOP

        def walk_ms_of(table):
            desc, phases = engine.upload_phases(table, tab.phase_offsets,
                                                dev)

            def once():
                tiles, tmat = init[0].clone(), init[1].clone()
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                engine.qr_round_fn(desc, phases, (), (tiles, tmat))
                e1.record()
                torch.cuda.synchronize()
                return e0.elapsed_time(e1)

            once()
            return median_of(once)

        etypes = tab.desc[:, 0]
        names = ("geqrf", "apply_qt", "tsqrf", "apply_tsqt")  # QR_* order
        flops = sum(2 * macs(nm, b) * int((etypes == k).sum())
                    for k, nm in enumerate(names))
        nbytes = tab.desc.nbytes + 3 * init[0].numel() * 4
        return (tab, walk_ms_of(tab.desc), walk_ms_of(noops),
                *bound_ms(flops, nbytes), flops)

    tables, walk_ms, floor_ms, wbms, wby, walk_flops = walk_times(a, B_MAIN)
    walk_plain_ms = walk_err["plain_ms"]
    mid = torch.tensor(np.random.default_rng(N_WIDE).standard_normal(
        (N_WIDE, N_WIDE)), dtype=torch.float32, device="cuda")
    tab_w, walk_w, floor_w, wbms_w, _, flops_w = walk_times(mid, B_WIDE)
    lib_w = median_of(lambda: events_ms(
        torch, lambda: torch.linalg.qr(mid, mode="r"), 3))
    rows.append({"name": "qr_walk", "route": "cuda", "source": source,
                 "replaces": "src/repro/engine/megakernel.py:236",
                 "launches": launches["qr_walk"],
                 "max_abs_err": walk_err["abs"],
                 "max_rel_err_per_tile": walk_err["rel"],
                 "main_path_rel_fro_vs_cpu": vs_cpu,
                 "ms": walk_ms, "plain_ms": walk_plain_ms, "bound_ms": wbms,
                 "bound_by": wby, "library_ms": lib_qr,
                 "launches_per_plan": per_plan, "phases": tables.nr_phases,
                 "barrier_floor_ms": floor_ms,
                 "resident_grid": walk_err["grid"],
                 "library": "torch.linalg.qr(mode='r'), 2048² fp32",
                 "ms_1024_b128": walk_w, "barrier_floor_ms_1024_b128": floor_w,
                 "plain_ms_1024_b128": walk_err["plain_ms_wide"],
                 "bound_ms_1024_b128": wbms_w, "library_ms_1024": lib_w,
                 "launches_1024_b128": wide["launches"]["qr_walk"],
                 "rel_fro_vs_cpu_1024_b128": wide["vs_cpu"],
                 "resident_grid_b128": walk_err["grid_wide"]})
    log(f"[time] qr_walk {N_MAIN}² plan ({tables.nr_items} rows, "
        f"{tables.nr_phases} phases, {per_plan} launch, "
        f"{walk_err['grid']} resident blocks): {walk_ms:.3f} ms (median of "
        f"3), barrier floor (every row a no-op) {floor_ms:.4f} ms, bound "
        f"{wbms:.4f} ms ({wby}, {walk_flops / 1e9:.3f} GFLOP), plain walk "
        f"{walk_plain_ms:.1f} ms (one run, phase 4), torch.linalg.qr "
        f"{lib_qr:.3f} ms; {card}")
    log(f"[time] qr_walk {N_WIDE}² / {B_WIDE}² plan ({tab_w.nr_items} rows, "
        f"{tab_w.nr_phases} phases, one launch, {walk_err['grid_wide']} "
        f"resident blocks): {walk_w:.3f} ms (median of 3), barrier floor "
        f"{floor_w:.4f} ms, bound {wbms_w:.4f} ms ({flops_w / 1e9:.3f} "
        f"GFLOP), plain walk {walk_err['plain_ms_wide']:.1f} ms (one run, "
        f"phase 4), torch.linalg.qr {N_WIDE}² {lib_w:.3f} ms; {card}")
    return rows


# ---------------------------------------------------------------------------
# Barnes-Hut (paper §4.2)
# ---------------------------------------------------------------------------

def bh_inputs(np, n):
    """bh_scaling.py's particles: uniform in the unit cube, masses in
    [0.5, 1.5), from seed 42."""
    rng = np.random.default_rng(SEED_BH)
    return rng.random((n, 3)), rng.random(n) + 0.5


def rel_err(np, a, want):
    """Per-particle relative error ‖Δa‖/‖a‖ of (3, N) float64 arrays."""
    num = np.linalg.norm(a - want, axis=0)
    return num / np.maximum(np.linalg.norm(want, axis=0), 1e-12)


def vec_check(np, name, got, want, axis):
    """Hold a kernel's output against its plain version per target vector
    (coordinates along ``axis``); returns (max |Δ| of any element, worst
    ‖Δ‖ / (NB_RTOL ‖want‖ + NB_ATOL))."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    if not np.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    ratio = float((np.linalg.norm(g - w, axis=axis)
                   / (NB_RTOL * np.linalg.norm(w, axis=axis)
                      + NB_ATOL)).max())
    if ratio > 1.0:
        fail(f"{name}: kernel vs plain {ratio:.3f}× the tolerance")
    return float(np.abs(g - w).max()), ratio


def phase_nbody_ops(torch, np):
    """K6/K7 against their plain versions on the card; each launch again
    gives the same bits."""
    from repro_torch.kernels.nbody import ops, ref
    sizes = (1, 30, 37, 58, 100, 128, 463, 1000)
    rng = np.random.default_rng(6)
    errs = {"acc_pair": [0.0, 0.0], "acc_self": [0.0, 0.0]}

    def cloud(n):
        x = torch.tensor(rng.random((3, n)), dtype=torch.float32,
                         device="cuda")
        m = torch.tensor(rng.random(n) + 0.1, dtype=torch.float32,
                         device="cuda")
        return x, m

    def keep(name, op, *args):
        got = op(*args)
        if not torch.equal(got, op(*args)):
            fail(f"{name}: two launches differ")
        want = getattr(ref, name + "_ref")(*args)
        e = vec_check(np, name, got, want, axis=0)
        errs[name] = [max(a, b) for a, b in zip(errs[name], e)]

    for ni in sizes:
        xi, mi = cloud(ni)
        if ni > 2:                     # a pair of coincident particles and
            xi[:, 1] = xi[:, 0]        # a zero mass inside the self set
            mi[ni // 2] = 0.0
        keep("acc_self", ops.acc_self, xi, mi)
        for nj in sizes:
            xj, mj = cloud(nj)
            xj[:, : min(3, nj)] = xi[:, :1]      # sources on a target
            mj[nj - nj // 4:] = 0.0              # zero-mass tail
            keep("acc_pair", ops.acc_pair, xi, xj, mj)
    torch.cuda.synchronize()
    log(f"[nbody] K6/K7 match their plain versions, Ni, Nj in {sizes}, "
        f"coincident particles and zero masses, per target ‖Δa‖ <= "
        f"{NB_RTOL}‖a‖ + {NB_ATOL}, two launches bitwise equal: max |err|, "
        f"worst share of the bound {errs}")
    return errs


def bh_table(torch, g, st):
    from repro_torch import engine
    from repro_torch.core import lower
    plan = lower(g.sched, LANES)
    tab = engine.lower_tables(plan, g.sched, st.batch_registry(),
                              arg_width=engine.BH_ARG_WIDTH,
                              row_access=engine.bh_row_access)
    return tab, engine.launch_groups(tab, engine.bh_row_keys)


def phase_bh_walk(torch, np):
    """K8 against the plain walk on the card, one table: every real
    particle (K8 walks only the real ones and leaves the pads' acc at
    zero) and every COM row; two walks bitwise equal."""
    from repro_torch import engine
    from repro_torch.apps import barneshut as bh
    rng = np.random.default_rng(N_WALK)
    x, m = rng.random((N_WALK, 3)), rng.random(N_WALK) + 0.5
    g = bh.build_graph(bh.Octree(x, m, n_max=NMAX_WALK), n_task=NTASK_WALK,
                       nr_queues=LANES)
    st = bh.BHState(g, device="cuda")
    tab, lg = bh_table(torch, g, st)
    hooks = st.engine_hooks()
    statics = hooks.statics()
    xs, ms, counts = statics
    walked, again, plain = hooks.buffers(), hooks.buffers(), hooks.buffers()
    desc = torch.as_tensor(tab.desc[lg.order], device="cuda")
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    hooks.round_fn(desc, lg, statics, walked)
    e1.record()
    torch.cuda.synchronize()
    walk_ms = e0.elapsed_time(e1)
    hooks.round_fn(desc, lg, statics, again)
    t0 = time.perf_counter()
    engine.bh_walk_plain(tab.desc, xs, ms, *plain, st.eps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(walked, again)):
        fail("bh_walk: two walks differ")
    real = (torch.arange(xs.shape[2], device="cuda")[None, :]
            < counts[:, None])
    acc_w, acc_p = walked[0].permute(0, 2, 1), plain[0].permute(0, 2, 1)
    if bool(acc_w[~real].any()):
        fail("bh_walk wrote a pad particle's acceleration")
    errs = [vec_check(np, "bh_walk acc", acc_w[real], acc_p[real], axis=1)]
    errs += [vec_check(np, f"bh_walk {name}", a, b, axis=1)
             for name, a, b in zip(("com", "cmass"), walked[1:], plain[1:])]
    err = {"abs": max(e[0] for e in errs), "ratio": max(e[1] for e in errs)}
    log(f"[bh-walk] K8 matches the plain walk at {N_WALK} particles (n_max "
        f"{NMAX_WALK}, {tab.nr_items} rows, {tab.nr_rounds} rounds, "
        f"{lg.nr_groups} launches, {lg.nr_buckets} buckets; "
        f"{int(real.sum())} real particles in {xs.shape[0]} blocks of "
        f"{xs.shape[2]}) on every real particle: max |err| "
        f"{err['abs']:.3e}, worst share of the bound {err['ratio']:.3e}; "
        f"the pads' acc untouched; two walks bitwise equal; walk "
        f"{walk_ms:.3f} ms (first launch), plain walk {plain_ms:.1f} ms "
        f"(one run)")
    return err, walk_ms, plain_ms, tab.nr_items


def phase_bh_main(torch, np):
    """The BH path at 100k particles in the four modes."""
    from repro_torch.apps import barneshut as bh
    from repro_torch.kernels.nbody import kernel as nbk
    x, m = bh_inputs(np, N_BH)
    accs, firsts, per_mode = {}, {}, {}
    nbk.reset_counts()
    for mode in MODES:
        before = dict(nbk.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, _, _ = bh.solve(x, m, n_max=NMAX_BH, n_task=NTASK_BH,
                             mode=mode, nr_workers=LANES, device="cuda")
        torch.cuda.synchronize()
        firsts[mode] = time.perf_counter() - t0
        accs[mode] = acc.double().cpu().numpy()
        per_mode[mode] = {k: v - before[k] for k, v in nbk.LAUNCHES.items()}
        log(f"[bh-main] {mode} at {N_BH}: {firsts[mode]:.3f} s (first "
            f"run), launches {per_mode[mode]}")
    launches = dict(nbk.LAUNCHES)
    if any(nbk.PLAIN_CALLS.values()):
        fail(f"an N-body plain version ran on the card {nbk.PLAIN_CALLS}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"BH kernels never launched on the BH path: {missing}")
    worst = 0.0
    for a, b in itertools.combinations(MODES, 2):
        e = float(rel_err(np, accs[a], accs[b]).max())
        worst = max(worst, e)
        if not e < BH_TOL:
            fail(f"BH {a} vs {b}: per-particle error {e:.3e} >= {BH_TOL}")
    if not all(np.isfinite(a).all() for a in accs.values()):
        fail("BH: non-finite accelerations")
    t0 = time.perf_counter()
    cpu, _, _ = bh.solve(x, m, n_max=NMAX_BH, n_task=NTASK_BH,
                         mode="engine", nr_workers=LANES, device="cpu")
    cpu_s = time.perf_counter() - t0
    vs_cpu = float(rel_err(np, accs["engine"], cpu.double().numpy()).max())
    if not vs_cpu < BH_TOL:
        fail(f"BH engine vs the plain walk on the CPU: {vs_cpu:.3e}")
    log(f"[bh-main] {N_BH} particles, four modes pairwise within "
        f"{worst:.3e} per particle (bound {BH_TOL}); engine vs the plain "
        f"walk on the CPU {vs_cpu:.3e} (CPU run {cpu_s:.1f} s); launches "
        f"{launches}")
    return launches, firsts


def pull64(np, xi, xj, mj, eps, skip_self=False):
    dx = xj[:, None, :] - xi[:, :, None]
    w = ((dx * dx).sum(0) + eps * eps) ** -1.5 * mj[None, :]
    if skip_self:
        np.fill_diagonal(w, 0.0)
    return np.einsum("dij,ij->di", dx, w)


def sampled_lists_f64(np, g, acc, eps):
    """Worst per-particle error of ``acc`` (3, N) against a float64
    recomputation of the interaction lists of SAMPLE_LEAVES sampled
    leaves: direct self block and pairs, COM sources from float64 prefix
    sums of the float32 particles."""
    t = g.tree
    x = t.x.astype(np.float32).astype(np.float64)
    m = t.m.astype(np.float32).astype(np.float64)
    partners = {}
    for pairs in itertools.chain(g.self_pairs.values(),
                                 g.pair_pairs.values()):
        for a, b in pairs:
            partners.setdefault(a, []).append(b)
            partners.setdefault(b, []).append(a)
    pcs = {g.task_cell[tid][1]: s for tid, s in g.pc_lists.items()}
    cm = np.concatenate([[0.0], np.cumsum(m)])
    cxm = np.concatenate([np.zeros((3, 1)), np.cumsum(x * m, 1)], 1)
    leaves = [c.cid for c in t.cells if not c.split]
    pick = np.random.default_rng(256).choice(len(leaves), SAMPLE_LEAVES,
                                             replace=False)
    worst = 0.0

    def rng(c):
        return slice(t.cells[c].start, t.cells[c].start + t.cells[c].count)

    for k in pick:
        leaf = leaves[k]
        r = rng(leaf)
        want = pull64(np, x[:, r], x[:, r], m[r], eps, skip_self=True)
        srcs = partners.get(leaf, [])
        if srcs:
            xs = np.concatenate([x[:, rng(b)] for b in srcs], axis=1)
            ms = np.concatenate([m[rng(b)] for b in srcs])
            want += pull64(np, x[:, r], xs, ms, eps)
        cells = pcs.get(leaf, [])
        if cells:
            lo = np.array([t.cells[c].start for c in cells])
            hi = lo + np.array([t.cells[c].count for c in cells])
            mc = cm[hi] - cm[lo]
            want += pull64(np, x[:, r], (cxm[:, hi] - cxm[:, lo]) / mc, mc,
                           eps)
        worst = max(worst, float(rel_err(np, acc[:, r], want).max()))
    return worst


def direct_f64(torch, np, st, targets, chunk=32):
    """The float64 direct sum on the card for the sampled targets, over
    all particles (the target itself adds a zero displacement)."""
    x = st.x.double()
    m = st.m.double()
    out = []
    for i0 in range(0, len(targets), chunk):
        xi = x[:, targets[i0:i0 + chunk]]
        dx = x[:, None, :] - xi[:, :, None]
        w = ((dx * dx).sum(0) + st.eps * st.eps).pow(-1.5) * m[None, :]
        out.append(torch.einsum("dij,ij->di", dx, w))
        del dx, w
    return torch.cat(out, 1).cpu().numpy()


def phase_bh_paper(torch, np):
    """BH at the paper's 1M particles in engine mode."""
    from repro_torch.apps import barneshut as bh
    from repro_torch.core import lower
    from repro_torch.kernels.nbody import kernel as nbk
    x, m = bh_inputs(np, N_PAPER)
    nbk.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, st, g = bh.solve(x, m, n_max=NMAX_BH, n_task=NTASK_PAPER,
                          mode="engine", nr_workers=LANES, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(nbk.LAUNCHES)
    if any(nbk.PLAIN_CALLS.values()):
        fail(f"an N-body plain version ran on the card {nbk.PLAIN_CALLS}")
    rounds = lower(g.sched, LANES).nr_rounds         # the plan cache's
    if not 1 <= launches["bh_walk"] <= rounds:
        fail(f"bh_walk launches per 1M plan {launches['bh_walk']} not in "
             f"1..{rounds} (rounds)")
    a = acc.double().cpu().numpy()
    if not np.isfinite(a).all() or a.shape != (3, N_PAPER):
        fail("BH 1M: accelerations not finite (3, N)")
    lists = sampled_lists_f64(np, g, a, st.eps)
    if not lists < BH_TOL:
        fail(f"BH 1M vs float64 interaction lists: {lists:.3e}")
    targets = np.random.default_rng(4096).choice(N_PAPER, SAMPLE_TARGETS,
                                                 replace=False)
    exact = direct_f64(torch, np, st, torch.as_tensor(targets,
                                                      device="cuda"))
    rel = rel_err(np, a[:, targets], exact)
    med, mean = float(np.median(rel)), float(rel.mean())
    if not (med < ACC_MEDIAN and mean < ACC_MEAN):
        fail(f"BH 1M vs the direct sum: median {med:.3e}, mean {mean:.3e}")
    c = g.counts
    log(f"[bh-paper] {N_PAPER} particles, engine: {secs:.1f} s (first run), "
        f"tasks self/pair/pc/com {c['self']}/{c['pair_pp']}/{c['pair_pc']}/"
        f"{c['com']}, bh_walk launches {launches['bh_walk']} for "
        f"{rounds} rounds; {SAMPLE_LEAVES} sampled leaves vs float64 "
        f"interaction lists {lists:.3e} (bound {BH_TOL}); {SAMPLE_TARGETS} "
        f"targets vs the float64 direct sum: median {med:.3e} (bound "
        f"{ACC_MEDIAN}), mean {mean:.3e} (bound {ACC_MEAN})")
    del acc, st, g
    torch.cuda.empty_cache()
    return launches, rounds


def staged_solve(torch, x, m, n_task, mode):
    """One solve split into stages, each ending synchronized: tree, graph
    (and the state's upload), lowering (plan, and for the engine the task
    table, the launch groups and the padded blocks) and execution.  The
    plan cache is cleared first: a new particle set lowers anew."""
    from repro_torch import engine
    from repro_torch.apps import barneshut as bh
    from repro_torch.core import clear_plan_cache, lower, run_plan
    clear_plan_cache()
    torch.cuda.synchronize()
    t = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        t.append(time.perf_counter())

    tree = bh.Octree(x, m, n_max=NMAX_BH)
    mark()
    g = bh.build_graph(tree, n_task=n_task, nr_queues=LANES)
    st = bh.BHState(g, device="cuda")
    mark()
    keep = {}
    if mode == "engine":
        tab, lg = bh_table(torch, g, st)
        hooks = st.engine_hooks()
        statics, buffers = hooks.statics(), hooks.buffers()
        mark()
        hooks.writeback(engine.execute_plan(tab, hooks.round_fn, statics,
                                            buffers, groups=lg))
        keep = dict(tab=tab, lg=lg, hooks=hooks, statics=statics, st=st)
    else:
        plan = lower(g.sched, LANES) if mode == "rounds" else None
        mark()
        run_plan(g.sched, st.batch_registry(), mode, nr_workers=LANES,
                 plan=plan)
    mark()
    stages = dict(zip(("tree", "graph", "lowering", "execution"),
                      (b - a for a, b in zip(t, t[1:]))))
    stages["total"] = t[-1] - t[0]
    return stages, keep


def log_structure(np, keep, n):
    """The plan's structure counts: what the host lowered for the card."""
    from repro_torch import engine
    tab, lg, st = keep["tab"], keep["lg"], keep["st"]
    c = st.g.counts
    leaves, _, P, _, _ = st._leaf_slots()
    names = ("COM_LEAF", "COM_INNER", "SELF", "PP", "PC")
    per = np.bincount(tab.desc[:, 0], minlength=len(names))
    log(f"[bh-structure] {n} particles: tasks {c['tasks']} (self "
        f"{c['self']}, pair {c['pair_pp']}, pc {c['pair_pc']}, com "
        f"{c['com']}); leaves {len(leaves)}, largest leaf P {P}, mean leaf "
        f"{n / len(leaves):.2f}, cells {len(st.g.tree.cells)}; rows "
        f"{tab.nr_items} ("
        + ", ".join(f"{k} {int(v)}" for k, v in zip(names, per)) + f"); "
        f"rounds {tab.nr_rounds}, write-colored phases {tab.nr_phases}, "
        f"largest phase {tab.stats['max_phase_len']}; launch groups "
        f"{lg.nr_groups}, buckets {lg.nr_buckets}; desc "
        f"{tab.desc.nbytes / 1e6:.1f} MB, padded blocks xs "
        f"{len(leaves) * 3 * P * 4 / 1e6:.1f} MB (engine.BH_ARG_WIDTH "
        f"{engine.BH_ARG_WIDTH})")


def walk_flops_bytes(np, tab, st):
    """Operations and bytes the 1M walk needs, counted from its rows with
    the real leaf counts (zero-mass pads are not work the data needs); the
    pair interactions K8 evaluates (real targets x real sources, a SELF
    row's diagonal weighed zero among them), the lane slots its warps
    spend on them (32 lanes a target group of 32), and the pairs a walk
    over the padded blocks evaluates."""
    from repro_torch import engine
    leaves, _, P, _, _ = st._leaf_slots()
    cnt = np.array([st.g.tree.cells[c].count for c in leaves], np.int64)
    d = tab.desc.astype(np.int64)
    et, w, a0 = d[:, 0], d[:, 1], d[:, 2]
    ncells = len(st.g.tree.cells)
    real = (d[:, 2:2 + engine.BH_MAX_CHILDREN] != ncells).sum(1)
    sel = {k: et == v for k, v in (("self", engine.BH_SELF),
                                   ("pp", engine.BH_PP),
                                   ("pc", engine.BH_PC),
                                   ("leaf", engine.BH_COM_LEAF),
                                   ("inner", engine.BH_COM_INNER))}
    ns = cnt[w[sel["self"]]]
    pp = cnt[w[sel["pp"]]] * cnt[a0[sel["pp"]]]
    pc = cnt[w[sel["pc"]]] * real[sel["pc"]]
    pairs = int((ns * (ns - 1)).sum()) + int(pp.sum()) + int(pc.sum())
    evaluated = int((ns * ns).sum()) + int(pp.sum()) + int(pc.sum())
    lanes = 32 * -(-cnt // 32)

    def slots(mask, n_src):
        return int((lanes[w[mask]] * n_src).sum())

    lane_slots = (slots(sel["self"], ns) + slots(sel["pp"], cnt[a0[sel["pp"]]])
                  + slots(sel["pc"], real[sel["pc"]]))
    padded = (int(sel["self"].sum() + sel["pp"].sum()) * P * P
              + int(sel["pc"].sum()) * P * engine.BH_MAX_CHILDREN)
    com_ops = 7 * (int(cnt[a0[sel["leaf"]]].sum()) + 8 * int(
        sel["inner"].sum()))
    flops = FLOPS_PER_PAIR * pairs + com_ops
    nbytes = (tab.desc.nbytes + len(leaves) * P * 4 * 4   # desc, xs, ms
              + len(leaves) * 3 * P * 4 + (ncells + 1) * 4 * 4)  # acc, com
    return flops, nbytes, {"needed": pairs, "evaluated": evaluated,
                           "lane_slots": lane_slots, "padded": padded}


def phase_bh_timing(torch, np, firsts, launches, paper_launches,
                    paper_rounds, ops_err, walk_err, walk20k, card):
    from repro_torch.kernels.nbody import kernel as nbk
    from repro_torch.kernels.nbody import ref
    x, m = bh_inputs(np, N_BH)
    for mode in MODES:
        # a median of 3 unless the first run was long (threaded: the GIL)
        reps = 3 if firsts[mode] < 15.0 else 1
        runs = []
        for _ in range(reps):
            stages, keep = staged_solve(torch, x, m, NTASK_BH, mode)
            runs.append(stages)
        if mode == "engine":
            log_structure(np, keep, N_BH)
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        fewer = ("" if reps == 3 else
                 f", fewer: the first run took {firsts[mode]:.1f} s")
        log(f"[bh-time] {mode} at {N_BH} (median of {reps}{fewer}): "
            + ", ".join(f"{k} {v:.4f} s" for k, v in med.items())
            + f"; {card}")
    x, m = bh_inputs(np, N_PAPER)
    runs = []
    for _ in range(2):              # two runs: the 1M lowering is long
        stages, keep = staged_solve(torch, x, m, NTASK_PAPER, "engine")
        runs.append(stages)
    log(f"[bh-time] engine at {N_PAPER} (2 runs, each shown): "
        + "; ".join(", ".join(f"{k} {v:.4f} s" for k, v in r.items())
                    for r in runs) + f"; {card}")
    log_structure(np, keep, N_PAPER)
    tab, lg, hooks, statics, st = (keep[k] for k in ("tab", "lg", "hooks",
                                                     "statics", "st"))
    desc = torch.as_tensor(tab.desc[lg.order], device="cuda")

    def walk_once():
        bufs = hooks.buffers()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        hooks.round_fn(desc, lg, statics, bufs)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    walk_once()
    round_ms = median_of(walk_once)
    # the kernel alone: the round function's 6 launches between two events,
    # its table checks, bucket order and uploads made beforehand
    from repro_torch import engine
    xs, ms_, counts = statics
    bo = lg.bucket_offsets
    both = torch.as_tensor(np.concatenate(
        [bo, engine.megakernel.bucket_order(lg)]).astype(np.int32),
        device="cuda")
    ptr, order = both[:len(bo)], both[len(bo):]
    go = lg.group_offsets.tolist()

    def launches_once():
        acc, com, cmass = hooks.buffers()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for b0, b1 in zip(go, go[1:]):
            nbk.bh_walk(desc, ptr, order, b0, b1, xs, ms_, counts, acc, com,
                        cmass, st.eps ** 2)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    launches_once()
    walk_ms = median_of(launches_once)
    flops, nbytes, pairs = walk_flops_bytes(np, tab, st)
    wbms, wby = bound_ms(flops, nbytes)
    log(f"[bh-time] bh_walk over the {N_PAPER} plan ({tab.nr_items} rows, "
        f"{lg.nr_groups} launches, {lg.nr_buckets} buckets): {walk_ms:.3f} "
        f"ms the launches alone (median of 3), {round_ms:.3f} ms the round "
        f"function with its table checks, bucket order and uploads, bound "
        f"{wbms:.4f} ms ({wby}); pair interactions: "
        f"{pairs['evaluated']:.4e} evaluated (real targets x real sources; "
        f"{pairs['lane_slots']:.4e} lane slots), {pairs['needed']:.4e} the "
        f"data needs, {pairs['padded']:.4e} a walk over the padded blocks "
        f"evaluates (the first form); {card}")

    # K6 / K7 at the path's shapes: a PP row's leaf pair (~30 x 30), a PC
    # task's leaf against its COM sources (~30 x 460), a self block (~30)
    rng = np.random.default_rng(30)

    def cloud(n):
        return (torch.tensor(rng.random((3, n)), dtype=torch.float32,
                             device="cuda"),
                torch.tensor(rng.random(n) + 0.5, dtype=torch.float32,
                             device="cuda"))

    xi, mi = cloud(30)
    xj, mj = cloud(30)
    xc, mc = cloud(460)
    x0, m0 = cloud(0)
    out = torch.empty((3, 30), device="cuda")
    eps2 = ref.DEFAULT_EPS ** 2
    # K6's launch floor: 30 targets and no source, through the binding, in
    # the same kind of CUDA graph as the readings below
    floor = median_of(lambda: graph_ms(
        torch, lambda: nbk.acc_pair(xi, x0, m0, eps2, out)))
    log(f"[bh-time] acc_pair 30x0 (the launch floor): {floor:.5f} ms on the "
        f"device (CUDA graph of 50, median of 3); {card}")
    # (kernel, plain, pairs, bytes: targets, sources + masses and the
    # output each moved once, float32)
    shapes = {
        "acc_pair": (lambda: nbk.acc_pair(xi, xj, mj, eps2, out),
                     lambda: ref.acc_pair_ref(xi, xj, mj), 30 * 30,
                     4 * (3 * 30 + 4 * 30 + 3 * 30), 30, 30),
        "acc_pair_pc": (lambda: nbk.acc_pair(xi, xc, mc, eps2, out),
                        lambda: ref.acc_pair_ref(xi, xc, mc), 30 * 460,
                        4 * (3 * 30 + 4 * 460 + 3 * 30), 30, 460),
        "acc_self": (lambda: nbk.acc_self(xi, mi, eps2, out),
                     lambda: ref.acc_self_ref(xi, mi), 30 * 29,
                     4 * (4 * 30 + 3 * 30), 30, 30),
    }
    times = {}
    for name, (fn, plain, npairs, nbytes, ni, nj) in shapes.items():
        ms = median_of(lambda: graph_ms(torch, fn))
        enq = median_of(lambda: events_ms(torch, fn, 50))
        pms = median_of(lambda: events_ms(torch, plain, 10))
        bms, by = bound_ms(FLOPS_PER_PAIR * npairs, nbytes)
        times[name] = (ms, pms, bms, by, enq)
        log(f"[bh-time] {name} {ni}x{nj}: {ms:.5f} ms on the device (CUDA "
            f"graph of 50, median of 3), {enq:.5f} ms a launch from Python,"
            f" bound {bms:.7f} ms ({by}), plain {pms:.4f} ms, library none;"
            f" {card}")
    source = "src/repro_torch/kernels/nbody/csrc/nbody.cu"
    none = ("none: no single PyTorch call computes softened gravity "
            "(cdist gives distances only)")
    rows = []
    for name, replaces, key, err in (
            ("acc_pair", "src/repro/kernels/nbody/kernel.py:82", "acc_pair",
             ops_err["acc_pair"]),
            ("acc_self", "src/repro/kernels/nbody/kernel.py:102",
             "acc_self", ops_err["acc_self"])):
        ms, pms, bms, by, enq = times[key]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err[0], "err_share_of_bound": err[1],
               "ms": ms, "launch_from_python_ms": enq, "plain_ms": pms,
               "bound_ms": bms, "bound_by": by,
               "library_ms": None, "library": none,
               "shape": "30x30" if name == "acc_pair" else "30",
               "floor_ms_30x0": floor}
        if name == "acc_pair":
            row.update(ms_pc_30x460=times["acc_pair_pc"][0],
                       plain_ms_pc_30x460=times["acc_pair_pc"][1],
                       bound_ms_pc_30x460=times["acc_pair_pc"][2])
        rows.append(row)
    rows.append({"name": "bh_walk", "route": "cuda", "source": source,
                 "replaces": "src/repro/engine/megakernel.py:221",
                 "launches": launches["bh_walk"]
                 + paper_launches["bh_walk"],
                 "launches_per_1m_plan": paper_launches["bh_walk"],
                 "rounds_per_1m_plan": paper_rounds,
                 "max_abs_err": walk_err["abs"],
                 "err_share_of_bound": walk_err["ratio"],
                 "ms": walk_ms, "round_fn_ms": round_ms,
                 "plain_ms": walk20k["plain_ms"],
                 "plain_size": f"{N_WALK} particles, {walk20k['rows']} rows",
                 "ms_at_plain_size": walk20k["ms"],
                 "bound_ms": wbms, "bound_by": wby, "library_ms": None,
                 "library": none, "shape": f"{N_PAPER} particles, "
                 f"{tab.nr_items} rows, {lg.nr_groups} launches",
                 "pair_interactions": pairs["needed"],
                 "evaluated_pair_interactions": pairs["evaluated"],
                 "lane_slot_pairs": pairs["lane_slots"],
                 "padded_pair_interactions": pairs["padded"]})
    return rows



# ---------------------------------------------------------------------------
# slice 3: continuous-batching serving of qwen3-1.7b with K10
# ---------------------------------------------------------------------------

ARCH_SERVE = "qwen3-1.7b"   # as published: bf16, 28 layers, d 2048, 16/8
#                             heads of 128, vocab 151,936 (about 1.7e9 weights)
SERVE_PAGE = 8
# (name, slots, prompt length, new tokens): (a) the launcher's own workload
# (launch/serve.py --continuous: 3 x slots requests, budgets drawn from
# {new/8, new/2, new}, seed 0); (b) one that walks 40 pages a slot and
# reuses them (24 requests through 8 slots)
SERVE_WORKLOADS = (("a", 4, 8, 32), ("b", 8, 256, 64))
TEACHER_STEPS = 16
# K10 vs its plain version.  fp32: the reference's kernel-vs-oracle
# tolerance (tests/test_paged_properties.py).  bf16: both compute in float
# from the same bf16 operands and round the output once, so they may
# differ by one bf16 ulp, at most 2^-7 of the value.
PAGED_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}
# positions of the 8 slots in the serving-depth case (workload (b) runs
# positions 256-319)
SERVE_DEPTH_POS = [256, 263, 264, 277, 288, 300, 311, 319]
PAGED_SHAPES = ((4, 2, 32, 8, "float32"),       # qwen3-1.7b reduced
                (16, 8, 128, 8, "float32"),     # qwen3-1.7b as published
                (16, 8, 128, 16, "float32"),
                (16, 8, 128, 8, "bfloat16"),
                (16, 8, 128, 16, "bfloat16"),
                (36, 4, 128, 8, "float32"),     # starcoder2-7b as published:
                (36, 4, 128, 16, "float32"),    # H/Hkv 9, H/Hkv x hd 1,152
                (36, 4, 128, 8, "bfloat16"),
                (36, 4, 128, 16, "bfloat16"),
                (32, 2, 128, 8, "bfloat16"),    # n_rep 16: four head groups
                (8, 2, 20, 8, "bfloat16"))      # rows not on 16 bytes: the
#                                                 element-wise loads
# kernel vs gather logits over teacher-forced bf16 decode steps, per step
# ‖Δ‖₂/‖logits‖₂.  The two paths round differently: K10 keeps the attention
# in float and rounds its output to bf16 once; the gather path rounds the
# softmax weights to bf16 before the product with V.  Each of the 28 layers
# may so move the residual stream by about one bf16 ulp of the attention
# output (2^-8 relative); as a random walk over 28 layers that is
# sqrt(28) * 2^-8 = 2.1e-2.  The same steps are run once more through a
# planted fault (K10's walk stopping one page early, so it misses the
# slot's newest 1-8 positions, itself among them), and the check fails
# unless that fault's gap exceeds the limit.  On an H100 the paths differ
# by 1.78e-2 at most and the planted fault by 6.1e-2 at least; the limit
# sits between them, 1.7 times the random-walk estimate.
BF16_LOGIT_RTOL = 3.5e-2




def nan_equal(torch, a, b):
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


def hold_paged(torch, np, name, op, plain_op, operands, rows, pos, ps,
               dtype, what, errs, **kw):
    """One launch of a paged decode kernel (K10 or K11, through its op)
    against its plain version on the same inputs: a finite output within
    PAGED_TOL and every walked page of both pools equal to the plain
    version's, NaN for NaN.  Records the largest |err| in ``errs``."""
    plain = [x.clone() for x in operands]
    out, pool1, pool2 = op(*operands, page_size=ps, **kw)
    want, want1, want2 = plain_op(*plain, page_size=ps, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"{name} {what}: non-finite output (read a poisoned position)")
    g, w = out.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(g, w, err_msg=f"{name} {what}",
                               **PAGED_TOL[dtype])
    errs[dtype] = max(errs[dtype], float(np.abs(g - w).max()))
    for got, exp in ((pool1, want1), (pool2, want2)):
        for t in range(len(pos)):
            pages = torch.as_tensor(rows[t, :pos[t] // ps + 1])
            if not nan_equal(torch, got[pages], exp[pages]):
                fail(f"{name} {what}: walked pages differ from the plain "
                     f"version's")


def other_slot_untouched(torch, name, op, operands, rows, pos, ps, **kw):
    """A launch for slot 0 alone (of two) writes slot 0's new cells and
    leaves every other byte of both pools as it was."""
    *lead, page_rows, positions = operands
    news, pools = lead[-4:-2], lead[-2:]
    before = [p.clone() for p in pools]
    op(*[x[:1].contiguous() for x in lead[:-2]], *pools,
       page_rows[:1].contiguous(), positions[:1].contiguous(), page_size=ps,
       **kw)
    torch.cuda.synchronize()
    cell = (int(rows[0, pos[0] // ps]), int(pos[0] % ps))
    for pool, old, new in zip(pools, before, news):
        if not torch.equal(pool[cell], new[0]):
            fail(f"{name}: the new cell was not written")
        pool[cell] = old[cell]
        if not nan_equal(torch, pool, old):
            fail(f"{name}: a launch for slot 0 changed another cell of the "
                 f"pool")


def phase_k10(torch, np):
    """K10 against its plain version on the card, the cases of
    tests/test_torch_gpu.py; returns max |err| per storage type."""
    from repro_torch.kernels.paged_attention import ops, ref
    errs = {"float32": 0.0, "bfloat16": 0.0}

    def check(operands, rows, pos, ps, dtype, what):
        hold_paged(torch, np, "K10", ops.paged_gqa_decode,
                   ref.paged_gqa_decode_ref, operands, rows, pos, ps, dtype,
                   what, errs)

    n = 0
    for bs in (1, 3, 8):
        for (h, hkv, hd, ps, dt) in PAGED_SHAPES:
            ops_, rows, pos = ref.random_case(bs, ps, getattr(torch, dt), bs,
                                              "cuda", n_heads=h, n_kv=hkv,
                                              hd=hd)
            check(ops_, rows, pos, ps, dt, f"bs {bs} H {h} Hkv {hkv} hd "
                  f"{hd} ps {ps} {dt}")
            n += 1
    for dt in ("float32", "bfloat16"):
        # workload (b)'s geometry: 8 slots of 40 pages, positions spread
        # over 256-319 (up to 40 pages walked), as tests/test_torch_gpu.py,
        # at qwen3-1.7b's and starcoder2-7b's heads
        for h, hkv in ((16, 8), (36, 4)):
            ops_, rows, pos = ref.random_case(8, 8, getattr(torch, dt), 21,
                                              "cuda", pos=SERVE_DEPTH_POS,
                                              max_pages=40, n_heads=h,
                                              n_kv=hkv, hd=128)
            check(ops_, rows, pos, 8, dt, f"serving depth H {h} Hkv {hkv} "
                  f"{dt}")
        # stale non-finite tails
        ops_, rows, pos = ref.random_case(4, 8, getattr(torch, dt), 11, "cuda",
                                          stale_tail=True, pos=[0, 7, 8, 13],
                                          n_heads=16, n_kv=8, hd=128)
        check(ops_, rows, pos, 8, dt, f"stale tail {dt}")
        n += 3
    # the splits merge in a fixed order: two launches, bitwise equal
    ops_, rows, pos = ref.random_case(8, 8, torch.bfloat16, 21, "cuda",
                                      pos=SERVE_DEPTH_POS, max_pages=40,
                                      n_heads=36, n_kv=4, hd=128)
    outs = [ops.paged_gqa_decode(*[x.clone() for x in ops_], page_size=8)[0]
            for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(outs[0], outs[1]):
        fail("K10: two launches on the same inputs differ")
    # one slot's launch leaves the other slot's pages bitwise unchanged
    ops_, rows, pos = ref.random_case(2, 8, torch.bfloat16, 5, "cuda",
                                      pos=[12, 20], n_heads=16, n_kv=8, hd=128)
    other_slot_untouched(torch, "K10", ops.paged_gqa_decode, ops_, rows, pos,
                         8)
    log(f"[k10] paged_gqa_decode vs plain on the card: {n + 2} cases (bs 1,"
        f" 3, 8 x {len(PAGED_SHAPES)} shapes (H, Hkv, hd, ps, dtype) "
        f"{PAGED_SHAPES}, 8 slots at positions "
        f"{SERVE_DEPTH_POS[0]}-{SERVE_DEPTH_POS[-1]} of 40 pages at H/Hkv "
        f"16/8 and 36/4, stale non-finite tails, NaN unlisted pages, two "
        f"launches bitwise equal, a second slot untouched); max |err| fp32 "
        f"{errs['float32']:.3e}, bf16 {errs['bfloat16']:.3e}")
    return errs


def free_card(torch, most_gib=8.0):
    """Give the card back the memory of models that were dropped (a dropped
    service keeps no reference cycle, so its model is freed at once); fails
    if more than ``most_gib`` GiB are still held, since a model held on
    would leave the next one short of memory."""
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    if held > most_gib:
        fail(f"{held:.2f} GiB still held on the card after a model was "
             f"dropped")


def tree_numel(tree):
    return sum(tree_numel(v) if isinstance(v, dict) else int(v.numel())
               for v in tree.values())


def kernel_modules():
    """Every kernel binding of the port (each with LAUNCHES, PLAIN_CALLS,
    reset_counts, SOURCE and lib)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.nbody import kernel as nb_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.pipe_walk import kernel as pw_kernel
    from repro_torch.kernels.qr_tile import kernel as qr_kernel
    return (qr_kernel, nb_kernel, pa_kernel, pw_kernel, fa_kernel)


def reset_all_counts():
    for k in kernel_modules():
        k.reset_counts()


def plain_calls():
    return {k: v for m in kernel_modules()
            for k, v in m.PLAIN_CALLS.items() if v}


def serve_workload(np, vocab, slots, plen, new):
    """launch/serve.py's continuous workload: 3 x slots requests, prompts
    uniform in the vocabulary, budgets drawn from {new/8, new/2, new}."""
    rng = np.random.default_rng(0)
    work = []
    for _ in range(3 * slots):
        prompt = rng.integers(0, vocab, plen, dtype=np.int32)
        work.append((prompt, int(rng.choice([new // 8 or 1, new // 2 or 1,
                                             new]))))
    return work


def run_service(torch, np, params, cfg, work, slots, plen, new, path):
    """Drive GenerateService over ``work`` with every count set to 0 just
    before and read just after; returns what the checks and the timings
    need."""
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.serve import GenerateService
    max_seq = -(-(plen + new - 1) // SERVE_PAGE) * SERVE_PAGE
    svc = GenerateService(params, cfg, max_batch=slots, max_seq=max_seq,
                          page_size=SERVE_PAGE, decode_path=path,
                          device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.perf_counter()
    hs = [svc.submit(p, n) for p, n in work]
    svc.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa_kernel.LAUNCHES)
    plain = plain_calls()
    peak = torch.cuda.max_memory_allocated()
    return dict(svc=svc, hs=hs, wall=wall, launches=launches,
                plain=plain, peak=peak, max_seq=max_seq)


# the paged decode kernel each attention kind's decode path launches, by
# cfg.mla: its launch-count key, its op in kernels/paged_attention/ops.py
# (the plain version is the op's name + "_ref" in ref.py) and its CUDA
# kernels' symbols as the profiler names them (K11: bf16 on the tensor
# cores, float32 on the CUDA cores)
PAGED_KERNELS = {
    False: dict(key="paged_gqa", op="paged_gqa_decode",
                symbols=("gqa_decode_kernel",)),
    True: dict(key="paged_mla", op="paged_mla_decode",
               symbols=("mla_mma_kernel", "mla_decode_kernel"))}


def paged_kernel(cfg):
    """The paged decode kernel the model's decode path launches."""
    return PAGED_KERNELS[bool(cfg.mla)]


def check_served(np, cfg, name, run, work, want_path):
    svc, hs = run["svc"], run["hs"]
    if svc.decode_path != want_path:
        fail(f"serve ({name}): decode path {svc.decode_path!r}, wanted "
             f"{want_path!r}")
    for h, (_, n) in zip(hs, work):
        if h.status != "done" or len(h.generated) != n:
            fail(f"serve ({name}): request {h.rid} {h.status} with "
                 f"{len(h.generated)} of {n} tokens")
        if not all(0 <= t < cfg.vocab for t in h.generated):
            fail(f"serve ({name}): request {h.rid} produced a token outside "
                 f"the vocabulary")
    if svc.pool.allocated != 0:
        fail(f"serve ({name}): {svc.pool.allocated} pages still allocated")
    svc.pool.check_invariants()
    level = svc.metrics.get("serve.degrade_level").value
    if svc.stats["retries"] or svc.stats["preemptions"] or level:
        fail(f"serve ({name}): retries {svc.stats['retries']}, preemptions "
             f"{svc.stats['preemptions']}, degrade level {level}")
    if run["plain"]:
        fail(f"serve ({name}): plain versions ran on the card: "
             f"{run['plain']}")
    ticks = svc.metrics.get("serve.decode_round_s").count
    if want_path == "kernel":
        want = {k: cfg.n_layers * ticks if k == paged_kernel(cfg)["key"] else 0
                for k in run["launches"]}
        if run["launches"] != want or not ticks:
            fail(f"serve ({name}): paged kernels launched {run['launches']} "
                 f"times, wanted {want} (layers x decode ticks = "
                 f"{cfg.n_layers} x {ticks} of {paged_kernel(cfg)['key']})")
    return ticks


def serve_timings(np, name, run):
    svc, hs = run["svc"], run["hs"]
    plan = svc.metrics.get("serve.decode_plan_s").summary()
    host = svc.metrics.get("serve.decode_round_s").summary()
    dev = svc.metrics.get("serve.decode_device_s").summary()
    ttft = np.array([h.ttft_s for h in hs]) * 1e3
    toks = svc.stats["generated_tokens"]
    out = {"wall_s": run["wall"], "tokens": toks,
           "tok_per_s": toks / run["wall"], "requests": len(hs),
           "ticks": host["count"], "steps": svc.stats["steps"],
           "ttft_ms_median": float(np.median(ttft)),
           "ttft_ms_p90": float(np.percentile(ttft, 90)),
           "decode_plan_ms_mean": plan["mean"] * 1e3,
           "decode_round_host_ms_mean": host["mean"] * 1e3,
           "decode_round_device_ms_mean": dev["mean"] * 1e3,
           "decode_round_device_ms_total": dev["sum"] * 1e3,
           "pages_attended": svc.stats["pages_attended"],
           "peak_gib": run["peak"] / 2 ** 30,
           "kernel_launches": run["launches"][paged_kernel(svc.cfg)["key"]]}
    log(f"[serve-time] ({name}) {len(hs)} requests, {toks} tokens in "
        f"{out['wall_s']:.3f} s = {out['tok_per_s']:.1f} tok/s; TTFT median "
        f"{out['ttft_ms_median']:.1f} ms, p90 {out['ttft_ms_p90']:.1f} ms; "
        f"{out['ticks']} decode ticks: host sched + lower "
        f"{out['decode_plan_ms_mean']:.3f} ms a tick, the round "
        f"{out['decode_round_host_ms_mean']:.3f} ms on the host (Python "
        f"issuing it) and {out['decode_round_device_ms_mean']:.3f} ms on "
        f"the device (CUDA events around it; means of the service's "
        f"serve.decode_*_s histograms); peak memory "
        f"{out['peak_gib']:.2f} GiB; {paged_kernel(svc.cfg)['key']} launches "
        f"{out['kernel_launches']}")
    return out


def one_page_short(plain):
    """A planted fault in a paged kernel's place (K10's or K11's operands):
    the new cells are written, but the walk stops after page pos // ps - 1
    (``plain`` at position ``cut``, the last one of that page, fed the cells
    it already holds)."""
    from repro_torch.kernels.paged_attention import ref

    def op(*operands, page_size, **kw):
        *queries, new1, new2, pool1, pool2, page_rows, pos = operands
        ref.write_cell(pool1, page_rows, pos, new1, page_size)
        ref.write_cell(pool2, page_rows, pos, new2, page_size)
        cut = pos - pos % page_size - 1
        pg = page_rows.long().gather(1, (cut.long() // page_size)[:, None])[
            :, 0]
        off = cut.long() % page_size
        out, _, _ = plain(*queries, pool1[pg, off], pool2[pg, off], pool1,
                          pool2, page_rows, cut, page_size=page_size, **kw)
        return out, pool1, pool2

    return op


def teacher_forced(torch, np, params, cfg, limit):
    """Kernel vs gather logits over TEACHER_STEPS decode steps fed the same
    tokens, from one prefill of 8 prompts of 256: the paged pool (pages
    shuffled) through the paged kernel (K10 or K11), a contiguous copy
    through the gather math; then the paged steps again with the planted
    fault (the walk one page short) in the kernel's place.  Fails unless
    every step's gap is within ``limit`` and every planted step's exceeds
    it."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.models import serving
    bs, plen, ps = 8, 256, SERVE_PAGE
    n = -(-(plen + TEACHER_STEPS) // ps)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (bs, plen)),
                             device="cuda")
    teach = torch.as_tensor(rng.integers(0, cfg.vocab,
                                         (TEACHER_STEPS, bs, 1)),
                            device="cuda")
    _, cache, pos = serving.prefill(params, cfg, tokens)
    cache = serving.pad_seq(cache, n * ps - plen)
    rows = torch.as_tensor(rng.permutation(bs * n), device="cuda").reshape(
        bs, n)
    leaves = {}
    for k, v in cache.items():
        leaf = torch.zeros((v.shape[0], bs * n, ps) + v.shape[3:],
                           dtype=v.dtype, device="cuda")
        leaf[:, rows] = v.reshape((v.shape[0], bs, n, ps) + v.shape[3:])
        leaves[k] = leaf
    rows = rows.int()
    pos0 = pos
    rels, maxs, gather = [], [], []
    for s in range(TEACHER_STEPS):
        lk, _ = serving.decode_step_paged(params, cfg, leaves, rows,
                                          teach[s], pos, page_size=ps)
        lg, _ = serving.decode_step(params, cfg, cache, teach[s], pos)
        lk, lg = lk.float(), lg.float()
        if not (torch.isfinite(lk).all() and torch.isfinite(lg).all()):
            fail("teacher-forced bf16 logits are not finite")
        rels.append(float((lk - lg).norm() / lg.norm()))
        maxs.append(float((lk - lg).abs().max() / lg.abs().max()))
        gather.append(lg)
        pos = pos + 1
    # the planted fault over the same steps (each step rewrites its cell
    # before reading, so the pool's later cells from the run above are
    # never read)
    name = paged_kernel(cfg)["op"]
    plain = getattr(ref, name + "_ref")
    planted, pos = [], pos0
    real_op = getattr(pa_ops, name)
    setattr(pa_ops, name, one_page_short(plain))
    try:
        for s in range(TEACHER_STEPS):
            lf, _ = serving.decode_step_paged(params, cfg, leaves, rows,
                                              teach[s], pos, page_size=ps)
            lg = gather[s]
            planted.append(float((lf.float() - lg).norm() / lg.norm()))
            pos = pos + 1
    finally:
        setattr(pa_ops, name, real_op)
    log(f"[serve] {cfg.name} bf16 kernel vs gather logits, {TEACHER_STEPS} "
        f"teacher-forced steps from 8 x 256 prompts: ‖Δ‖/‖logits‖ max "
        f"{max(rels):.3e} (limit {limit}), median "
        f"{float(np.median(rels)):.3e}; max|Δ|/max|logits| max "
        f"{max(maxs):.3e}; a planted fault (the walk one page short) vs "
        f"gather: ‖Δ‖/‖logits‖ min {min(planted):.3e}, median "
        f"{float(np.median(planted)):.3e}, max {max(planted):.3e}")
    log(f"[serve] {cfg.name} per step, kernel vs gather: "
        + " ".join(f"{r:.2e}" for r in rels)
        + "; planted vs gather: " + " ".join(f"{r:.2e}" for r in planted))
    if not max(rels) <= limit:
        fail(f"bf16 kernel vs gather logits {max(rels):.3e} > {limit} at "
             f"step {int(np.argmax(rels))}")
    if not min(planted) > limit:
        fail(f"the logits check cannot see a walk one page short: its gap "
             f"{min(planted):.3e} <= {limit}")
    return {"max": max(rels), "median": float(np.median(rels)),
            "steps": rels, "planted_min": min(planted),
            "planted_median": float(np.median(planted)),
            "planted_steps": planted}


def expert_product_us(torch, prof, n_experts):
    """Device µs of the MoE expert products in a profile recorded with
    shapes: the batched products whose operands both lead with the expert
    axis ((E, C, d) x (E, d, f) and (E, C, f) x (E, f, d))."""
    total = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        shapes = e.input_shapes or []
        if (e.key == "aten::bmm" and len(shapes) >= 2 and shapes[0]
                and shapes[1] and shapes[0][0] == n_experts
                and shapes[1][0] == n_experts):
            t = getattr(e, "device_time_total", None)    # older torch:
            total += e.cuda_time_total if t is None else t  # cuda_time_total
    return total


def profile_ticks(torch, np, params, cfg, n_ticks=8):
    """Device busy share of steady decode ticks: workload (b)'s first 8
    requests admitted, then ``n_ticks`` service steps under torch.profiler
    (CPU and CUDA activities; shapes recorded for a MoE model, to find its
    expert products).  Kernel time by name from
    key_averages(); the share is the kernels' summed device time over the
    window's wall time, which the profiler itself lengthens (so the share
    is a lower bound).  Returns None when the profiler reports no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import GenerateService
    _, slots, plen, new = SERVE_WORKLOADS[1]
    work = serve_workload(np, cfg.vocab, slots, plen, new)
    max_seq = -(-(plen + new - 1) // SERVE_PAGE) * SERVE_PAGE
    svc = GenerateService(params, cfg, max_batch=slots, max_seq=max_seq,
                          page_size=SERVE_PAGE, device="cuda")
    for p, n in work[:slots]:
        svc.submit(p, max(n, n_ticks + 2))
    svc.step()                          # admission, prefill, first tick
    svc.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(cfg.n_experts)) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            svc.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total
    busy = sum(kernels.values())
    if busy <= 0:
        log("[serve-profile] the profiler reported no device time: device "
            "busy share not measured")
        return None
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    symbols = paged_kernel(cfg)["symbols"]
    paged = sum(v for k, v in kernels.items()
                if any(sym in k for sym in symbols))
    experts = (expert_product_us(torch, prof, cfg.n_experts)
               if cfg.n_experts else 0.0)
    out = {"ticks": n_ticks, "wall_ms_per_tick": wall_us / n_ticks / 1e3,
           "device_ms_per_tick": busy / n_ticks / 1e3,
           "busy_share": busy / wall_us,
           "kernel_ms_per_tick": paged / n_ticks / 1e3,
           "kernel_share": paged / busy,
           "expert_products_ms_per_tick": experts / n_ticks / 1e3,
           "expert_products_share": experts / busy,
           "kernels_per_tick": sum(1 for e in prof.events()
                                   if e.device_type ==
                                   torch.autograd.DeviceType.CUDA) / n_ticks}
    log(f"[serve-profile] {cfg.name}, workload (b), 8 slots at positions "
        f"258-{257 + n_ticks}, {n_ticks} ticks under torch.profiler: "
        f"{out['wall_ms_per_tick']:.3f} ms a tick on the host clock, kernels "
        f"{out['device_ms_per_tick']:.3f} ms a tick on the device (busy "
        f"share {out['busy_share']:.3f}), {out['kernels_per_tick']:.0f} "
        f"kernels a tick, {paged_kernel(cfg)['key']} "
        f"{out['kernel_ms_per_tick']:.3f}"
        f" ms a tick (share {out['kernel_share']:.3f}), "
        + (f"MoE expert products {out['expert_products_ms_per_tick']:.3f} ms "
           f"a tick (share {out['expert_products_share']:.3f}), "
           if cfg.n_experts else "")
        + "top kernels (ms a tick): "
        + ", ".join(f"{k[:48]} {v / n_ticks / 1e3:.3f}" for k, v in top))
    return out

def serve_path(torch, np, cfg, cfg32, limit, what):
    """One model's serving path at full width, bf16, on the card: weights
    from seed 0, GenerateService on decode_path "auto" (its paged kernel)
    for the two workloads with their checks and timings, the teacher-forced
    logits check against ``limit``, the profiler window; then the model is
    freed and workload (a) runs token for token, kernel vs gather, in the
    fp32 configuration ``cfg32``."""
    from repro_torch.models import lm
    tag = "serve" if cfg.name == ARCH_SERVE else "serve-mla"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    torch.cuda.synchronize()
    n_par = tree_numel(params)
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] {what}: {n_par:,} weights drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s (seed 0), peak {init_peak:.2f} GiB"
        f" while drawing")
    kname = paged_kernel(cfg)["key"]
    out = {"launches": 0, "ticks": 0, "weights": n_par,
           "init_peak_gib": init_peak}
    for name, slots, plen, new in SERVE_WORKLOADS:
        work = serve_workload(np, cfg.vocab, slots, plen, new)
        run = run_service(torch, np, params, cfg, work, slots, plen, new,
                          "auto")
        ticks = check_served(np, cfg, name, run, work, "kernel")
        out[name] = serve_timings(np, name, run)
        out[name]["max_seq"] = run["max_seq"]
        out["launches"] += run["launches"][kname]
        out["ticks"] += ticks
        log(f"[{tag}] ({name}) {slots} slots, prompt {plen}, up to {new} "
            f"new tokens, {len(work)} requests, max_seq {run['max_seq']} "
            f"({run['max_seq'] // SERVE_PAGE} pages a slot): every request "
            f"done with its budget, pool empty, path kernel, degrade level "
            f"0, retries 0, launches {run['launches']} ({kname} = "
            f"{cfg.n_layers} layers x {ticks} ticks), no plain version")
        del run
    out["bf16_logit_rel"] = teacher_forced(torch, np, params, cfg, limit)
    out["profile"] = profile_ticks(torch, np, params, cfg)
    del params
    free_card(torch)
    params32 = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg32)
    name, slots, plen, new = SERVE_WORKLOADS[0]
    work = serve_workload(np, cfg32.vocab, slots, plen, new)
    streams = {}
    for path in ("kernel", "gather"):
        run = run_service(torch, np, params32, cfg32, work, slots, plen,
                          new, path)
        check_served(np, cfg32, f"{name} fp32 {path}", run, work, path)
        streams[path] = [h.generated for h in run["hs"]]
        del run
    same = sum(a == b for a, b in zip(streams["kernel"], streams["gather"]))
    log(f"[{tag}] fp32 copy ({cfg32.n_layers} layers), workload ({name}): "
        f"kernel and gather streams equal token for token in {same} of "
        f"{len(work)} requests")
    if same != len(work):
        fail(f"fp32 kernel and gather streams differ ({cfg.name})")
    del params32
    free_card(torch)
    return out


def phase_serve(torch, np):
    """The serving path at full width: qwen3-1.7b as published (bf16, 28
    layers) through GenerateService on decode_path "auto" (K10), the two
    workloads, then the precision checks (fp32 at full depth)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(ARCH_SERVE)
    return serve_path(
        torch, np, cfg, dataclasses.replace(cfg, dtype="float32"),
        BF16_LOGIT_RTOL,
        f"{ARCH_SERVE} as published ({cfg.n_layers} layers, d {cfg.d_model},"
        f" {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, vocab "
        f"{cfg.vocab}, {cfg.dtype})")


ARCH_SC2 = "starcoder2-7b"   # as published: bf16, 32 layers, d 4608, 36/4
#   heads of 128 (H/Hkv x hd = 1,152), d_ff 18432, vocab 49,152: 10.1e9
#   weights, 20.2 GB in bf16; nothing cut


def phase_serve_starcoder2(torch, np):
    """starcoder2-7b as published (bf16, 32 layers, random weights from seed
    0) through GenerateService on decode_path "auto" (K10 at H/Hkv 9) for
    workload (a) with its checks and timings, then the bf16 teacher-forced
    kernel-vs-gather logits check at BF16_LOGIT_RTOL with its planted
    fault; the model is freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(ARCH_SC2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    torch.cuda.synchronize()
    n_par = tree_numel(params)
    log(f"[serve-sc2] {ARCH_SC2} as published ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
        f"vocab {cfg.vocab}, {cfg.dtype}): {n_par:,} weights drawn on the "
        f"card in {time.perf_counter() - t0:.2f} s (seed 0), peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB while "
        f"drawing")
    name, slots, plen, new = SERVE_WORKLOADS[0]
    work = serve_workload(np, cfg.vocab, slots, plen, new)
    run = run_service(torch, np, params, cfg, work, slots, plen, new, "auto")
    ticks = check_served(np, cfg, name, run, work, "kernel")
    out = {"weights": n_par, name: serve_timings(np, name, run),
           "launches": run["launches"]["paged_gqa"], "ticks": ticks}
    log(f"[serve-sc2] ({name}) {slots} slots, prompt {plen}, up to {new} new "
        f"tokens, {len(work)} requests: every request done with its budget, "
        f"pool empty, path kernel, degrade level 0, retries 0, launches "
        f"{run['launches']} (paged_gqa = {cfg.n_layers} layers x {ticks} "
        f"ticks), no plain version")
    del run
    out["bf16_logit_rel"] = teacher_forced(torch, np, params, cfg,
                                           BF16_LOGIT_RTOL)
    del params
    free_card(torch)
    return out


def phase_k10_timing(torch, np, errs, serve, card):
    """K10 per launch at workload (b)'s shape in the middle of its decode
    (8 slots at position 288, 37 of 40 pages walked, bf16), over 28
    distinct layer pools as one decode tick has them, beside its bound,
    its plain version and the library yardstick; at workload (a)'s; and at
    (b)'s with starcoder2-7b's heads (36 / 4)."""
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.kernels.paged_attention import ref
    import torch.nn.functional as F
    L, hd, ps = 28, 128, SERVE_PAGE
    rng = np.random.default_rng(13)
    rows_out = {}
    for name, bs, pos_v, max_pages, h, hkv in (
            ("b", 8, 288, 40, 16, 8), ("a", 4, 20, 5, 16, 8),
            ("starcoder2", 8, 288, 40, 36, 4)):
        n_pages = bs * max_pages
        dt = torch.bfloat16

        def rnd(*shape):
            return torch.tensor(rng.standard_normal(shape) * 0.5,
                                dtype=torch.float32, device="cuda").to(dt)

        kps = [rnd(n_pages, ps, hkv, hd) for _ in range(L)]
        vps = [rnd(n_pages, ps, hkv, hd) for _ in range(L)]
        q, kn, vn = rnd(bs, h, hd), rnd(bs, hkv, hd), rnd(bs, hkv, hd)
        rows = torch.as_tensor(rng.permutation(n_pages).reshape(
            bs, max_pages), dtype=torch.int32, device="cuda")
        pos = torch.full((bs,), pos_v, dtype=torch.int32, device="cuda")
        o = torch.empty_like(q)

        def tick():
            for i in range(L):
                pak.paged_gqa(q, kn, vn, kps[i], vps[i], rows, pos, o)

        ms = median_of(lambda: graph_ms(torch, tick, reps=2)) / L
        enq = median_of(lambda: events_ms(torch, tick, 5)) / L
        kp0, vp0 = kps[0].clone(), vps[0].clone()
        pms = median_of(lambda: events_ms(
            torch, lambda: ref.paged_gqa_decode_ref(
                q, kn, vn, kp0, vp0, rows, pos, page_size=ps), 10))
        # the timed launch's output against the plain version's on the
        # same inputs (kp0, vp0 hold the new cell like kps[0], vps[0])
        want = ref.paged_gqa_decode_ref(q, kn, vn, kp0, vp0, rows, pos,
                                        page_size=ps)[0].float().cpu()
        pak.paged_gqa(q, kn, vn, kps[0], vps[0], rows, pos, o)
        np.testing.assert_allclose(o.float().cpu().numpy(), want.numpy(),
                                   err_msg=f"K10 at the timed shape ({name})",
                                   **PAGED_TOL["bfloat16"])
        # library yardstick: F.scaled_dot_product_attention over the window
        # gathered beforehand (not timed), the new cell already in place;
        # never called by the port
        n_walk = pos_v // ps + 1
        win = n_walk * ps

        def window(pool):
            w = pool[rows[:, :n_walk].long()].reshape(bs, win, hkv, hd)
            return w.transpose(1, 2).contiguous()

        kw, vw = window(kps[0]), window(vps[0])
        mask = (torch.arange(win, device="cuda")[None, :]
                <= pos[:, None].long())[:, None, None, :]
        q4 = q[:, :, None, :]

        def lib():
            return F.scaled_dot_product_attention(q4, kw, vw, attn_mask=mask,
                                                  enable_gqa=True)

        lms = median_of(lambda: graph_ms(torch, lib, reps=20))
        # the yardstick computes the kernel's function (same window: the
        # walk has just written the new cell into kps[0])
        pak.paged_gqa(q, kn, vn, kps[0], vps[0], rows, pos, o)
        kw, vw = window(kps[0]), window(vps[0])
        got = lib()[:, :, 0].float()
        torch.cuda.synchronize()
        lerr = float((got - o.float()).abs().max())
        if not lerr <= 2 ** -6:
            fail(f"K10 yardstick disagrees with the kernel: {lerr:.3e}")
        positions = bs * (pos_v + 1)
        nbytes = (2 * positions * hkv * hd * 2          # K, V rows walked
                  + 2 * bs * h * hd * 2                 # q in, o out
                  + 2 * 2 * bs * hkv * hd * 2           # new cells in, out
                  + bs * n_walk * 4 + bs * 4)           # page rows, pos
        flops = positions * h * 4 * hd                  # q.k and p.v
        bms, by = bound_ms(flops, nbytes, BF16_PEAK)
        rows_out[name] = dict(ms=ms, enq=enq, pms=pms, lms=lms, bms=bms,
                              by=by, nbytes=nbytes)
        log(f"[k10-time] ({name}) bs {bs}, pos {pos_v} ({n_walk} pages "
            f"walked), H {h}, Hkv {hkv}, hd {hd}, ps {ps}, bf16, 28 layer "
            f"pools: {ms:.5f} ms a launch on the device (CUDA graph, median "
            f"of 3), {enq:.5f} ms a launch from Python; bound {bms:.5f} ms "
            f"({by}: {nbytes} bytes at 3.35 TB/s); plain {pms:.4f} ms; "
            f"library (F.scaled_dot_product_attention over the window "
            f"gathered beforehand) {lms:.5f} ms, max |Δ| {lerr:.2e}; {card}")
        del kps, vps
    b, a, sc2 = rows_out["b"], rows_out["a"], rows_out["starcoder2"]
    return {"name": "paged_gqa", "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/"
                      "paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:206",
            "launches": serve["launches"],
            "max_abs_err": max(errs.values()),
            "max_abs_err_fp32": errs["float32"],
            "max_abs_err_bf16": errs["bfloat16"],
            "ms": b["ms"], "launch_from_python_ms": b["enq"],
            "plain_ms": b["pms"], "bound_ms": b["bms"], "bound_by": b["by"],
            "library_ms": b["lms"],
            "library": "F.scaled_dot_product_attention(enable_gqa=True) "
                       "over the window gathered beforehand",
            "shape": "bs 8, pos 288 (37 pages), H 16, Hkv 8, hd 128, ps 8, "
                     "bf16",
            "ms_a": a["ms"], "plain_ms_a": a["pms"], "bound_ms_a": a["bms"],
            "library_ms_a": a["lms"],
            "shape_a": "bs 4, pos 20 (3 pages)",
            "ms_starcoder2": sc2["ms"], "plain_ms_starcoder2": sc2["pms"],
            "bound_ms_starcoder2": sc2["bms"],
            "library_ms_starcoder2": sc2["lms"],
            "shape_starcoder2": "bs 8, pos 288 (37 pages), H 36, Hkv 4, "
                                "hd 128, ps 8, bf16",
            "decode_ticks": serve["ticks"]}


# ---------------------------------------------------------------------------
# slice 4: serving deepseek-v3-671b (MoE + MLA) with K11
# ---------------------------------------------------------------------------

ARCH_MLA = "deepseek-v3-671b"   # as published: d 7168, 128 heads, q_lora
#   1536, kv_lora 512, rope 64, nope 128, v 128, 256 routed experts top-8 + 1
#   shared, moe_d_ff 2048, d_ff 18432, vocab 129,280, bf16
MLA_LAYERS = 5        # its 3 dense and first 2 MoE layers: 53.2 GB in bf16
#                       (each MoE layer 257 experts, 22.6 GB); 61 cannot fit
MLA_FP32_LAYERS = (2, 1)   # the fp32 copy: 1 dense + 1 MoE layer, 55.8 GB
# (H, lat, rope, page, dtype, scale): deepseek-v3-671b --reduced (H 4, lat
# 32, rope 16, scale (nope 32 + rope 16)^-0.5), the reference's property
# test (lat 16, rope 8, scale (lat + rope)^-0.5) and the published widths
# (scale (nope 128 + rope 64)^-0.5), page 8 and 16, fp32 and bf16 (bf16:
# the tensor-core kernel), and two widths off its tiles in bf16 (rope 12
# and 4: element loads; H 6 and 3).  The tolerances are K10's
# (PAGED_TOL): fp32 the reference's kernel-vs-oracle one; bf16 one ulp of
# the output, since both compute in float from the same bf16 operands and
# round once (the kernel keeps p as two bf16 parts for p . c).
MLA_SHAPES = ((4, 32, 16, 8, "float32", 48 ** -0.5),
              (4, 32, 16, 16, "bfloat16", 48 ** -0.5),
              (4, 32, 16, 8, "bfloat16", 48 ** -0.5),
              (4, 16, 8, 8, "float32", 24 ** -0.5),
              (4, 16, 8, 8, "bfloat16", 24 ** -0.5),
              (128, 512, 64, 8, "float32", 192 ** -0.5),
              (128, 512, 64, 16, "float32", 192 ** -0.5),
              (128, 512, 64, 8, "bfloat16", 192 ** -0.5),
              (128, 512, 64, 16, "bfloat16", 192 ** -0.5),
              (6, 40, 12, 8, "bfloat16", 0.1),
              (3, 20, 4, 16, "bfloat16", 0.2))
MLA_SCALE = 192 ** -0.5
# deepseek kernel vs gather logits over the teacher-forced bf16 steps, every
# step's ‖Δ‖/‖logits‖, as for qwen3.  On an H100 the largest step is 4.43e-2
# (median 2.51e-2; the inputs are seeded, so the steps repeat run to run) and
# the planted fault (the walk one page short) 9.97e-2 at its least step; the
# limit sits between them.  A step where the two paths' rounding swaps one of
# a token's top 8 experts of 256 on a near tie would spike alone: the steps
# are printed one by one to tell that from a fault.
MLA_BF16_LOGIT_RTOL = 6.5e-2




def phase_k11(torch, np):
    """K11 against its plain version on the card, the cases of
    tests/test_torch_gpu.py; returns max |err| per storage type."""
    from repro_torch.kernels.paged_attention import ops, ref
    errs = {"float32": 0.0, "bfloat16": 0.0}

    def check(operands, rows, pos, ps, dtype, scale, what):
        hold_paged(torch, np, "K11", ops.paged_mla_decode,
                   ref.paged_mla_decode_ref, operands, rows, pos, ps, dtype,
                   what, errs, scale=scale)

    n = 0
    for bs in (1, 3, 8):
        for (h, lat, rope, ps, dt, scale) in MLA_SHAPES:
            ops_, rows, pos = ref.random_case(bs, ps, getattr(torch, dt), bs,
                                              "cuda", mla=True, n_heads=h,
                                              lat=lat, rope=rope)
            check(ops_, rows, pos, ps, dt, scale, f"bs {bs} H {h} lat {lat} "
                  f"rope {rope} ps {ps} {dt}")
            n += 1
    for dt in ("float32", "bfloat16"):
        for ps in (8, 16):
            # workload (b)'s depth: 8 slots at positions 256-319, up to 40
            # pages of 8 walked (20 of 16)
            ops_, rows, pos = ref.random_case(8, ps, getattr(torch, dt), 21,
                                              "cuda", mla=True,
                                              pos=SERVE_DEPTH_POS,
                                              max_pages=320 // ps, n_heads=128,
                                              lat=512, rope=64)
            check(ops_, rows, pos, ps, dt, MLA_SCALE,
                  f"serving depth ps {ps} {dt}")
        # stale non-finite tails (NaN latents, +inf RoPE keys after pos)
        ops_, rows, pos = ref.random_case(4, 8, getattr(torch, dt), 11, "cuda",
                                          mla=True, stale_tail=True,
                                          pos=[0, 7, 8, 13], n_heads=128,
                                          lat=512, rope=64)
        check(ops_, rows, pos, 8, dt, MLA_SCALE, f"stale tail {dt}")
        n += 3
    # one slot's launch leaves the other slot's pages bitwise unchanged
    ops_, rows, pos = ref.random_case(2, 8, torch.bfloat16, 5, "cuda",
                                      mla=True, pos=[12, 20], n_heads=128,
                                      lat=512, rope=64)
    other_slot_untouched(torch, "K11", ops.paged_mla_decode, ops_, rows, pos,
                         8, scale=MLA_SCALE)
    # the bf16 split walk merges in a fixed order: two launches, same bits
    ops_, rows, pos = ref.random_case(8, 8, torch.bfloat16, 21, "cuda",
                                      mla=True, pos=SERVE_DEPTH_POS,
                                      max_pages=40, n_heads=128, lat=512,
                                      rope=64)
    first, again = (ops.paged_mla_decode(*[x.clone() for x in ops_],
                                         page_size=8, scale=MLA_SCALE)[0]
                    for _ in range(2))
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        fail("K11 bf16: two launches on the same inputs differ")
    log(f"[k11] paged_mla_decode vs plain on the card: {n + 1} cases (bs 1, "
        f"3, 8 x {len(MLA_SHAPES)} shapes: H 4 / lat 32 / rope 16, lat 16 / "
        f"rope 8, H 128 / lat 512 / rope 64, page 8 and 16, fp32 and bf16, "
        f"H 6 / lat 40 / rope 12 and H 3 / lat 20 / rope 4 in bf16; 8 slots "
        f"at positions {SERVE_DEPTH_POS[0]}-{SERVE_DEPTH_POS[-1]}, page 8 "
        f"and 16; stale non-finite tails; NaN unlisted pages; a second slot "
        f"untouched; two bf16 launches bitwise equal); max |err| fp32 "
        f"{errs['float32']:.3e}, bf16 {errs['bfloat16']:.3e}")
    return errs


def phase_serve_mla(torch, np):
    """The serving path for MoE + MLA at full width: deepseek-v3-671b cut
    to 5 layers (bf16) through GenerateService on decode_path "auto" (K11),
    the two workloads, then the precision checks (bf16 teacher-forced
    logits; fp32 streams token for token in a 1 dense + 1 MoE copy, since 5
    layers in fp32 would not fit)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ARCH_MLA), n_layers=MLA_LAYERS)
    n32, nd32 = MLA_FP32_LAYERS
    return serve_path(
        torch, np, cfg,
        dataclasses.replace(cfg, dtype="float32", n_layers=n32,
                            first_dense_layers=nd32),
        MLA_BF16_LOGIT_RTOL,
        f"{ARCH_MLA} at full width, {cfg.n_layers} layers "
        f"({cfg.first_dense_layers} dense, "
        f"{cfg.n_layers - cfg.first_dense_layers} MoE of {cfg.n_experts} + "
        f"{cfg.n_shared_experts} experts, top {cfg.experts_per_tok}), d "
        f"{cfg.d_model}, {cfg.n_heads} heads, kv_lora {cfg.kv_lora_rank}, "
        f"rope {cfg.qk_rope_dim}, vocab {cfg.vocab}, {cfg.dtype}")


def phase_k11_timing(torch, np, errs, serve, card):
    """K11 per launch at workload (b)'s shape in the middle of its decode
    (8 slots at position 288, 37 of 40 pages walked, bf16, full width), over
    28 distinct layer pools in one CUDA graph (82 MB, more than the 50 MB
    L2, as a tick's weight stream leaves it), beside its bound, its plain
    version and the library yardstick; and at workload (a)'s."""
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.kernels.paged_attention import ref
    import torch.nn.functional as F
    L, h, lat, rope, ps = 28, 128, 512, 64, SERVE_PAGE
    rng = np.random.default_rng(14)
    rows_out = {}
    for name, bs, pos_v, max_pages in (("b", 8, 288, 40), ("a", 4, 20, 5)):
        n_pages = bs * max_pages
        dt = torch.bfloat16

        def rnd(*shape):
            return torch.tensor(rng.standard_normal(shape) * 0.5,
                                dtype=torch.float32, device="cuda").to(dt)

        cps = [rnd(n_pages, ps, lat) for _ in range(L)]
        rps = [rnd(n_pages, ps, rope) for _ in range(L)]
        qe, qr = rnd(bs, h, lat), rnd(bs, h, rope)
        cn, rn = rnd(bs, lat), rnd(bs, rope)
        rows = torch.as_tensor(rng.permutation(n_pages).reshape(
            bs, max_pages), dtype=torch.int32, device="cuda")
        pos = torch.full((bs,), pos_v, dtype=torch.int32, device="cuda")
        ctx = torch.empty_like(qe)

        def tick():
            for i in range(L):
                pak.paged_mla(qe, qr, cn, rn, cps[i], rps[i], rows, pos, ctx,
                              MLA_SCALE)

        ms = median_of(lambda: graph_ms(torch, tick, reps=2)) / L
        enq = median_of(lambda: events_ms(torch, tick, 5)) / L
        cp0, rp0 = cps[0].clone(), rps[0].clone()
        pms = median_of(lambda: events_ms(
            torch, lambda: ref.paged_mla_decode_ref(
                qe, qr, cn, rn, cp0, rp0, rows, pos, page_size=ps,
                scale=MLA_SCALE), 10))
        # the timed launch's output against the plain version's on the
        # same inputs (cp0, rp0 hold the new cell like cps[0], rps[0])
        want = ref.paged_mla_decode_ref(qe, qr, cn, rn, cp0, rp0, rows, pos,
                                        page_size=ps, scale=MLA_SCALE)[0]
        pak.paged_mla(qe, qr, cn, rn, cps[0], rps[0], rows, pos, ctx,
                      MLA_SCALE)
        np.testing.assert_allclose(ctx.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   err_msg=f"K11 at the timed shape ({name})",
                                   **PAGED_TOL["bfloat16"])
        # library yardstick: F.scaled_dot_product_attention with one KV
        # head shared by the 128 query heads, q = [q_eff, q_rope], k = [c,
        # r], v = c over the window gathered beforehand (not timed), the new
        # cell already in place; never called by the port
        n_walk = pos_v // ps + 1
        win = n_walk * ps
        rws = rows[:, :n_walk].long()
        cw = cps[0][rws].reshape(bs, 1, win, lat)
        kw = torch.cat([cw, rps[0][rws].reshape(bs, 1, win, rope)], dim=-1)
        q4 = torch.cat([qe, qr], dim=-1)[:, :, None, :]
        mask = (torch.arange(win, device="cuda")[None, :]
                <= pos[:, None].long())[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(q4, kw, cw, attn_mask=mask,
                                                  scale=MLA_SCALE,
                                                  enable_gqa=True)

        lms = median_of(lambda: graph_ms(torch, lib, reps=20))
        got = lib()[:, :, 0].float()
        torch.cuda.synchronize()
        lerr = float((got - ctx.float()).abs().max())
        if not lerr <= 2 ** -6:
            fail(f"K11 yardstick disagrees with the kernel: {lerr:.3e}")
        positions = bs * (pos_v + 1)
        nbytes = (positions * (lat + rope) * 2          # latent rows walked
                  + bs * h * (lat + rope) * 2           # q_eff, q_rope in
                  + bs * h * lat * 2                    # ctx out
                  + 2 * bs * (lat + rope) * 2           # new cells in, out
                  + bs * n_walk * 4 + bs * 4)           # page rows, pos
        flops = positions * h * (lat + rope + lat) * 2  # scores and context
        bms, by = bound_ms(flops, nbytes, BF16_PEAK)
        rows_out[name] = dict(ms=ms, enq=enq, pms=pms, lms=lms, bms=bms,
                              by=by, nbytes=nbytes, flops=flops)
        log(f"[k11-time] ({name}) bs {bs}, pos {pos_v} ({n_walk} pages "
            f"walked), H {h}, lat {lat}, rope {rope}, ps {ps}, bf16, {L} "
            f"layer pools: {ms:.5f} ms a launch on the device (CUDA graph, "
            f"median of 3), {enq:.5f} ms a launch from Python; bound "
            f"{bms:.5f} ms ({by}: {flops} operations at 989 TFLOP/s bf16, "
            f"{nbytes} bytes at 3.35 TB/s); plain {pms:.4f} ms; library "
            f"(F.scaled_dot_product_attention, enable_gqa, over the window "
            f"gathered beforehand) {lms:.5f} ms, max |Δ| {lerr:.2e}; {card}")
        del cps, rps
    b, a = rows_out["b"], rows_out["a"]
    return {"name": "paged_mla", "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/"
                      "paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:233",
            "launches": serve["launches"],
            "max_abs_err": max(errs.values()),
            "max_abs_err_fp32": errs["float32"],
            "max_abs_err_bf16": errs["bfloat16"],
            "ms": b["ms"], "launch_from_python_ms": b["enq"],
            "plain_ms": b["pms"], "bound_ms": b["bms"], "bound_by": b["by"],
            "library_ms": b["lms"],
            "library": "F.scaled_dot_product_attention(enable_gqa=True), q "
                       "[q_eff, q_rope] (bs,128,1,576), k [c, r] (bs,1,W,576)"
                       ", v c, over the window gathered beforehand",
            "shape": "bs 8, pos 288 (37 pages), H 128, lat 512, rope 64, ps "
                     "8, bf16",
            "ms_a": a["ms"], "plain_ms_a": a["pms"], "bound_ms_a": a["bms"],
            "library_ms_a": a["lms"],
            "shape_a": "bs 4, pos 20 (3 pages)",
            "decode_ticks": serve["ticks"]}


# ---------------------------------------------------------------------------
# the pipelined value-and-grad (K9) and flash attention (K12)
# ---------------------------------------------------------------------------

PIPE_FULL = (8, 64, 32, 2048)   # (S, M, Bt, D): the reference bench's FULL
#                                 schedule (benchmarks/engine_dispatch.py),
#                                 qwen3-1.7b's hidden width, 32 rows a micro
PIPE_SHAPES = ((3, 6, 4, 8), (8, 64, 4, 32),        # the reference's widths
               (1, 3, 4, 8), (3, 1, 4, 8), (2, 3, 1, 8),   # S, M, Bt = 1
               (2, 4, 4, 40), (3, 2, 5, 100))              # D off the tile
PIPE_TOL = dict(rtol=1e-5, atol=1e-6)   # the reference's pipeline tolerance
#                   (tests/test_backends.py:224-227), K9 vs its plain walk
PIPE_WIDE = (PIPE_FULL, (2, 3, 40, 600), (3, 2, 65, 513))   # D > 512: F
#                   and cot_in tiles of 2 to 4 reduction splits, the last
#                   ragged at 600 and 513; Bt 40 and 65: two and three row
#                   tiles
K9_REL_TOL = 1e-5   # K9 vs its plain walk at PIPE_WIDE, each state buffer,
#                   ‖Δ‖_F / ‖plain‖_F.  Elementwise, PIPE_TOL fails there on
#                   acts near 0 (|Δ| 1.7e-6: the splits and cuBLAS sum 2,048
#                   terms in other orders).  On an H100 (700 W) the worst
#                   buffer read 9.7e-7 (gW at full width) and the plain walk
#                   under TF32, a lower-precision control this phase runs
#                   again, 2.8e-4 at least: the limit sits between them
PIPE_REL_TOL = 1e-5   # each mode vs a float64 autograd of the monolithic
#                   loss, loss and each gradient leaf, relative (Frobenius).
#                   n·u = 2048 · 2⁻²⁴ ≈ 1.2e-4 is only the ceiling for fp32
#                   dot products over 2,048 terms; on an H100 (700 W) the
#                   worst leaf read 9.2e-7 and the sequential mode under
#                   TF32, a control this phase runs again, 9.6e-4
FA_SHAPES = ((4, 128, 64), (4, 256, 64), (4, 512, 64), (2, 128, 32),
             (2, 256, 128))   # hd 128 at blocks 128: the timed shape's width
# (BH, Sq, Sk, hd, block_q, block_k): the shapes the reference takes beyond
# those — hd 48, 112 (zamba2-7b's), 256, 50 (rows not on 16 bytes: the
# kernel's element-wise loads), 320 and 512 (two chunks of the head), caller
# blocks 32, 96 and 256, Sq != Sk; the kernel's own tiles mask the ragged
# edges
FA_WIDE = ((2, 256, 256, 48, 64, 128), (2, 256, 256, 112, 128, 64),
           (2, 256, 256, 256, 128, 128), (2, 192, 192, 112, 32, 96),
           (2, 768, 768, 64, 256, 96), (2, 192, 384, 128, 96, 128),
           (2, 384, 192, 64, 128, 32), (2, 160, 160, 50, 32, 32),
           (1, 96, 96, 256, 96, 32),
           (2, 192, 128, 320, 64, 64),    # hd > 256: the chunked path
           (1, 128, 192, 512, 64, 32))
FA_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),   # the reference's
          "bfloat16": dict(atol=2e-2, rtol=2e-2)}  # (test_kernels_flash.py)
FA_ROW_TOL = 2e-2   # K12 vs plain at the timed shape, bf16: the worst row's
#                   ‖Δ‖₂ / ‖plain‖₂ over hd, about five bf16 roundings
#                   (2⁻⁸ each).  |o| falls as 0.5/√(keys a row sees), so
#                   the reference's absolute 2e-2 would pass a kernel that
#                   lost late key tiles.  On an H100 (700 W) the kernel read
#                   1.9e-3 (blocks 128) and 2.1e-3 (64); an output without
#                   the last 64 keys, a planted fault this phase computes
#                   again, 0.15
FA_TIMED = (1, 4096, 16, 128)   # (B, S, H, hd): qwen3-1.7b's query heads and
#                                 width, the reference kernel's 4,096 keys
FA_HD112 = 112                  # zamba2-7b's head width, timed beside it


def pipe_table(S, M):
    """The port's lowered pipeline table for (S, M), as the engine lowers
    it."""
    from repro_torch import engine
    from repro_torch.pipeline import exec as pexec
    from repro_torch.pipeline import lower_pipeline_plan
    sched, _, plan = lower_pipeline_plan(S, M, per_stage_window=True)
    reg = pexec._PipeRunner([pexec.dense_stage] * S, pexec.mse_loss,
                            [{}] * S, [{}] * M).registry()
    return engine.lower_tables(plan, sched, reg,
                               arg_width=engine.PIPE_ARG_WIDTH,
                               row_access=engine.pipe_row_access)


def pipe_inputs(torch, S, M, Bt, D, seed):
    """Stage weights N(0, 1/D) (tanh stays unsaturated), b = 0, x and y
    N(0, 1), float32 on the card, from an explicit generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    params = [{"w": randn(D, D, scale=D ** -0.5),
               "b": torch.zeros(D, device="cuda")} for _ in range(S)]
    micro = [{"x": randn(Bt, D), "y": randn(Bt, D)} for _ in range(M)]
    return params, micro


def pipe_state(torch, S, M, Bt, D, seed):
    """(table, statics, a factory of zeroed state) for the walk."""
    from repro_torch.pipeline import exec as pexec
    params, micro = pipe_inputs(torch, S, M, Bt, D, seed)
    hooks = pexec._engine_hooks(params, micro, (S, M, Bt, D), {},
                                torch.device("cuda"))
    return pipe_table(S, M), hooks.statics(), hooks.buffers


PIPE_BUFS = ("acts", "cots", "gw", "gb", "loss")


def k9_runs(torch, shape):
    """Two K9 walks and the plain walk of one shape, from fresh state;
    fails if the two K9 walks differ in a bit."""
    from repro_torch import engine
    S, M, Bt, D = shape
    tab, statics, fresh = pipe_state(torch, S, M, Bt, D, seed=S + D)
    desc = torch.as_tensor(tab.desc, device="cuda")
    bounds = tuple(int(b) for b in tab.phase_offsets)
    runs = []
    for _ in range(2):
        bufs = fresh()
        engine.pipe_round_fn(1.0 / M)(desc, bounds, statics, bufs)
        runs.append(bufs)

    def plain():
        bufs = fresh()
        engine.pipe_walk_plain(tab.desc, bounds, statics, bufs, 1.0 / M)
        torch.cuda.synchronize()
        return bufs

    for name, got, again in zip(PIPE_BUFS, *runs):
        if not torch.equal(got, again):
            fail(f"K9 at {shape}: two runs differ in {name}")
        if not bool(torch.isfinite(got).all()):
            fail(f"K9 at {shape}: non-finite {name}")
    return runs[0], plain


def buf_gaps(torch, got, want):
    """{buffer: ‖got − want‖_F / ‖want‖_F}."""
    return {n: float((g.double() - w.double()).norm() / w.double().norm())
            for n, g, w in zip(PIPE_BUFS, got, want)}


def phase_k9(torch, np):
    """K9 against the plain walk on the card, two runs bitwise equal: every
    buffer elementwise at the reference's shapes, and by norm at PIPE_WIDE,
    where the plain walk under TF32 must fail the same limit."""
    worst = 0.0
    for shape in PIPE_SHAPES:
        got, plain = k9_runs(torch, shape)
        for name, g, w in zip(PIPE_BUFS, got, plain()):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            np.testing.assert_allclose(g, w, err_msg=f"K9 {name} at "
                                       f"{shape}", **PIPE_TOL)
            worst = max(worst, float(np.abs(g - w).max()))
    wide = {}
    for shape in PIPE_WIDE:
        got, plain = k9_runs(torch, shape)
        want = plain()
        gaps = buf_gaps(torch, got, want)
        worst = max([worst] + [float((g - w).abs().max())
                               for g, w in zip(got, want)])
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = buf_gaps(torch, plain(), want)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        if max(gaps.values()) > K9_REL_TOL:
            fail(f"K9 at {shape} vs its plain walk: {gaps} (bound "
                 f"{K9_REL_TOL})")
        if not max(control.values()) > K9_REL_TOL:
            fail(f"the plain walk under TF32 at {shape} passes the bound "
                 f"{K9_REL_TOL}: {control}")
        wide[shape] = (max(gaps.values()), max(control.values()))
        del got, want
    log(f"[k9] K9 matches its plain walk on every state buffer at (S, M, "
        f"Bt, D) in {PIPE_SHAPES}, rtol {PIPE_TOL['rtol']} atol "
        f"{PIPE_TOL['atol']}, and in {PIPE_WIDE} within {K9_REL_TOL} "
        f"relative a buffer (worst buffer, the plain walk under TF32): "
        + ", ".join(f"{k} ({a:.2e}, {b:.2e})" for k, (a, b) in wide.items())
        + f"; max |err| {worst:.3e}; two runs bitwise equal")
    return worst, wide


def pipe_f64(torch, params, micro):
    """Loss and gradients of the unpipelined loss, float64 autograd."""
    ps = [{k: v.double().requires_grad_() for k, v in p.items()}
          for p in params]
    total = 0.0
    for mb in micro:
        h = mb["x"].double()
        for p in ps:
            h = torch.tanh(h @ p["w"] + p["b"])
        total = total + torch.mean((h - mb["y"].double()) ** 2)
    total = total / len(micro)
    total.backward()
    return float(total.detach()), [{k: p[k].grad for k in ("w", "b")}
                                   for p in ps]


def pipe_gap(torch, loss, grads, want_loss, want_grads):
    """(loss relative gap, worst leaf's relative Frobenius gap)."""
    lrel = abs(float(loss) - want_loss) / abs(want_loss)
    grel = max(float(torch.linalg.norm(g[k].double() - w[k])
                     / torch.linalg.norm(w[k]))
               for g, w in zip(grads, want_grads) for k in ("w", "b"))
    return lrel, grel


def run_pipe(torch, pipe, params, micro, mode):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.pipelined_value_and_grad_plan(
        [pipe.dense_stage] * len(params), pipe.mse_loss, params, micro,
        mode=mode)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_pipe(torch, np):
    """The pipeline path at full width in the four modes, each against a
    float64 autograd of the monolithic loss; the engine bitwise repeatable,
    K9 launched once for the engine's plan, no plain version."""
    from repro_torch import engine
    from repro_torch import pipeline as pipe
    from repro_torch.kernels.pipe_walk import kernel as pw_kernel
    S, M, Bt, D = PIPE_FULL
    params, micro = pipe_inputs(torch, S, M, Bt, D, seed=0)
    want_loss, want_grads = pipe_f64(torch, params, micro)
    norms = [float(torch.linalg.norm(g["w"])) for g in want_grads]
    if not all(np.isfinite(n) and n > 0 for n in norms):
        fail(f"vacuous float64 gradients: ‖gW_s‖ {norms}")
    tab = pipe_table(S, M)
    phases = int((np.diff(tab.phase_offsets) > 0).sum())
    reset_all_counts()
    outs, gaps, firsts = {}, {}, {}
    for mode in MODES:
        outs[mode], firsts[mode] = run_pipe(torch, pipe, params, micro, mode)
        gaps[mode] = pipe_gap(torch, *outs[mode], want_loss, want_grads)
    launches = pw_kernel.LAUNCHES["pipe_walk"]
    plain = plain_calls()
    if plain:
        fail(f"a plain version ran on the card: {plain}")
    if launches != engine.PIPE_LAUNCHES_PER_PLAN:
        fail(f"pipe_walk launched {launches} times for one engine plan of "
             f"{phases} non-empty phases, not "
             f"{engine.PIPE_LAUNCHES_PER_PLAN}")
    for mode, (lrel, grel) in gaps.items():
        if not (lrel < PIPE_REL_TOL and grel < PIPE_REL_TOL):
            fail(f"{mode}: loss gap {lrel:.3e}, worst gradient leaf "
                 f"{grel:.3e} against float64 (bound {PIPE_REL_TOL})")
    again, _ = run_pipe(torch, pipe, params, micro, "engine")
    first = outs["engine"]
    if not (torch.equal(again[0], first[0]) and all(
            torch.equal(a[k], b[k]) for a, b in zip(again[1], first[1])
            for k in ("w", "b"))):
        fail("two engine runs differ")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:   # the control: a lower-precision run the limit must refuse
        control = pipe_gap(torch, *run_pipe(torch, pipe, params, micro,
                                            "sequential")[0],
                           want_loss, want_grads)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if not max(control) > PIPE_REL_TOL:
        fail(f"the sequential mode under TF32 passes the bound "
             f"{PIPE_REL_TOL}: {control}")
    log(f"[pipe] (S, M, Bt, D) = {PIPE_FULL}, fp32: {tab.nr_items} rows, "
        f"{tab.nr_rounds} rounds, {phases} phases; float64 loss "
        f"{want_loss:.6f}, ‖gW_s‖ {min(norms):.3e}..{max(norms):.3e}; gap "
        f"to float64 (loss, worst leaf; bound {PIPE_REL_TOL}): "
        + ", ".join(f"{m} ({a:.2e}, {b:.2e})" for m, (a, b) in gaps.items())
        + f"; sequential under TF32 (the control) ({control[0]:.2e}, "
        f"{control[1]:.2e}); pipe_walk launches {launches} (one a plan, over "
        f"{phases} phases), no plain version; two engine runs bitwise equal; first "
        f"runs s: "
        + ", ".join(f"{m} {t:.3f}" for m, t in firsts.items()))
    return {"launches": launches, "phases": phases, "rows": tab.nr_items,
            "gaps": gaps, "control": control, "params": params,
            "micro": micro}


def walk_cost(tab, S, M, Bt, D):
    """Operations of the walk's rows, the bytes the function must move
    (each input and the state read once, the state written once), and the
    bytes this walk moves row by row (W_s re-read each row, gW_s read and
    written by each B row)."""
    et, first = tab.desc[:, 0], tab.desc[:, 5] > 0
    n_f, n_u = int((et == 0).sum()), int((et == 2).sum())
    n_b = int((et == 1).sum())
    n_cot = int(((et == 1) & ~first).sum())
    prod = 2 * Bt * D * D                 # one (Bt, D) x (D, D) product
    flops = ((n_f + n_b + n_cot) * prod + n_f * 3 * Bt * D
             + n_b * 4 * Bt * D + n_u * (D * D + D))
    slab, wd = Bt * D * 4, D * D * 4
    inputs = S * wd + S * D * 4 + 2 * M * slab          # w, b, x, y
    state = 2 * S * M * slab + S * wd + S * D * 4 + M * 4
    must = inputs + 2 * state
    rows = (n_f * (wd + 3 * slab) + n_b * (wd + 2 * wd + 4 * slab)
            + n_u * 2 * wd)
    return flops, must, rows


@contextlib.contextmanager
def k9_one_split():
    """K9 rebuilt with one reduction split a tile (KSPLIT 4096 for the
    shipped one) in place of the shipped library, for the split-K
    comparison; the shipped library is back on exit."""
    from repro_torch import _build
    from repro_torch.kernels.pipe_walk import kernel as pw_kernel
    text = pw_kernel.SOURCE.read_text()
    line = f"constexpr int KSPLIT = {pw_kernel.KSPLIT};"
    if line not in text:
        fail(f"{pw_kernel.SOURCE} has no line {line!r}")
    src = _build.build_dir() / "variants" / "pipe_walk_one_split.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(line, "constexpr int KSPLIT = 4096;"))
    saved = pw_kernel.SOURCE, pw_kernel.KSPLIT, pw_kernel._LIB
    pw_kernel.SOURCE, pw_kernel.KSPLIT, pw_kernel._LIB = src, 4096, None
    try:
        pw_kernel.lib()
        yield
    finally:
        pw_kernel.SOURCE, pw_kernel.KSPLIT, pw_kernel._LIB = saved


def phase_pipe_timing(torch, np, k9_err, k9_wide, run, card):
    """Each mode's wall time, the walk alone beside its bound, the plain
    walk, and the float32 autograd of the monolithic loss as context."""
    from repro_torch import engine
    from repro_torch import pipeline as pipe
    S, M, Bt, D = PIPE_FULL
    params, micro = run["params"], run["micro"]
    walls = {m: median_of(lambda: run_pipe(torch, pipe, params, micro,
                                           m)[1]) for m in MODES}
    tab, statics, fresh = pipe_state(torch, S, M, Bt, D, seed=0)
    desc = torch.as_tensor(tab.desc, device="cuda")
    bounds = tuple(int(b) for b in tab.phase_offsets)
    walk = engine.pipe_round_fn(1.0 / M)

    def walk_once():
        bufs = fresh()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        walk(desc, bounds, statics, bufs)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    walk_once()
    ms = median_of(walk_once)
    with k9_one_split():
        walk_once()
        ms_one = median_of(walk_once)

    def plain_once():
        bufs = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.pipe_walk_plain(tab.desc, bounds, statics, bufs, 1.0 / M)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_once()
    plain_ms = median_of(plain_once)
    ps = [{k: v.clone().requires_grad_() for k, v in p.items()}
          for p in params]

    def autograd32():
        total = 0.0
        for mb in micro:
            h = mb["x"]
            for p in ps:
                h = torch.tanh(h @ p["w"] + p["b"])
            total = total + torch.mean((h - mb["y"]) ** 2)
        return torch.autograd.grad(total / M, [t for p in ps
                                               for t in p.values()])

    ctx_ms = median_of(lambda: events_ms(torch, autograd32, 3))
    flops, must, rows = walk_cost(tab, S, M, Bt, D)
    bms, by = bound_ms(flops, must)
    row_ms = rows / HBM_RATE * 1e3
    log(f"[pipe-time] (S, M, Bt, D) = {PIPE_FULL}, fp32; wall s (median of "
        f"3): " + ", ".join(f"{m} {t:.4f}" for m, t in walls.items())
        + f"; K9 walk {ms:.3f} ms ({run['launches']} launch, CUDA events, "
        f"median of 3; {ms_one:.3f} ms with one reduction split a tile), "
        f"bound {bms:.3f} ms ({by}: {flops / 1e9:.1f} GFLOP "
        f"at 67 TFLOP/s fp32, {must / 1e9:.3f} GB to move at 3.35 TB/s), "
        f"{bms / ms:.3f} of it reached; the walk's row-by-row traffic, "
        f"{rows / 1e9:.1f} GB, takes {row_ms:.2f} ms at 3.35 TB/s, "
        f"{row_ms / ms:.3f} of that floor reached; plain walk "
        f"{plain_ms:.2f} ms; float32 autograd of the monolithic loss "
        f"(context, not a yardstick) {ctx_ms:.3f} ms; {card}")
    return {"name": "pipe_walk", "route": "cuda",
            "source": "src/repro_torch/kernels/pipe_walk/csrc/pipe_walk.cu",
            "replaces": "src/repro/engine/megakernel.py:427",
            "launches": run["launches"], "max_abs_err": k9_err,
            "rel_err_vs_plain": {str(k): v[0] for k, v in k9_wide.items()},
            "rel_err_tf32_control": {str(k): v[1]
                                     for k, v in k9_wide.items()},
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "ms_one_split": ms_one,
            "library": "none: no single PyTorch call computes the pipelined "
                       "F/B/U walk",
            "row_traffic_ms": row_ms,
            "share_of_bound": bms / ms, "share_of_row_traffic": row_ms / ms,
            "autograd_fp32_ms": ctx_ms,
            "wall_s": walls,
            "gaps_vs_float64": {m: list(g) for m, g in run["gaps"].items()},
            "gap_tf32_control": list(run["control"]),
            "shape": "S 8, M 64, Bt 32, D 2048, fp32, a whole plan"}


def phase_k12(torch, np):
    """K12 against its plain version on the card."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    errs = {"float32": 0.0, "bfloat16": 0.0}
    g = torch.Generator(device="cuda").manual_seed(12)
    n = 0
    for (bh, s, hd), dt, causal, bq, bk in itertools.product(
            FA_SHAPES, ("float32", "bfloat16"), (True, False), (64, 128),
            (64, 128)):
        if s % bq or s % bk:
            continue
        q, k, v = (torch.randn(bh, s, hd, generator=g, device="cuda")
                   .mul(0.5).to(getattr(torch, dt)) for _ in range(3))
        got = fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk)
        want = fref.attention_ref(q, k, v, causal=causal)
        gf, wf = got.float().cpu().numpy(), want.float().cpu().numpy()
        np.testing.assert_allclose(gf, wf, err_msg=f"K12 {dt} causal "
                                   f"{causal} {(bh, s, hd)} ({bq}, {bk})",
                                   **FA_TOL[dt])
        errs[dt] = max(errs[dt], float(np.abs(gf - wf).max()))
        n += 1
    for (bh, sq, sk, hd, bq, bk), dt, causal in itertools.product(
            FA_WIDE, ("float32", "bfloat16"), (True, False)):
        q = (torch.randn(bh, sq, hd, generator=g, device="cuda") * 0.5).to(
            getattr(torch, dt))
        k, v = ((torch.randn(bh, sk, hd, generator=g, device="cuda") * 0.5)
                .to(getattr(torch, dt)) for _ in range(2))
        got = fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk)
        want = fref.attention_ref(q, k, v, causal=causal)
        gf, wf = got.float().cpu().numpy(), want.float().cpu().numpy()
        np.testing.assert_allclose(gf, wf, err_msg=f"K12 {dt} causal "
                                   f"{causal} (BH, Sq, Sk, hd) "
                                   f"{(bh, sq, sk, hd)} ({bq}, {bk})",
                                   **FA_TOL[dt])
        errs[dt] = max(errs[dt], float(np.abs(gf - wf).max()))
        n += 1
    q, k, v = (torch.randn(2, 100, 3, 32, generator=g, device="cuda") * 0.5
               for _ in range(3))
    got = fops.flash_attention_bshd(q, k, v, block_q=64, block_k=64)
    np.testing.assert_allclose(got.cpu().numpy(), fops.attention_ref_bshd(
        q, k, v).cpu().numpy(), err_msg="K12 ragged S = 100",
        **FA_TOL["float32"])
    ones = {}
    for dt in ("float32", "bfloat16"):
        qd, kd = (t.transpose(1, 2)[0, :, :64].to(getattr(torch, dt))
                  .contiguous() for t in (q, k))
        o = fa.flash_attention(qd, kd, torch.ones_like(qd), block_q=64,
                               block_k=64)
        ones[dt] = float((o.float() - 1.0).abs().max())
        if not ones[dt] <= 1e-5:
            fail(f"K12 with v = ones, {dt}: max |o - 1| {ones[dt]:.3e}")
    torch.cuda.synchronize()
    log(f"[k12] K12 matches its plain version in {n} cases ((BH, S, hd) in "
        f"{FA_SHAPES}, blocks 64 and 128; (BH, Sq, Sk, hd, block_q, block_k) "
        f"in {FA_WIDE}; fp32 and bf16, causal and not), "
        f"fp32 atol 2e-5 rtol 1e-4, bf16 2e-2: max |err| {errs}; the op on "
        f"a ragged S = 100 matches; v = ones gives max |o - 1| {ones}")
    return errs


def phase_k12_path(torch):
    """The op's own entry point, once, at the timed shape: the counts show
    it launched K12 and no plain version."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fops
    B, S, H, hd = FA_TIMED
    g = torch.Generator(device="cuda").manual_seed(4096)
    q, k, v = (torch.randn(B, S, H, hd, generator=g, device="cuda")
               .mul(0.5).bfloat16() for _ in range(3))
    reset_all_counts()
    o = fops.flash_attention_bshd(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    if launches != 1 or plain_calls():
        fail(f"flash_attention_bshd: {launches} launches, plain "
             f"{plain_calls()}")
    if o.shape != q.shape or not bool(torch.isfinite(o).all()):
        fail("flash_attention_bshd: bad output")
    log(f"[k12-path] flash_attention_bshd at (B, S, H, hd) = {FA_TIMED}, "
        f"causal, bf16: one K12 launch, no plain version")
    return launches, (q, k, v, o)


def row_gap(got, want):
    """The worst row's ‖got − want‖₂ / ‖want‖₂ over the last axis."""
    d = got.float() - want.float()
    return float((d.norm(dim=-1) / want.float().norm(dim=-1)).max())


def phase_k12_timing(torch, np, errs, launches, qkvo, card):
    """K12 at the timed shape beside its bound, its plain version and
    F.scaled_dot_product_attention (the yardstick, never called by the
    port); then at hd 112 (zamba2-7b's width) the same way."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref as fref
    B, S, H, hd = FA_TIMED
    q, k, v, o = (t.transpose(1, 2).reshape(B * H, S, hd).contiguous()
                  for t in qkvo)
    ms = median_of(lambda: events_ms(
        torch, lambda: fa.flash_attention(q, k, v), 5))
    plain = median_of(lambda: events_ms(
        torch, lambda: fref.attention_ref(q, k, v), 3))
    want = fref.attention_ref(q, k, v)
    err = float((o.float() - want.float()).abs().max())
    row = row_gap(o, want)
    # the planted fault: the output of a kernel that lost the last 64 keys
    fault = row_gap(fref.attention_ref(q, k[:, :-64], v[:, :-64]), want)
    if not (err <= FA_TOL["bfloat16"]["atol"] and row <= FA_ROW_TOL):
        fail(f"K12 at the timed shape vs plain: max |err| {err:.3e}, worst "
             f"row {row:.3e} (bound {FA_ROW_TOL})")
    if not fault > FA_ROW_TOL:
        fail(f"an output without the last 64 keys passes the bound "
             f"{FA_ROW_TOL}: worst row {fault:.3e}")

    def lib_of(q_, k_, v_, width):
        q4, k4, v4 = (t.reshape(B, H, S, width) for t in (q_, k_, v_))
        return lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True)

    lib = lib_of(q, k, v, hd)
    lms = median_of(lambda: events_ms(torch, lib, 20))
    lerr = float((lib().reshape(B * H, S, hd).float() - o.float())
                 .abs().max())
    torch.cuda.synchronize()
    if not lerr <= FA_TOL["bfloat16"]["atol"]:
        fail(f"K12 yardstick disagrees with the kernel: {lerr:.3e}")
    pairs = B * H * S * (S + 1) // 2            # causal (query, key) pairs
    flops = pairs * 4 * hd                      # q·k and p·v
    nbytes = 4 * B * H * S * hd * 2             # q, k, v in; o out (bf16)
    bms, by = bound_ms(flops, nbytes, BF16_PEAK)
    log(f"[k12-time] (B, S, H, hd) = {FA_TIMED}, causal, bf16: {ms:.4f} ms "
        f"(CUDA events, median of 3; the kernel's tiles: 128 query rows, 64 "
        f"keys); bound {bms:.5f} ms ({by}: {flops / 1e9:.1f} GFLOP at 989 "
        f"TFLOP/s bf16, {nbytes / 1e6:.1f} MB at 3.35 TB/s), "
        f"{flops / ms / 1e9:.1f} TFLOP/s; plain {plain:.3f} ms; library "
        f"(F.scaled_dot_product_attention, is_causal) {lms:.4f} ms, max "
        f"|Δ| {lerr:.2e}; kernel vs plain: max |err| {err:.2e}, worst row "
        f"{row:.2e} (bound {FA_ROW_TOL}; without the last 64 keys "
        f"{fault:.2e}); {card}")
    # zamba2-7b's width: the kernel built for 128, columns past 112 zero
    g = torch.Generator(device="cuda").manual_seed(112)
    q2, k2, v2 = (torch.randn(B * H, S, FA_HD112, generator=g, device="cuda")
                  .mul(0.5).bfloat16() for _ in range(3))
    ms112 = median_of(lambda: events_ms(
        torch, lambda: fa.flash_attention(q2, k2, v2), 5))
    o2, want2 = fa.flash_attention(q2, k2, v2), fref.attention_ref(q2, k2, v2)
    err112, row112 = float((o2.float() - want2.float()).abs().max()), \
        row_gap(o2, want2)
    if not (err112 <= FA_TOL["bfloat16"]["atol"] and row112 <= FA_ROW_TOL):
        fail(f"K12 at hd {FA_HD112} vs plain: max |err| {err112:.3e}, worst "
             f"row {row112:.3e} (bound {FA_ROW_TOL})")
    lms112 = median_of(lambda: events_ms(torch, lib_of(q2, k2, v2, FA_HD112),
                                         20))
    flops112 = pairs * 4 * FA_HD112
    bms112, _ = bound_ms(flops112, 4 * B * H * S * FA_HD112 * 2, BF16_PEAK)
    log(f"[k12-time] hd {FA_HD112} (zamba2-7b), otherwise as above: "
        f"{ms112:.4f} ms, {flops112 / ms112 / 1e9:.1f} TFLOP/s; bound "
        f"{bms112:.5f} ms; library {lms112:.4f} ms; max |err| {err112:.2e}, "
        f"worst row {row112:.2e}; {card}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
            "launches": launches, "max_abs_err": max(errs.values()),
            "max_abs_err_fp32": errs["float32"],
            "max_abs_err_bf16": errs["bfloat16"],
            "row_rel_err_timed": row, "row_rel_err_planted_fault": fault,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lms,
            "library": "F.scaled_dot_product_attention(is_causal=True), "
                       "(1, 16, 4096, 128) bf16",
            "shape": "B 1, S 4096, H 16, hd 128, causal, bf16; the kernel's "
                     "tiles 128 x 64",
            "ms_hd112": ms112, "bound_ms_hd112": bms112,
            "library_ms_hd112": lms112, "row_rel_err_hd112": row112}


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
    a, launches, vs_cpu, wide = phase_main(torch, np)
    rows = phase_timing(torch, np, a, launches, errs, walk_err, vs_cpu,
                        wide, card)
    del a
    torch.cuda.empty_cache()
    nb_errs = phase_nbody_ops(torch, np)
    bh_err, ms20k, plain20k, rows20k = phase_bh_walk(torch, np)
    bh_launches, firsts = phase_bh_main(torch, np)
    paper_launches, paper_rounds = phase_bh_paper(torch, np)
    rows += phase_bh_timing(torch, np, firsts, bh_launches, paper_launches,
                            paper_rounds, nb_errs, bh_err,
                            {"ms": ms20k, "plain_ms": plain20k,
                             "rows": rows20k}, card)
    k10_errs = phase_k10(torch, np)
    serve = phase_serve(torch, np)
    rows.append(phase_k10_timing(torch, np, k10_errs, serve, card))
    log("[serve-json] " + json.dumps(
        {k: serve[k] for k in ("a", "b", "bf16_logit_rel", "profile")}))
    del serve
    free_card(torch)
    sc2 = phase_serve_starcoder2(torch, np)
    rows[-1]["launches_starcoder2"] = sc2["launches"]
    log("[serve-sc2-json] " + json.dumps(sc2))
    del sc2
    k11_errs = phase_k11(torch, np)
    serve_mla = phase_serve_mla(torch, np)
    rows.append(phase_k11_timing(torch, np, k11_errs, serve_mla, card))
    log("[serve-mla-json] " + json.dumps(
        {k: serve_mla[k] for k in ("weights", "init_peak_gib", "a", "b",
                                   "bf16_logit_rel", "profile")}))
    del serve_mla
    free_card(torch)
    k9_err, k9_wide = phase_k9(torch, np)
    pipe_run = phase_pipe(torch, np)
    rows.append(phase_pipe_timing(torch, np, k9_err, k9_wide, pipe_run,
                                  card))
    del pipe_run
    k12_errs = phase_k12(torch, np)
    k12_launches, qkvo = phase_k12_path(torch)
    rows.append(phase_k12_timing(torch, np, k12_errs, k12_launches, qkvo,
                                 card))
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
