#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one sm_90 card.  It
builds the port's CUDA kernels from the checkout's sources (one nvcc per
source, all at once) and drives the port's paths.  The tiled QR (paper
§4.1) at its benchmark size (2048² fp32, 64² tiles) through
``repro_torch.apps.qr.run_qr``; the Barnes-Hut tree code (§4.2) through
``repro_torch.apps.barneshut.solve`` at 100k particles in all four modes
and through solve's steps at the paper's 1M particles in engine mode; and
continuous-batching
serving through ``repro_torch.serve.GenerateService`` of qwen3-1.7b and
starcoder2-7b as published (bf16, 28 and 32 layers) and of
deepseek-v3-671b (MoE + MLA) at full width cut to its first 5 layers
(bf16), random weights from seed 0; the
pipelined value-and-grad through ``repro_torch.pipeline`` at (S, M, Bt, D)
= (8, 64, 32, 2048) in all four modes; the flash-attention op; and
training of qwen3-1.7b as published through
``repro_torch.trainer.loop.run_training`` (100 steps, a kill-and-resume
drill, an fp32 step against the CPU); measured round times
(``repro_torch.engine.measure_round_times``) replayed through the
simulator; the SSM family: falcon-mamba-7b served as published (bf16,
64 layers) and trained at full width cut to 8 layers; and the hybrid,
enc-dec and VLM families through ``repro_torch.models.serving``'s prefill
and decode_step as the static launcher drives them
(``repro_torch.launch.serve.generate``): zamba2-7b and whisper-tiny as
published, internvl2-76b at full width cut to 24 layers, each trained
through run_training (zamba2 at 15 layers, internvl2 at 2); and the
distributed layer: qwen3-1.7b's train step on DTensors over NCCL (world
size 1), the int8 compressed psum, the ring matmuls, the resharding
restore and the dry run (repro_torch.launch.dryrun) against the card and
at production size; the four examples' twins (examples/*_torch.py) in
this process; and granite-8b and phi4-mini-3.8b as published and
kimi-k2-1t-a32b at full width cut to 2 layers served on K10.
Phases, each fatal when it fails (each phase's seconds are logged):

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
    at 2048² (threaded one run) and engine mode at 4096², launches per plan (one), the walk
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
    engine mode, solve's steps one by one (phase 11 times the run): a
    float64 recomputation of the interaction lists of 256
    sampled leaves within 1e-4, the float64 direct sum for 4,096 sampled
    targets inside test_barneshut.py's accuracy bounds, and bh_walk
    launches per plan at most the plan's rounds.  The host modes run at
    100k and not at 1M: at 1M they would make about 800k per-op launches
    from Python, more than this script's time limit holds;
11. BH timings: solve per mode at 100k (the engine a median of 3, the
    host modes one run, a mode whose first run took 15 s or more,
    threaded, not run again) and engine at 1M (phase 10's one run), split
    into tree, graph, lowering and execution; the walk over the whole 1M
    plan, with
    the pair interactions it evaluates beside those the data needs and
    those a walk over the padded blocks evaluates; K6 and
    K7 at the path's shapes, each beside its bound and plain version (no
    single PyTorch call computes softened gravity, so they have no
    library yardstick), and K6 at 30 x 0 (no source: its launch floor);
12. K10 (paged GQA decode) against its plain version on the card: the
    reduced and the published widths of qwen3-1.7b (16/8 heads),
    starcoder2-7b (36/4), granite-8b (32/8), phi4-mini-3.8b (24/8) and
    kimi-k2-1t-a32b (64/8), page 8 and 16, fp32 and bf16, bs 1, 3 and 8,
    n_rep 16 (32/2) and hd 20 (rows not on 16 bytes); 8 slots at
    positions 256-319 (up to 40 pages) at
    all five head shapes; NaN unlisted pages, stale non-finite tails, two
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
    pools in a CUDA graph), and at (b)'s with starcoder2-7b's heads and
    with phase 36's three layouts (32/8, 24/8, 64/8),
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
    keys must fail; then at hd 112 (zamba2-7b's width), held the same way;
23. training, with the earlier models freed: qwen3-1.7b as published
    (bf16, 28 layers, 2.03e9 weights from seed 0) through
    repro_torch.trainer.loop.run_training with AdamW, 100 steps at
    launch/train.py's (seq 128, global batch 8), every count at 0 before
    and no kernel and no plain version launched after (no kernel is on
    this path), every parameter and moment on the card, every loss
    finite, the last 10 losses' mean below the first 10's by LOSS_MARGIN,
    which the same first 20 steps at lr 0 must not reach (and whose first
    loss must equal the run's); the step split by CUDA events into
    loss+gradients, clip and update over 8 more steps, tokens per second,
    peak memory, a profiler window of 2 steps (busy share, kernels a step,
    the matrix products' share); then 8 steps at (4096, 1), attention
    through sdpa_chunked (attn_chunk 2048) in the forward pass and the
    recompute of every layer (counted), the backward through autograd,
    and sdpa_chunked alone at that shape (forward, forward + backward);
24. the kill-and-resume drill at full width cut to 2 layers (a 28-layer
    checkpoint is ~24 GB a save): 20 steps uninterrupted, and 20 steps
    checkpointed every 10, killed at step 12 and resumed from step 10: the
    losses, the parameters and the moments bit for bit equal; its
    checkpoints' save and restore timed by the loop's spans; the
    workdirs deleted;
25. one fp32 train step of qwen3-1.7b at full width, 1 layer, (128, 1),
    TF32 off, on the card against the same step on the CPU: loss and grad
    norm within atol 2e-5 / rtol 1e-4, every gradient leaf within that
    and 1e-5 relative (Frobenius), the moments everywhere and the
    parameters where the clipped |g| exceeds 2e-5 within it; the same
    step under TF32 must fail that check;
26. measured round times: engine.measure_round_times on the 2048² / 64²
    QR plan (best of 3 per round): one walk launch a round (and a warm-up
    pass), the caller's buffers untouched, the final state bitwise one
    fused execute_plan's, the 1-worker replay (replay_round_times) equal
    to Σ round_s, and Σ round_s within 0.2–5x of the fused run (best of
    3; the reference's bound); on the 512² / 64² plan one launch an item,
    the 1-worker item replay equal to Σ item_s and the 4-worker one
    between the critical path of the measured task times and that sum;
27. falcon-mamba-7b as published (bf16, 64 layers, d 4096, d_inner 8192,
    N 16, 7.27e9 weights from seed 0) through GenerateService on
    decode_path "auto": the path resolves to gather (the SSM state is
    O(1), nothing is paged) and no kernel (K10/K11 included) and no plain
    version runs; 24 requests through 8 slots (prompts 128 and 256: the
    chunked scan; ragged 37–101: the stepwise scan; budgets 16/64/128),
    every request done, the pool empty; a 4,096-token request in the same
    state bytes; timings (tick on the device and the host, tok/s, TTFT,
    prefill at 256 and 4,096 tokens, a profiler window at 8 full slots);
    checks, each limit between a reading and a control that must fail
    it: (i) bf16 prefill(256) + decode_step against forward(257), last
    logits within SSM_LOGIT_RTOL, the decode with its carried h zeroed
    outside it, and the same in fp32 at full depth within
    SSM_LOGIT_RTOL_FP32; (ii) fp32, full width, 8 layers: 6 requests through 3
    slots token for token equal to a sequential prefill + decode_step;
    (iii) fp32, one full-width layer at (2, 256): the chunked scan
    within SCAN_RTOL of the stepwise one, the scan without its carry
    across chunks outside it;
28. falcon-mamba-7b at full width cut to 8 layers (AdamW at 64 layers
    needs ~87 GB), 20 run_training steps at (128, 8), deterministic: the
    last 5 losses' mean below the first 5's by SSM_LOSS_MARGIN, which the
    lr-0 control must not reach; step time and peak memory;
29. zamba2-7b as published (bf16, 81 layers: 13 sites of 6 Mamba2 layers
    each followed by one of 2 shared attention blocks at width 7168, 32
    heads of 224, then a 3-layer tail; 7.9e9 weights from seed 0) through
    launch.serve.generate: batch 8, prompt 256, 64 greedy new tokens, no
    kernel and no plain version run, tokens in the vocabulary; prefill
    ms, decode step ms, tok/s, peak memory and a profiler window of 4
    steps; (ii) a 4,096-token prompt, batch 1: the trunk state (conv
    windows and SSD state) byte for byte that of a 64-token cache; (i)
    prefill(256) + decode_step against forward(257), last logits within
    FAMILY_LIMITS in bf16 at 81 layers and in fp32 at 15, each control
    (the SSD state h zeroed) outside it;
30. whisper-tiny as published (bf16, 4 + 4 layers, 1,500 stub frames x
    0.02): batch 8, prompt 4, 128 new tokens, as 29; (iii) the cross
    cache after the 128 steps bitwise the prefill's; (i) in bf16 and
    fp32, the control with the cross K/V zeroed;
31. internvl2-76b at full width, 24 layers (45.3 GB; bf16, 256 stub patch
    embeddings x 0.02 before the prompt): batch 8, prompt 256, 64 new
    tokens, as 29; (i) in bf16 at 24 layers and fp32 at 2, the control
    with the patch positions' K/V zeroed;
32. run_training at (128, 8), AdamW, the families' zero stub inputs:
    zamba2-7b at 15 layers and whisper-tiny, 20 steps each beside the lr-0
    control (the last 5 losses' mean below the first 5's by
    SSM_LOSS_MARGIN, the control not), internvl2-76b at 2 layers, 4
    steps; step time and peak memory; no kernel on any of these paths;
33. the distributed layer (``repro_torch.dist``) on the card: NCCL opened
    at world size 1 over an in-process store (a failure to open it is
    fatal; nothing falls back to the CPU), a 1x1 DeviceMesh on cuda.
    (a) qwen3-1.7b as published (bf16, 28 layers, seed 0): its
    parameters, AdamW moments and the (128, 8) batch placed with
    param/opt/batch_pspecs -> shardings_for, one train step through
    trainer/steps.py bitwise equal to the same step on plain tensors
    (loss, every gradient, parameter and moment: deterministic cuBLAS,
    one rank), and again inside activation_sharding("data", "model"); no
    kernel and no plain version launched.  (b) compressed_psum over the
    NCCL group on that step's gradients: every leaf within scale/2 (plus
    PSUM_SUM_ULPS of its max, the product q·scale's rounding) of g + ef,
    out + ef' equal to g + ef within PSUM_SUM_ULPS of the leaf's max
    (two roundings of half an ulp); the wire bytes (int8 plus a scale a
    leaf) beside fp32's, its time (CUDA events), peak memory; then
    tests/test_dist.py's 200-step accumulation at the largest leaf's
    shape within PSUM_ACC_TOL (the reference's limit) of the true sum,
    and its control, the residual not carried, which must fail that
    limit.  (c) allgather_matmul and reducescatter_matmul at axis size 1
    at qwen3's MLP shape (1,024 x 2,048 · 2,048 x 6,144, bf16) bitwise
    x @ w, timed beside it.  (d) a 2-layer {params, opt} checkpoint saved
    as the training loop saves it, restored with shardings onto DTensors
    on the card, every leaf bit for bit with its placements.  (e) the
    dry run of (a)'s step on the 1x1 mesh (fake group, meta shards): its
    argument bytes exactly (a)'s params, moments and batch, its FLOPs
    exactly the card's step under the same counter (launch.dryrun.
    StepCounter; torch's FlopCounterMode printed beside), no collective;
    the dry run reports no peak (meta tensors have no allocator);
34. the dry run at production size on this machine: qwen3-1.7b train_4k
    on the single-pod mesh (a fake world of 256) and deepseek-v3-671b
    decode_32k on the multi-pod mesh (512), through launch.dryrun.
    run_cell: each cell's wall time, per-device bytes, FLOPs and
    collective counts (predictions over the reference's mesh shapes, not
    times of the card); a cell that errors, or counts no FLOPs or no
    collective, fails;
35. the four examples' twins, each ``main()`` in this process at the
    reference examples' defaults.  quickstart_torch: the Fig 2 order (A
    first) and makespan 3.0, the 96² QR's Gram identity within GRAM_TOL
    (R rounded to half precision must fail it), the engine's R bitwise the
    sequential R and within CPU_TOL of the CPU's, the dispatch counts,
    order and speedups equal to its own run with --device cpu, and K1-K5
    launched exactly as the CPU called their plain versions.
    nbody_torch at 20,000 particles (n_max 64, n_task 1000, seed 0, the
    sequential mode): acc_pair / acc_self launched once a self block, twice
    a direct pair and once a PC list, no plain version on the card; the
    graph counts equal to a host build and the efficiencies at 1, 8 and 32
    workers to the host's simulation (64 workers take ~27 s of host
    simulation, the reference's too, so that one is held by the CPU
    tests); the median and mean relative force error against the direct
    sum (computed on the card in target chunks) within the reference's 2e-2
    and 5e-2, which the same accelerations read in the input order must
    exceed.  trace_qr_torch: qr_walk launched twice a round and once an
    item plus one warm-up, the trace valid with processes measured and
    predicted and one task event an engine item in each (a copy with a
    negative duration refused).  train_lm_torch at its default width and
    at --full-width (~100M), 300 steps each at (128, 8): no kernel and no
    plain version, checkpoints at steps 100, 200 and 300, 16 greedy ids in
    the vocabulary, and the first 10 losses' mean above the last 10's by
    LOSS_MARGIN, which 20 steps at lr 0 (the same first loss) must not
    reach;
36. the published configurations the card had not served (CONFIG_SERVES),
    after every earlier phase, each alone on the card: granite-8b and
    phi4-mini-3.8b as published and kimi-k2-1t-a32b at full width cut to
    2 of its 61 layers (1 dense, 1 MoE of 384 experts: 61 layers would be
    ~2 TB; depth is cut, never width), bf16, weights from seed 0 (their
    count and bytes exactly init_params' on ``meta``), through
    GenerateService on "auto" (K10 at H/Hkv 4, 3 and 8) for workload (a):
    every request done with its budget, the pool empty, path "kernel",
    degrade level 0, K10 launched layers x ticks times, no plain version;
    wall time and tok/s; the bf16 teacher-forced kernel-vs-gather logits
    within BF16_LOGIT_RTOL, the planted fault above it at every step; for
    kimi-k2 (MoE) every step within MOE_BF16_LOGIT_RTOL, deepseek's limit
    (a token whose top 8 of 384 experts the two paths' roundings swap on
    a near tie spikes its step to 2.7e-2-3.9e-2), the steps where no
    token's experts differ within BF16_LOGIT_RTOL, the planted fault above
    both, and a profiler window of 8 steady ticks (kernels a tick, the
    expert products' ms a tick, the busy share).

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
# deterministic cuBLAS for the restart-exact training phases: read at the
# first cuBLAS call, so set before torch is imported
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        # threaded (~7 s a run, the GIL) once: phase 5 ran it once already
        walls[mode] = median_of(lambda: run_mode(torch, qr, a, mode)[1],
                                reps=1 if mode == "threaded" else 3)
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
    log(f"[time] run_qr wall s (median of 3; threaded one run): "
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
    """BH at the paper's 1M particles in engine mode, one run split into
    stages (``staged_solve``: solve's own steps, each synchronized), which
    phase 11 times too (two runs, one of them through ``solve``, until the
    examples and the three configurations came; the 100k runs of phase 9
    go through ``solve``).  Returns the launches, the plan's rounds, the
    stages and what the timing needs of the run."""
    from repro_torch.core import lower
    from repro_torch.kernels.nbody import kernel as nbk
    x, m = bh_inputs(np, N_PAPER)
    nbk.reset_counts()
    stages, keep = staged_solve(torch, x, m, NTASK_PAPER, "engine")
    secs = stages["total"]
    launches = dict(nbk.LAUNCHES)
    st = keep["st"]
    acc, g = st.acc, st.g
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
    log(f"[bh-paper] {N_PAPER} particles, engine: {secs:.1f} s (one run, its stages synchronized), "
        f"tasks self/pair/pc/com {c['self']}/{c['pair_pp']}/{c['pair_pc']}/"
        f"{c['com']}, bh_walk launches {launches['bh_walk']} for "
        f"{rounds} rounds; {SAMPLE_LEAVES} sampled leaves vs float64 "
        f"interaction lists {lists:.3e} (bound {BH_TOL}); {SAMPLE_TARGETS} "
        f"targets vs the float64 direct sum: median {med:.3e} (bound "
        f"{ACC_MEDIAN}), mean {mean:.3e} (bound {ACC_MEAN})")
    return launches, rounds, (stages, keep)


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
                    paper_rounds, paper_run, ops_err, walk_err, walk20k,
                    card):
    from repro_torch.kernels.nbody import kernel as nbk
    from repro_torch.kernels.nbody import ref
    x, m = bh_inputs(np, N_BH)
    for mode in MODES:
        # a median of 3 unless the first run was long (threaded: the GIL),
        # which is not run again: its wall time is phase 9's
        if firsts[mode] >= 15.0:
            log(f"[bh-time] {mode} at {N_BH}: not split into stages (its "
                f"first run took {firsts[mode]:.1f} s); {card}")
            continue
        # the host modes (~9 s a run at 100k) once, as phase 9 ran each
        # once already (3 until the examples and the three configurations
        # came); the engine a median of 3
        reps = 3 if mode == "engine" else 1
        runs = []
        for _ in range(reps):
            stages, keep = staged_solve(torch, x, m, NTASK_BH, mode)
            runs.append(stages)
        if mode == "engine":
            log_structure(np, keep, N_BH)
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        log(f"[bh-time] {mode} at {N_BH} (median of {reps}): "
            + ", ".join(f"{k} {v:.4f} s" for k, v in med.items())
            + f"; {card}")
    # phase 10's run: the 1M lowering is long (the script ran it three
    # times until the hybrid, enc-dec and VLM phases came, twice until the
    # examples and the three configurations)
    stages, keep = paper_run
    log(f"[bh-time] engine at {N_PAPER} (1 run): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in stages.items())
        + f"; {card}")
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
                (32, 8, 128, 8, "float32"),     # granite-8b: H/Hkv 4
                (32, 8, 128, 16, "float32"),
                (32, 8, 128, 8, "bfloat16"),
                (32, 8, 128, 16, "bfloat16"),
                (24, 8, 128, 8, "float32"),     # phi4-mini-3.8b: H/Hkv 3
                (24, 8, 128, 16, "float32"),
                (24, 8, 128, 8, "bfloat16"),
                (24, 8, 128, 16, "bfloat16"),
                (64, 8, 128, 8, "float32"),     # kimi-k2-1t-a32b: H/Hkv 8
                (64, 8, 128, 16, "float32"),
                (64, 8, 128, 8, "bfloat16"),
                (64, 8, 128, 16, "bfloat16"),
                (32, 2, 128, 8, "bfloat16"),    # n_rep 16: four head groups
                (8, 2, 20, 8, "bfloat16"))      # rows not on 16 bytes: the
#                                                 element-wise loads
# the layouts phase 36's models bring, timed at workload (b)'s geometry: all
# with Hkv 8 and hd 128, so their K/V bytes, and so K10's bound, are qwen3's;
# only the query heads a KV head change (4, 3 and 8 against qwen3's 2)
K10_LAYOUTS = {"granite": (32, 8), "phi4": (24, 8), "kimi": (64, 8)}
# (H, Hkv) of every GQA model served on K10: qwen3-1.7b, starcoder2-7b and
# those (all at hd 128)
K10_HEADS = ((16, 8), (36, 4)) + tuple(K10_LAYOUTS.values())
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
        # at the heads of every GQA model served on K10
        for h, hkv in K10_HEADS:
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
        n += len(K10_HEADS) + 1
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
        f"{', '.join(f'{h}/{k}' for h, k in K10_HEADS)}, stale non-finite "
        f"tails, NaN unlisted pages, two "
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


def teacher_forced(torch, np, params, cfg, limit, clean_limit=None):
    """Kernel vs gather logits over TEACHER_STEPS decode steps fed the same
    tokens, from one prefill of 8 prompts of 256: the paged pool (pages
    shuffled) through the paged kernel (K10 or K11), a contiguous copy
    through the gather math; then the paged steps again with the planted
    fault (the walk one page short) in the kernel's place.  Fails unless
    every step's gap is within ``limit`` and every planted step's exceeds
    it.  With ``clean_limit`` (a MoE model) it also counts, each step, the
    tokens whose top-k experts differ between the two paths in some MoE
    layer (a near tie that the two paths' roundings break apart), and every
    step in which no token's routing differs must be within
    ``clean_limit``."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.models import moe as moe_mod
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
    rels, maxs, gather, swapped = [], [], [], []
    routes, real_route = [], moe_mod._route

    def route(*a, **kw):            # each MoE layer's experts, sorted
        out = real_route(*a, **kw)
        routes.append(out[2].sort(-1).values)
        return out

    if clean_limit is not None:
        moe_mod._route = route
    try:
        for s in range(TEACHER_STEPS):
            routes.clear()
            lk, _ = serving.decode_step_paged(params, cfg, leaves, rows,
                                              teach[s], pos, page_size=ps)
            n_moe = len(routes)
            lg, _ = serving.decode_step(params, cfg, cache, teach[s], pos)
            lk, lg = lk.float(), lg.float()
            if not (torch.isfinite(lk).all() and torch.isfinite(lg).all()):
                fail("teacher-forced bf16 logits are not finite")
            rels.append(float((lk - lg).norm() / lg.norm()))
            maxs.append(float((lk - lg).abs().max() / lg.abs().max()))
            gather.append(lg)
            if clean_limit is not None:
                diff = torch.zeros(bs, dtype=torch.bool, device="cuda")
                for a, b in zip(routes[:n_moe], routes[n_moe:]):
                    diff |= (a != b).any(-1)
                swapped.append(int(diff.sum()))
            pos = pos + 1
    finally:
        moe_mod._route = real_route
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
    out = {}
    if clean_limit is not None:
        clean = [r for r, n in zip(rels, swapped) if not n]
        log(f"[serve] {cfg.name} tokens (of {bs}) whose top "
            f"{cfg.experts_per_tok} experts differ between the paths, per "
            f"step: {swapped}; the {len(clean)} steps with none: max "
            + (f"{max(clean):.3e}" if clean else "-")
            + f" (limit {clean_limit})")
        if not clean or not max(clean) <= clean_limit:
            fail(f"bf16 kernel vs gather logits on the steps whose routing "
                 f"agrees: {clean} (limit {clean_limit})")
        out = {"swapped_tokens": swapped, "clean_max": max(clean),
               "clean_steps": len(clean)}
    if not max(rels) <= limit:
        fail(f"bf16 kernel vs gather logits {max(rels):.3e} > {limit} at "
             f"step {int(np.argmax(rels))}")
    if not min(planted) > limit:
        fail(f"the logits check cannot see a walk one page short: its gap "
             f"{min(planted):.3e} <= {limit}")
    return {"max": max(rels), "median": float(np.median(rels)),
            "steps": rels, "planted_min": min(planted),
            "planted_median": float(np.median(planted)),
            "planted_steps": planted, **out}


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
# phase 36: the published configurations served on K10 after every earlier
# phase, (arch, layers kept (None: all), weights, bytes on the card).  The
# weights and bytes are init_params' on ``meta`` (tests/test_torch_serve.py
# holds them against the reference config's param_count() plus the norm
# scales): bf16 matrices, float32 norm scales and MoE router.
CONFIG_SERVES = (
    # granite-8b as published: 36 layers, d 4096, 32/8 heads of 128 (a
    # group of 4), d_ff 14336, vocab 49,152; nothing cut
    ("granite-8b", None, 8_254_689_280, 16_509_976_576),
    # phi4-mini-3.8b as published: 32 layers, d 3072, 24/8 heads of 128 (a
    # group of 3), d_ff 8192, vocab 200,064; nothing cut
    ("phi4-mini-3.8b", None, 4_450_618_368, 8_901_636_096),
    # kimi-k2-1t-a32b at full width cut to 2 of its 61 layers: its dense
    # first layer (d_ff 16,384) and one MoE layer (384 experts of 2,048,
    # top 8, 1 shared), d 7168, 64/8 heads of 128 (a group of 8), vocab
    # 163,840.  The MoE layer alone holds 16.9e9 weights (33.9 GB); 61
    # layers (~2 TB) cannot fit 80 GB, so depth is cut, never width
    ("kimi-k2-1t-a32b", 2, 19_923_635_200, 39_852_847_104),
)


def serve_published(torch, np, arch, layers=None, want=None,
                    tag="serve-config"):
    """One published configuration (``layers`` of it kept, every width as
    published; bf16, random weights from seed 0) through GenerateService on
    decode_path "auto" (K10) for workload (a) with its checks and timings,
    then the bf16 teacher-forced kernel-vs-gather logits check at
    BF16_LOGIT_RTOL with its planted fault (a MoE model: MOE_BF16_LOGIT_RTOL
    on every step, BF16_LOGIT_RTOL on the steps where no token's experts
    differ between the paths), and for a MoE model a profiler
    window of steady ticks (the expert products' share); ``want`` is the
    (weights, bytes) the draw must give.  The model is freed before it
    returns."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par, n_bytes = tree_numel(params), tree_bytes(params)
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moe = (f", {cfg.first_dense_layers} dense + "
           f"{cfg.n_layers - cfg.first_dense_layers} MoE of "
           f"{cfg.n_experts} experts of {cfg.moe_d_ff} (top "
           f"{cfg.experts_per_tok}, {cfg.n_shared_experts} shared)"
           if cfg.n_experts else "")
    log(f"[{tag}] {arch} ({cfg.n_layers} layers{moe}, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype}): {n_par:,} weights "
        f"({n_bytes / 1e9:.2f} GB) drawn on the card in {init_s:.2f} s "
        f"(seed 0), peak {init_peak:.2f} GiB while drawing")
    if want is not None and (n_par, n_bytes) != want:
        fail(f"{arch}: drew {n_par} weights in {n_bytes} bytes, wanted "
             f"{want}")
    name, slots, plen, new = SERVE_WORKLOADS[0]
    work = serve_workload(np, cfg.vocab, slots, plen, new)
    run = run_service(torch, np, params, cfg, work, slots, plen, new, "auto")
    ticks = check_served(np, cfg, name, run, work, "kernel")
    out = {"layers": cfg.n_layers, "weights": n_par, "bytes": n_bytes,
           "init_s": init_s, "init_peak_gib": init_peak,
           name: serve_timings(np, name, run),
           "launches": run["launches"]["paged_gqa"], "ticks": ticks}
    log(f"[{tag}] ({name}) {arch}: {slots} slots, prompt {plen}, up to {new} "
        f"new tokens, {len(work)} requests: every request done with its "
        f"budget, pool empty, path kernel, degrade level 0, retries 0, "
        f"launches {run['launches']} (paged_gqa = {cfg.n_layers} layers x "
        f"{ticks} ticks), no plain version")
    del run
    out["bf16_logit_rel"] = (
        teacher_forced(torch, np, params, cfg, MOE_BF16_LOGIT_RTOL,
                       clean_limit=BF16_LOGIT_RTOL) if cfg.n_experts
        else teacher_forced(torch, np, params, cfg, BF16_LOGIT_RTOL))
    if cfg.n_experts:
        out["profile"] = profile_ticks(torch, np, params, cfg)
    del params
    free_card(torch)
    return out


def phase_serve_starcoder2(torch, np):
    """starcoder2-7b as published (bf16, 32 layers) through
    ``serve_published`` (K10 at H/Hkv 9)."""
    return serve_published(torch, np, ARCH_SC2, tag="serve-sc2")


def phase_serve_configs(torch, np):
    """Phase 36: the configurations that had never run on the card
    (CONFIG_SERVES) each through ``serve_published``."""
    return {arch: serve_published(torch, np, arch, layers, (n, nbytes))
            for arch, layers, n, nbytes in CONFIG_SERVES}


def phase_k10_timing(torch, np, errs, serve, card):
    """K10 per launch at workload (b)'s shape in the middle of its decode
    (8 slots at position 288, 37 of 40 pages walked, bf16), over 28
    distinct layer pools as one decode tick has them, beside its bound,
    its plain version and the library yardstick; at workload (a)'s; and at
    (b)'s with starcoder2-7b's heads (36 / 4) and the three layouts of
    phase 36's models (K10_LAYOUTS)."""
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.kernels.paged_attention import ref
    import torch.nn.functional as F
    L, hd, ps = 28, 128, SERVE_PAGE
    rng = np.random.default_rng(13)
    rows_out = {}
    for name, bs, pos_v, max_pages, h, hkv in (
            ("b", 8, 288, 40, 16, 8), ("a", 4, 20, 5, 16, 8),
            ("starcoder2", 8, 288, 40, 36, 4)) + tuple(
                (name, 8, 288, 40, h, hkv)
                for name, (h, hkv) in K10_LAYOUTS.items()):
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
            "decode_ticks": serve["ticks"],
            **{f"{key}_{name}": rows_out[name][k]
               for name in K10_LAYOUTS
               for key, k in (("ms", "ms"), ("plain_ms", "pms"),
                              ("bound_ms", "bms"), ("library_ms", "lms"))},
            **{f"shape_{name}": f"bs 8, pos 288 (37 pages), H {h}, Hkv "
                                f"{hkv}, hd 128, ps 8, bf16"
               for name, (h, hkv) in K10_LAYOUTS.items()}}


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
# MoE kernel vs gather logits over the teacher-forced bf16 steps, every
# step's ‖Δ‖/‖logits‖, as for qwen3.  A step where the two paths' rounding
# swaps one of a token's top 8 experts on a near tie spikes alone: the steps
# are printed one by one to tell that from a fault.  deepseek-v3-671b (5
# layers): on an H100 the largest step is 4.43e-2 (median 2.51e-2; the
# inputs are seeded, so the steps repeat run to run) and the planted fault
# (the walk one page short) 9.97e-2 at its least step; the limit sits
# between them.  kimi-k2-1t-a32b (2 layers, 384 experts): its steps read
# either 1.02e-2-1.06e-2 or 2.67e-2-3.86e-2 (above the dense
# BF16_LOGIT_RTOL), the planted fault 1.18e-1 at its least; so a MoE model
# is held to this limit on every step and to BF16_LOGIT_RTOL on the steps
# where every token routes alike on both paths.
MOE_BF16_LOGIT_RTOL = 6.5e-2




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
        MOE_BF16_LOGIT_RTOL,
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


# ---------------------------------------------------------------------------
# slice 6: the training stack (launch.train -> run_training ->
# make_train_step -> loss_fn -> torch.autograd.grad -> clip -> adamw_update)
# ---------------------------------------------------------------------------

ARCH_TRAIN = "qwen3-1.7b"   # as published: bf16, 28 layers, d 2048, 16/8
#                             heads of 128, d_ff 6144, vocab 151936
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 100, 128, 8   # launch/train.py's
#                             sequence and global batch; 100 steps (200
#                             until the hybrid, enc-dec and VLM phases came:
#                             within the warmup the first 100 are the same
#                             steps, the loss fell 0.34 by step 200)
LONG_STEPS, LONG_SEQ, LONG_BATCH = 8, 4096, 1       # attn_chunk 2048 < 4096:
#                             sdpa_chunked in the forward, the recompute and
#                             the backward; 8 steps (20 until the examples
#                             and the three configurations came; the step
#                             time is the median of the last 6)
CONTROL_STEPS = 20          # the same first steps at lr 0
LOSS_WINDOW = 10            # the first and the last 10 losses' means
LOSS_MARGIN = 0.1           # nats the last window's mean must fall below the
#                             first's; the lr-0 control (batch-to-batch noise
#                             only) must not
TIMED_STEPS = 8             # steps timed part by part (CUDA events) after the
#                             200, on the same state
DRILL_LAYERS, DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 2, 20, 10, 12  # the
#                             kill-and-resume drill: full width cut to 2
#                             layers (a 28-layer checkpoint is ~24 GB a
#                             save); a checkpoint every 10 steps (5 until
#                             the examples and the three configurations
#                             came: 3 saves of 7.2 GB, not 5)
TRAIN_TOL = dict(atol=2e-5, rtol=1e-4)   # fp32 step, card vs CPU: the
#                             reference's kernel-test tolerance
GRAD_REL_TOL = 1e-5         # fp32 step, card vs CPU: each gradient leaf's
#                             ‖Δg‖_F / ‖g‖_F (two float32 summation orders);
#                             the same step under TF32 must exceed it
TRAIN_DIR = ROOT / "build" / "train"   # workdirs (git-ignored), deleted after


def train_cfg(torch, **over):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH_TRAIN), **over)


def on_card(torch, tree, what):
    from repro_torch.optim.tree import leaves
    off = [t.device for t in leaves(tree) if t.device.type != "cuda"]
    if off:
        fail(f"{what}: {len(off)} leaves off the card ({off[0]})")


def no_kernel_ran(what):
    """Training reaches no kernel of the port (the reference's loss attends
    through the plain sdpa_chunked / sdpa_full)."""
    launched = {k: v for m in kernel_modules() for k, v in m.LAUNCHES.items()
                if v}
    if launched or plain_calls():
        fail(f"{what}: kernels {launched} or plain versions {plain_calls()} "
             f"ran on the training path")


def traced_run(torch, np, cfg, name, steps, **kw):
    """run_training on the card with the tracer on and every count at 0:
    (params, opt_state, losses, per-step host seconds, wall s, peak GiB)."""
    import shutil
    from repro_torch import obs
    from repro_torch.trainer.loop import run_training
    workdir = TRAIN_DIR / name
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    tracer = obs.enable()
    t0 = time.perf_counter()
    try:
        params, opt, hist = run_training(
            cfg, str(workdir), steps, optimizer="adamw", ckpt_every=0,
            log_every=50, log_fn=lambda s: log(f"[train {name}] {s}"),
            device="cuda", **kw)
    finally:
        obs.disable()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shutil.rmtree(workdir, ignore_errors=True)
    no_kernel_ran(f"train {name}")
    spans = [s for s in tracer.spans if s.name == "train.step"]
    losses = [l for _, l in hist]
    if [s for s, _ in hist] != list(range(steps)) or len(spans) != steps:
        fail(f"train {name}: {len(hist)} steps, {len(spans)} spans")
    if not all(np.isfinite(losses)):
        fail(f"train {name}: non-finite loss {losses}")
    on_card(torch, (params, opt), f"train {name}")
    return dict(params=params, opt=opt, losses=losses,
                step_s=[s.t1 - s.t0 for s in spans], wall=wall,
                peak=torch.cuda.max_memory_allocated() / 2 ** 30)


def loss_drop(np, losses):
    return float(np.mean(losses[:LOSS_WINDOW]) - np.mean(losses[-LOSS_WINDOW:]))


def timed_steps(torch, np, cfg, params, opt, seq, batch, start):
    """TIMED_STEPS more steps on the same state, each split by CUDA events
    into loss+gradients, clip and optimizer update: medians in ms."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.trainer import loop, steps
    step, _ = steps.make_train_step(cfg, optimizer="adamw",
                                    total_steps=TRAIN_STEPS)
    data = SyntheticTokens(cfg.vocab, seq, batch, seed=0)
    parts = {"grads": [], "clip": [], "update": [], "step": []}
    with loop.deterministic(torch.device("cuda")):
        for i in range(TIMED_STEPS):
            b = {"tokens": torch.from_numpy(
                data.batch_at(start + i)["tokens"]).cuda()}
            on_card(torch, b, "timed batch")
            ev = {"start": torch.cuda.Event(enable_timing=True)}
            ev["start"].record()

            def mark(name):
                ev[name] = torch.cuda.Event(enable_timing=True)
                ev[name].record()

            params, opt, metrics = step(params, opt, b, mark=mark)
            torch.cuda.synchronize()
            prev = "start"
            for name in ("grads", "clip", "update"):
                parts[name].append(ev[prev].elapsed_time(ev[name]))
                prev = name
            parts["step"].append(ev["start"].elapsed_time(ev["update"]))
    return {k: statistics.median(v) for k, v in parts.items()}


GEMM_SYMBOLS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")   # cuBLAS's
#                             matrix-product kernels as the profiler names them


def profile_train(torch, np, cfg, params, opt, start, n_steps=2):
    """Device busy share of steady (128, 8) steps: ``n_steps`` train steps
    under torch.profiler (CPU and CUDA activities), kernel time by name
    from key_averages(), the matrix products' share of it, kernels a step;
    the share is the kernels' summed device time over the window's wall
    time, which the profiler itself lengthens (a lower bound).  Returns
    None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticTokens
    from repro_torch.trainer import loop, steps
    step, _ = steps.make_train_step(cfg, optimizer="adamw",
                                    total_steps=TRAIN_STEPS)
    data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{"tokens": torch.from_numpy(
        data.batch_at(start + i)["tokens"]).cuda()} for i in range(n_steps)]
    with loop.deterministic(torch.device("cuda")):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                params, opt, _ = step(params, opt, b)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels, count = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total
            count += e.count
    busy = sum(kernels.values())
    if busy <= 0:
        log("[train-profile] the profiler reported no device time: device "
            "busy share not measured")
        return None
    gemm = sum(v for k, v in kernels.items()
               if any(g in k.lower() for g in GEMM_SYMBOLS))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out = {"steps": n_steps, "wall_ms_per_step": wall_us / n_steps / 1e3,
           "device_ms_per_step": busy / n_steps / 1e3,
           "busy_share": busy / wall_us,
           "kernels_per_step": count / n_steps,
           "gemm_ms_per_step": gemm / n_steps / 1e3,
           "gemm_share": gemm / busy,
           "top": [[k[:96], v / n_steps / 1e3] for k, v in top]}
    log(f"[train-profile] {cfg.name} (128, 8), {n_steps} steps under "
        f"torch.profiler: {out['wall_ms_per_step']:.1f} ms a step on the "
        f"host clock, kernels {out['device_ms_per_step']:.1f} ms a step "
        f"(busy share {out['busy_share']:.3f}), "
        f"{out['kernels_per_step']:.0f} kernels a step, matrix products "
        f"{out['gemm_ms_per_step']:.1f} ms (share {out['gemm_share']:.3f}); "
        f"top kernels (ms a step): "
        + ", ".join(f"{k[:56]} {v:.2f}" for k, v in out["top"]))
    return out


def attention_ms(torch, seq):
    """One layer's causal attention at (1, seq, 16, 128) bf16 through the
    path's sdpa_chunked: forward, and forward + backward (CUDA events,
    mean of 5)."""
    from repro_torch.models import layers
    cfg = train_cfg(torch)
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(1, seq, cfg.n_heads, cfg.hd, generator=g,
                           device="cuda").bfloat16().requires_grad_(True)
               for _ in range(3))

    def fwd():
        with torch.no_grad():
            layers.sdpa_chunked(q, k, v, cfg.attn_chunk)

    def fwd_bwd():
        o = layers.sdpa_chunked(q, k, v, cfg.attn_chunk)
        torch.autograd.grad(o.float().sum(), (q, k, v))

    return events_ms(torch, fwd, 5), events_ms(torch, fwd_bwd, 5)


def phase_train(torch, np, card):
    """qwen3-1.7b as published, trained on the card through run_training:
    TRAIN_STEPS steps at (128, 8), the lr-0 control, LONG_STEPS at (4096,
    1)."""
    from repro_torch.models import layers
    free_card(torch)
    cfg = train_cfg(torch)
    n_weights = cfg.param_count()
    run = traced_run(torch, np, cfg, "main", TRAIN_STEPS, seq_len=TRAIN_SEQ,
                     global_batch=TRAIN_BATCH)
    drop = loss_drop(np, run["losses"])
    split = timed_steps(torch, np, cfg, run["params"], run["opt"],
                        TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS)
    prof = profile_train(torch, np, cfg, run["params"], run["opt"],
                         TRAIN_STEPS + TIMED_STEPS)
    moments = tree_numel(run["opt"].inner)
    del run["params"], run["opt"]
    free_card(torch)
    ctrl = traced_run(torch, np, cfg, "control", CONTROL_STEPS,
                      seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, lr=0.0)
    del ctrl["params"], ctrl["opt"]
    free_card(torch)
    ctrl_drop = loss_drop(np, ctrl["losses"])
    if ctrl["losses"][0] != run["losses"][0]:
        fail(f"train: the lr-0 control's first loss {ctrl['losses'][0]} is "
             f"not the run's {run['losses'][0]} (same weights, same batch)")
    log(f"[train] {ARCH_TRAIN} ({n_weights:,} weights, bf16, {moments:,} "
        f"float32 moments): loss {run['losses'][0]:.4f} -> "
        f"{run['losses'][-1]:.4f}; mean of the first {LOSS_WINDOW} minus the "
        f"last {LOSS_WINDOW}: {drop:.4f} (margin {LOSS_MARGIN}); lr-0 "
        f"control {ctrl_drop:.4f}")
    if not drop >= LOSS_MARGIN:
        fail(f"train: the loss fell {drop:.4f}, under the margin "
             f"{LOSS_MARGIN}")
    if not ctrl_drop < LOSS_MARGIN:
        fail(f"train: the lr-0 control fell {ctrl_drop:.4f}, past the margin "
             f"{LOSS_MARGIN}: the margin does not tell learning from noise")

    calls = {"sdpa_chunked": 0, "sdpa_full": 0}
    real = {k: getattr(layers, k) for k in calls}

    def counted(name):
        def f(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return f

    for k in calls:
        setattr(layers, k, counted(k))
    try:
        long = traced_run(torch, np, cfg, "long", LONG_STEPS,
                          seq_len=LONG_SEQ, global_batch=LONG_BATCH)
    finally:
        for k, f in real.items():
            setattr(layers, k, f)
    del long["params"], long["opt"]
    free_card(torch)
    want = {"sdpa_chunked": 2 * cfg.n_layers * LONG_STEPS, "sdpa_full": 0}
    if calls != want:
        fail(f"train (4096, 1): attention calls {calls}, wanted {want} (the "
             f"forward and the recompute of each layer through sdpa_chunked)")
    attn_fwd, attn_fwd_bwd = attention_ms(torch, LONG_SEQ)

    steady = statistics.median(run["step_s"][LOSS_WINDOW:]) * 1e3
    long_steady = statistics.median(long["step_s"][2:]) * 1e3
    attn_step = cfg.n_layers * (attn_fwd + attn_fwd_bwd)
    out = {
        "arch": ARCH_TRAIN, "weights": n_weights, "moments": moments,
        "steps": TRAIN_STEPS, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
        "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
        "loss_drop": drop, "loss_margin": LOSS_MARGIN,
        "control_drop": ctrl_drop, "wall_s": run["wall"],
        "step_ms_host_median": steady,
        "step_ms_events": split["step"], "grads_ms": split["grads"],
        "clip_ms": split["clip"], "update_ms": split["update"],
        "tokens_per_s": TRAIN_SEQ * TRAIN_BATCH / (split["step"] / 1e3),
        "peak_gib": run["peak"], "profile": prof,
        "long": {"steps": LONG_STEPS, "seq": LONG_SEQ, "batch": LONG_BATCH,
                 "loss_first": long["losses"][0],
                 "loss_last": long["losses"][-1], "wall_s": long["wall"],
                 "step_ms_host_median": long_steady,
                 "tokens_per_s": LONG_SEQ * LONG_BATCH / (long_steady / 1e3),
                 "peak_gib": long["peak"], "attn_calls": calls,
                 "attn_fwd_ms_layer": attn_fwd,
                 "attn_fwd_bwd_ms_layer": attn_fwd_bwd,
                 "attn_ms_step": attn_step,
                 "attn_share": attn_step / long_steady},
    }
    log(f"[train] {card}: (128, 8) step {split['step']:.2f} ms (CUDA events, "
        f"median of {TIMED_STEPS}; host span median {steady:.2f} ms): "
        f"loss+grads {split['grads']:.2f}, clip {split['clip']:.2f}, update "
        f"{split['update']:.2f}; {out['tokens_per_s']:.1f} tok/s; peak "
        f"{run['peak']:.2f} GiB; {TRAIN_STEPS} steps in {run['wall']:.1f} s")
    log(f"[train] {card}: (4096, 1) step {long_steady:.2f} ms (host span "
        f"median), {out['long']['tokens_per_s']:.1f} tok/s, peak "
        f"{long['peak']:.2f} GiB; sdpa_chunked a layer {attn_fwd:.3f} ms "
        f"forward, {attn_fwd_bwd:.3f} forward+backward: ~{attn_step:.1f} ms "
        f"a step ({out['long']['attn_share']:.2f} of it); loss "
        f"{long['losses'][0]:.4f} -> {long['losses'][-1]:.4f}")
    return out


def phase_drill(torch, np, card):
    """Kill-and-resume at full width, 2 layers: an uninterrupted run (no
    checkpoints: they change no arithmetic) and a run that checkpoints
    every 5 steps, is killed at step 12 and resumes from its step-10
    checkpoint agree bit for bit (losses, parameters, moments); its
    checkpoints' save and restore times from the loop's spans."""
    import shutil
    from repro_torch import obs
    from repro_torch.optim.tree import leaves
    from repro_torch.trainer.loop import InjectedFailure, run_training
    free_card(torch)
    cfg = train_cfg(torch, n_layers=DRILL_LAYERS)
    common = dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                  optimizer="adamw", log_every=100,
                  log_fn=lambda s: log(f"[drill] {s}"), device="cuda")
    dirs = {k: TRAIN_DIR / f"drill_{k}" for k in ("a", "b")}   # a stays
    #                                       empty (no checkpoints)
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    reset_all_counts()
    t0 = time.perf_counter()
    pa, oa, hist_a = run_training(cfg, str(dirs["a"]), DRILL_STEPS,
                                  ckpt_every=0, **common)
    t_a = time.perf_counter() - t0
    tracer = obs.enable()
    t0 = time.perf_counter()
    try:
        try:
            run_training(cfg, str(dirs["b"]), DRILL_STEPS,
                         ckpt_every=DRILL_EVERY, fail_at_step=DRILL_FAIL,
                         **common)
            fail("drill: the injected failure did not happen")
        except InjectedFailure:
            pass
        pb, ob, hist_b = run_training(cfg, str(dirs["b"]), DRILL_STEPS,
                                      ckpt_every=DRILL_EVERY, **common)
    finally:
        obs.disable()
    t_b = time.perf_counter() - t0
    torch.cuda.synchronize()
    shutil.rmtree(dirs["b"])
    no_kernel_ran("drill")
    on_card(torch, (pa, oa, pb, ob), "drill")
    resumed = DRILL_FAIL // DRILL_EVERY * DRILL_EVERY
    if [s for s, _ in hist_b] != list(range(resumed, DRILL_STEPS)):
        fail(f"drill: resumed steps {[s for s, _ in hist_b]}")
    tail_a = dict(hist_a)
    diverged = [s for s, l in hist_b if tail_a[s] != l]
    unequal = sum(not torch.equal(x, y)
                  for x, y in zip(leaves((pa, oa)), leaves((pb, ob))))
    if diverged or unequal:
        fail(f"drill: losses differ at steps {diverged}, {unequal} leaves "
             f"differ after the resume")
    spans = lambda n: [s.t1 - s.t0 for s in tracer.spans if s.name == n]
    saves, restores = spans("train.ckpt_save"), spans("train.ckpt_restore")
    n_saves = (DRILL_FAIL // DRILL_EVERY              # before the kill, the
               + (DRILL_STEPS - resumed) // DRILL_EVERY + 1)   # run's end
    if len(saves) != n_saves or len(restores) != 1:
        fail(f"drill: {len(saves)} saves and {len(restores)} restores, "
             f"wanted {n_saves} and 1")
    n_bytes = sum(t.numel() * t.element_size() for t in leaves((pa, oa)))
    del pa, oa, pb, ob
    free_card(torch)
    out = {"layers": DRILL_LAYERS, "steps": DRILL_STEPS,
           "ckpt_every": DRILL_EVERY, "fail_at": DRILL_FAIL,
           "resumed_from": resumed, "ckpt_gb": n_bytes / 1e9,
           "save_s_median": statistics.median(saves),
           "restore_s": restores[0], "uninterrupted_s": t_a,
           "killed_and_resumed_s": t_b}
    log(f"[drill] {card}: {ARCH_TRAIN} at full width, {DRILL_LAYERS} layers: "
        f"killed at step {DRILL_FAIL}, resumed from {resumed}: losses, "
        f"parameters and moments bit for bit equal to the uninterrupted "
        f"run; a checkpoint {n_bytes / 1e9:.2f} GB, save "
        f"{out['save_s_median']:.2f} s (median of {n_saves}), restore "
        f"{restores[0]:.2f} s (host clock); runs {t_a:.1f} s and "
        f"{t_b:.1f} s")
    return out


def step_gaps(torch, np, got, want):
    """Failures of one fp32 step (card) against the same step (CPU): loss
    and grad_norm within TRAIN_TOL; every gradient leaf within TRAIN_TOL and
    GRAD_REL_TOL (Frobenius); the moments everywhere and the parameters
    where the clipped |g| exceeds TRAIN_TOL's atol within TRAIN_TOL.  The
    CPU's leaves are compared on the card.  Returns (failures, worst
    relative gradient gap)."""
    bad, worst = [], 0.0
    for k in ("loss", "grad_norm"):
        g, w = got[k], want[k]
        if not abs(g - w) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(w):
            bad.append(f"{k} {g} vs {w}")
    scale = min(1.0, 1.0 / max(want["grad_norm"], 1e-9))
    for name in want["grads"]:
        g, w = got["grads"][name], want["grads"][name].to(got["grads"][name].device)
        rel = float((g - w).norm() / w.norm().clamp(min=1e-30))
        worst = max(worst, rel)
        if rel > GRAD_REL_TOL or not torch.allclose(g, w, **TRAIN_TOL):
            bad.append(f"grad {name}: {rel:.3e} relative")
        big = (w * scale).abs() > TRAIN_TOL["atol"]
        p, pw = got["params"][name], want["params"][name].to(g.device)
        if not torch.allclose(p[big], pw[big], **TRAIN_TOL):
            bad.append(f"param {name}")
        for m in ("m", "v"):
            if not torch.allclose(got[m][name], want[m][name].to(g.device),
                                  **TRAIN_TOL):
                bad.append(f"{m} {name}")
    return bad, worst


def one_fp32_step(torch, cfg, params0, batch, dev):
    """One train step from a copy of ``params0`` on ``dev``: loss, grad
    norm, the gradients as loss_and_grads hands them to the step (copied
    before the clip scales them in place) and the updated parameters and
    moments, each a copy on ``dev``."""
    from repro_torch.optim import global_norm
    from repro_torch.optim.tree import flatten_with_path, tree_map
    from repro_torch.trainer import steps
    named = lambda tree: {"/".join(map(str, p)): t.detach().clone()
                          for p, t in flatten_with_path(tree)}
    grads, real = {}, steps.loss_and_grads

    def keep(*a, **k):
        out = real(*a, **k)
        grads.update(named(out[2]))
        return out

    params = tree_map(lambda t: t.to(dev, copy=True), params0)
    step, init = steps.make_train_step(cfg, optimizer="adamw")
    steps.loss_and_grads = keep
    try:
        params, opt, metrics = step(params, init(params), {
            "tokens": torch.from_numpy(batch).to(dev)})
    finally:
        steps.loss_and_grads = real
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]), "grads": grads,
           "params": named(params), "m": named(opt.inner["m"]),
           "v": named(opt.inner["v"])}
    norm = float(global_norm(list(grads.values())))
    if abs(norm - out["grad_norm"]) > 1e-5 * out["grad_norm"]:
        fail(f"fp32 step on {dev}: the kept gradients' norm {norm} is not "
             f"the step's {out['grad_norm']} (not the unclipped gradients)")
    return out


def phase_train_fp32(torch, np, card):
    """One fp32 train step of qwen3-1.7b at full width, 1 layer, (128, 1),
    on the card against the same step on the CPU; the same step under TF32
    must fail the check."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import lm
    free_card(torch)
    cfg = train_cfg(torch, n_layers=1, dtype="float32")
    params0 = lm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = SyntheticTokens(cfg.vocab, TRAIN_SEQ, 1, seed=0).batch_at(0)[
        "tokens"]
    t0 = time.perf_counter()
    want = one_fp32_step(torch, cfg, params0, batch, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    reset_all_counts()
    got = one_fp32_step(torch, cfg, params0, batch, torch.device("cuda"))
    no_kernel_ran("fp32 step")
    bad, worst = step_gaps(torch, np, got, want)
    out = {"loss_card": got["loss"], "loss_cpu": want["loss"],
           "grad_norm_card": got["grad_norm"],
           "grad_norm_cpu": want["grad_norm"], "worst_grad_rel": worst,
           "cpu_step_s": cpu_s}
    del got                                      # ~11 GB on the card
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = one_fp32_step(torch, cfg, params0, batch, torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    bad_tf32, worst_tf32 = step_gaps(torch, np, tf32, want)
    out.update(tf32_loss=tf32["loss"], tf32_grad_norm=tf32["grad_norm"],
               tf32_worst_grad_rel=worst_tf32, tf32_failures=len(bad_tf32))
    del params0, want, tf32
    free_card(torch)
    log(f"[train-fp32] {card}: 1 layer at full width, (128, 1): loss "
        f"{out['loss_card']!r} (CPU {out['loss_cpu']!r}), grad norm "
        f"{out['grad_norm_card']!r} (CPU {out['grad_norm_cpu']!r}), worst "
        f"gradient leaf {worst:.3e} relative (limit {GRAD_REL_TOL}); TF32 "
        f"control: worst {worst_tf32:.3e}, {len(bad_tf32)} failures")
    if bad:
        fail(f"fp32 step, card vs CPU: {bad[:8]}")
    if not bad_tf32:
        fail("fp32 step: the TF32 control passed the check, which therefore "
             "cannot tell a float32 step from a TF32 one")
    return out


# ---------------------------------------------------------------------------
# slice 7: measured round times (engine.measure_round_times, replayed
# through the simulator) and the SSM family: falcon-mamba-7b served as
# published and trained at full width
# ---------------------------------------------------------------------------

REPLAY_RATIO = (0.2, 5.0)   # Σ round_s over one fused execute_plan: the
#                             reference's bound (tests/test_backends.py)
N_ITEMS, B_ITEMS = 512, 64  # the per-item pass: 204 single-row launches
#                             (the 2048² plan's 11,440 would be as many)
ARCH_SSM = "falcon-mamba-7b"   # as published: 64 layers, d 4096, d_inner
#                             8192, N 16, vocab 65,024, 7.27e9 weights
SSM_SLOTS, SSM_REQUESTS = 8, 24
SSM_LONG, SSM_LONG_NEW = 4096, 32   # the long request: a constant state
SSM_FP32_LAYERS = 8          # check (ii): fp32 at full width, 8 layers
#                             (5.5 GB), 6 requests through 3 slots
SSM_LOGIT_RTOL = 5e-2        # check (i), bf16, set before the first run:
#                             forward(257) takes the stepwise scan and
#                             prefill(256) + decode the chunked scan and
#                             conv1d_step; their float32 sums differ by a few
#                             ulp, which round differently into the bf16
#                             activations of each of 64 layers (2^-9 a
#                             rounding, ~sqrt(64) layers of it ≈ 3e-2 at
#                             worst); the decode without its carried state
#                             loses the whole prompt and must fail it
SSM_LOGIT_RTOL_FP32 = 1e-3   # check (i) again in fp32 at full depth (29
#                             GB): the two scans differ by ~2e-7 a layer
#                             (check iii), which 64 layers of random
#                             weights amplify as they amplify bf16's 2^-9
#                             roundings to ~4e-2, so ~1e-5–1e-4; x10 margin.
#                             The decode without its state (~3e-2 in bf16)
#                             must fail it by far
SCAN_RTOL = 1e-5             # check (iii), fp32: the doubling scan and the
#                             stepwise one are two float32 orders of one
#                             contracting recurrence (|a| < 1): a few ulp of
#                             u = 6e-8 over log2(128) + 2 levels, ×10 margin;
#                             the scan without its carry across chunks
#                             must fail it
SSM_TRAIN_LAYERS = 8         # AdamW at 64 layers needs ~7.27e9 x 12 B = 87
#                             GB (bf16 weights, float32 m and v); Adafactor's
#                             float32 temporaries of the 4.3e9-element
#                             in_proj stack (17 GB each,
#                             optim/optimizers.py) overflow 80 GB too: full
#                             width, depth cut to 8 layers (1.37e9 weights)
SSM_TRAIN_STEPS, SSM_TRAIN_LR = 20, 3e-3   # 20 steps at launch/train.py's
#                             (128, 8); the schedule's 100-step warmup keeps
#                             20 steps under 0.2 of the base lr, so the base
#                             is 10x the launcher's 3e-4
SSM_LOSS_WINDOW, SSM_LOSS_MARGIN = 5, 0.05   # nats the last 5 losses' mean
#                             must fall below the first 5's; the lr-0
#                             control must not


def qr_tables(torch, np, n, b):
    """A seeded n² matrix's QR plan (b² tiles, LANES lanes) lowered to its
    task table, and the tile stack on the card."""
    from repro_torch import core, engine
    from repro_torch.apps import qr
    a = torch.tensor(np.random.default_rng(n).standard_normal((n, n)).astype(
        np.float32), device="cuda")
    tiles, mt, nt = qr._split_tiles(a, b)
    sched, _ = qr.make_qr_graph(mt, nt, nr_queues=LANES)
    plan = core.lower(sched, LANES)
    tables = engine.lower_tables(
        plan, sched, qr._TileState(dict(tiles)).batch_registry(),
        arg_width=engine.QR_ARG_WIDTH, row_access=engine.qr_row_access)
    stack = torch.stack([tiles[i, j] for j in range(nt) for i in range(mt)])
    return sched, plan, tables, stack


def fused_s(torch, engine, tables, stack):
    """One fused execute_plan from a copy of ``stack``: (wall s blocked on
    completion, its buffers)."""
    bufs = (stack.clone(), torch.zeros_like(stack))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.execute_plan(tables, engine.qr_round_fn, (), bufs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_rounds(torch, np, card):
    """engine.measure_round_times on the 2048² / 64² QR plan on the card,
    its replay through the simulator held to the reference's identities,
    and the per-item pass on the 512² / 64² plan."""
    from repro_torch import core, engine
    from repro_torch.kernels.qr_tile import kernel
    sched, plan, tables, stack = qr_tables(torch, np, N_MAIN, B_MAIN)
    fn = engine.qr_round_fn
    tmat = torch.zeros_like(stack)
    before = (stack.clone(), tmat.clone())
    rounds = None
    for _ in range(3):                 # elementwise best of 3
        kernel.reset_counts()
        t = engine.measure_round_times(tables, fn, (), (stack, tmat))
        rounds = (t.round_s if rounds is None
                  else [min(x, y) for x, y in zip(rounds, t.round_s)])
    busy = int((np.diff(tables.round_offsets) > 0).sum())
    if kernel.LAUNCHES["qr_walk"] != 2 * busy or any(
            kernel.PLAIN_CALLS.values()):
        fail(f"rounds: {kernel.LAUNCHES['qr_walk']} walk launches for "
             f"{busy} non-empty rounds (wanted warm-up + timed = "
             f"{2 * busy}), plain calls {dict(kernel.PLAIN_CALLS)}")
    if not (torch.equal(stack, before[0]) and torch.equal(tmat, before[1])):
        fail("rounds: measure_round_times changed the caller's buffers")
    if len(rounds) != plan.nr_rounds:
        fail(f"rounds: {len(rounds)} round times for {plan.nr_rounds} rounds")
    fused_s(torch, engine, tables, stack)          # warm-up
    runs = [fused_s(torch, engine, tables, stack) for _ in range(3)]
    fused = min(r[0] for r in runs)
    for got, want in zip(t.buffers, runs[0][1]):
        if not torch.equal(got, want):
            fail("rounds: the round-by-round buffers differ from one fused "
                 "execute_plan's")
    res = core.replay_round_times(sched, plan, rounds, nr_workers=1)
    total = sum(rounds)
    if abs(res.makespan - total) > 1e-9 * total:
        fail(f"rounds: 1-worker replay {res.makespan} != Σ round_s {total}")
    ratio = total / fused
    log(f"[rounds] {N_MAIN}² / {B_MAIN}² plan, {plan.nr_rounds} rounds "
        f"({busy} non-empty), {tables.nr_items} items: Σ round_s "
        f"{total * 1e3:.3f} ms (best of 3 per round, one walk launch a "
        f"round) vs one fused execute_plan {fused * 1e3:.3f} ms (best of "
        f"3): ratio {ratio:.3f} (bounds {REPLAY_RATIO}); 1-worker replay = "
        f"Σ round_s; buffers bitwise the fused run's; {card}")
    if not REPLAY_RATIO[0] <= ratio <= REPLAY_RATIO[1]:
        fail(f"rounds: Σ round_s / fused = {ratio:.3f} outside "
             f"{REPLAY_RATIO}")
    sched, plan, tables, stack = qr_tables(torch, np, N_ITEMS, B_ITEMS)
    t = engine.measure_round_times(tables, fn, (),
                                   (stack, torch.zeros_like(stack)),
                                   per_item=True)
    item = t.item_s
    serial = core.replay_item_times(sched, tables.tids, item, nr_workers=1)
    par = core.replay_item_times(sched, tables.tids, item, nr_workers=4)
    per_task = np.zeros(sched.nr_tasks)
    np.add.at(per_task, np.asarray(tables.tids), item)
    cp = core.critical_path_length(
        sched.nr_tasks, [list(x.unlocks) for x in sched.tasks], per_task)
    log(f"[rounds] {N_ITEMS}² / {B_ITEMS}² plan, per item: {len(item)} "
        f"single-row launches, Σ item_s {item.sum() * 1e3:.3f} ms; replay "
        f"1 worker {serial.makespan * 1e3:.3f} ms, 4 workers "
        f"{par.makespan * 1e3:.3f} ms, critical path {cp * 1e3:.3f} ms")
    if not (len(item) == tables.nr_items and (item > 0).all()):
        fail("rounds: per-item times missing or not positive")
    if abs(serial.makespan - item.sum()) > 1e-9 * item.sum():
        fail("rounds: 1-worker item replay != Σ item_s")
    if not cp - 1e-12 <= par.makespan <= serial.makespan + 1e-12:
        fail(f"rounds: 4-worker replay {par.makespan} outside [critical "
             f"path {cp}, serial {serial.makespan}]")
    return {"rounds": plan.nr_rounds, "sum_round_ms": total * 1e3,
            "fused_ms": fused * 1e3, "ratio": ratio,
            "items": int(len(item)), "sum_item_ms": float(item.sum()) * 1e3,
            "replay4_ms": par.makespan * 1e3, "critical_path_ms": cp * 1e3}


def ssm_workload(np, vocab):
    """24 requests: prompts of 128 and 256 tokens (the chunked scan) and
    ragged 37-101 (the stepwise scan), budgets from {16, 64, 128}, seed 0."""
    rng = np.random.default_rng(0)
    work = []
    for i in range(SSM_REQUESTS):
        plen = (128, 256, int(rng.integers(37, 102)))[i % 3]
        work.append((rng.integers(0, vocab, plen, dtype=np.int32),
                     int(rng.choice([16, 64, 128]))))
    return work


def pool_bytes(svc):
    return sum(v.numel() * v.element_size() for v in svc.pool.leaves.values())


def ssm_service(torch, params, cfg, slots):
    from repro_torch.serve import GenerateService
    return GenerateService(params, cfg, max_batch=slots, max_seq=SERVE_PAGE,
                           page_size=SERVE_PAGE, decode_path="auto",
                           device="cuda")


def profile_ssm_ticks(torch, svc, n_ticks=8):
    """Device busy share of ``n_ticks`` steady decode ticks of a service
    whose slots are full: kernels a tick and their device time (the
    profiler lengthens the window, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            svc.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, count = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total
            count += e.count
    busy = sum(kernels.values())
    if busy <= 0:
        log("[ssm-profile] the profiler reported no device time: busy "
            "share not measured")
        return None
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    gemm = sum(v for k, v in kernels.items()
               if any(g in k.lower() for g in GEMM_SYMBOLS))
    out = {"ticks": n_ticks, "wall_ms_per_tick": wall_us / n_ticks / 1e3,
           "device_ms_per_tick": busy / n_ticks / 1e3,
           "busy_share": busy / wall_us, "kernels_per_tick": count / n_ticks,
           "gemm_share": gemm / busy,
           "top": [[k[:96], v / n_ticks / 1e3] for k, v in top]}
    log(f"[ssm-profile] {ARCH_SSM}, {svc.max_batch} full slots, {n_ticks} "
        f"ticks under torch.profiler: {out['wall_ms_per_tick']:.3f} ms a "
        f"tick on the host clock, kernels {out['device_ms_per_tick']:.3f} ms "
        f"a tick (busy share {out['busy_share']:.3f}), "
        f"{out['kernels_per_tick']:.0f} kernels a tick, matrix products' "
        f"share {out['gemm_share']:.3f}; top kernels (ms a tick): "
        + ", ".join(f"{k[:48]} {v:.3f}" for k, v in out["top"]))
    return out


def ssm_logits_check(torch, np, params, cfg, limit):
    """Check (i): prefill(S-1) then decode_step against forward at S, in
    ``cfg.dtype``, 2 x 257 tokens, the last token's logits within
    ``limit``; the control decodes with the carried state h zeroed."""
    from repro_torch.models import lm, serving
    tok = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 257)), device="cuda")
    with torch.no_grad():
        h, _ = lm.forward(params, cfg, tok)
        full = lm.logits_fn(params, cfg, h[:, -1]).float()
        del h
        _, cache, pos = serving.prefill(params, cfg, tok[:, :-1])
        zeroed = {k: v.clone() for k, v in cache.items()}
        zeroed["h"].zero_()
        dec, _ = serving.decode_step(params, cfg, cache, tok[:, -1:], pos)
        ctl, _ = serving.decode_step(params, cfg, zeroed, tok[:, -1:], pos)
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        fail("ssm (i): logits not finite")
    rel = float((dec.float() - full).norm() / full.norm())
    ctl_rel = float((ctl.float() - full).norm() / full.norm())
    log(f"[ssm] (i) {cfg.dtype}, {cfg.n_layers} layers, 2 x 257 tokens: "
        f"prefill(256) + decode_step vs forward(257), last-token logits "
        f"‖Δ‖/‖logits‖ {rel:.3e} (limit {limit}); with the carried h "
        f"zeroed {ctl_rel:.3e}")
    if not rel <= limit:
        fail(f"ssm (i) {cfg.dtype}: {rel:.3e} > {limit}")
    if not ctl_rel > limit:
        fail(f"ssm (i) {cfg.dtype}: the check cannot see a lost state "
             f"({ctl_rel:.3e})")
    return {"rel": rel, "control_rel": ctl_rel, "limit": limit}


def ssm_sequential(torch, params, cfg, prompt, n):
    """One request alone: prefill then decode_step, greedy."""
    from repro_torch.models import serving
    with torch.no_grad():
        logits, cache, pos = serving.prefill(
            params, cfg, torch.as_tensor(prompt, device="cuda")[None])
        toks = [int(torch.argmax(logits[0]))]
        for _ in range(n - 1):
            logits, cache = serving.decode_step(
                params, cfg, cache,
                torch.tensor([[toks[-1]]], device="cuda"), pos)
            toks.append(int(torch.argmax(logits[0])))
            pos = pos + 1
    return toks


def ssm_scan_check(torch, np, params, cfg):
    """Check (iii): one full-width layer's scan inputs at S 256, batch 2,
    fp32: the chunked scan against the stepwise one; the control drops the
    carry across chunks."""
    from repro_torch.models import layers, ssm
    lp = {k: v[0] for k, v in params["layers"]["mamba"].items()}
    norm = {"scale": params["layers"]["norm"]["scale"][0]}
    tok = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 256)), device="cuda")
    with torch.no_grad():
        x = layers.rmsnorm(norm, params["embed"]["tok"][tok], cfg.norm_eps)
        a, b, _, _, _ = ssm._mamba1_scan_inputs(lp, cfg, x)
        h0 = torch.zeros(a.shape[:1] + a.shape[2:], device="cuda")
        ref = ssm.linear_scan_ref(a, b, h0)
        got = ssm.linear_scan_chunked(a, b, h0)
        q = ssm.SSM_CHUNK
        lost = torch.cat([ssm.linear_scan_chunked(a[:, i:i + q],
                                                  b[:, i:i + q], h0)
                          for i in range(0, a.shape[1], q)], dim=1)
    rel = float((got - ref).norm() / ref.norm())
    ctl = float((lost - ref).norm() / ref.norm())
    log(f"[ssm] (iii) fp32, one full-width layer, (2, 256, {cfg.d_inner}, "
        f"{cfg.ssm_state}): chunked (doubling) vs stepwise scan ‖Δ‖/‖h‖ "
        f"{rel:.3e} (limit {SCAN_RTOL}); without the carry across chunks "
        f"{ctl:.3e}")
    if not rel <= SCAN_RTOL:
        fail(f"ssm (iii): {rel:.3e} > {SCAN_RTOL}")
    if not ctl > SCAN_RTOL:
        fail(f"ssm (iii): the check cannot see a dropped carry ({ctl:.3e})")
    return {"rel": rel, "control_rel": ctl, "limit": SCAN_RTOL}


def phase_serve_ssm(torch, np, card):
    """falcon-mamba-7b as published (bf16, 64 layers, weights from seed 0
    on the card) through GenerateService on decode_path "auto": the gather
    path, no paged kernel; the workload, the long request, checks (i)-(iii)
    and the timings."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.models import lm, serving
    free_card(torch)
    cfg = get_config(ARCH_SSM)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = tree_numel(params)
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[ssm] {ARCH_SSM} as published ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, N {cfg.ssm_state}, vocab "
        f"{cfg.vocab}, {cfg.dtype}): {n_par:,} weights drawn on the card in "
        f"{init_s:.2f} s (seed 0), peak {init_peak:.2f} GiB")
    work = ssm_workload(np, cfg.vocab)
    svc = ssm_service(torch, params, cfg, SSM_SLOTS)
    if svc.decode_path != "gather" or svc.paged:
        fail(f"ssm: decode path {svc.decode_path!r}, paged {svc.paged}")
    bytes0 = pool_bytes(svc)
    torch.cuda.synchronize()
    reset_all_counts()
    t0 = time.perf_counter()
    hs = [svc.submit(p, n) for p, n in work]
    svc.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v for m in kernel_modules() for k, v in m.LAUNCHES.items()
                if v}
    if launched or plain_calls():
        fail(f"ssm: kernels {launched} or plain versions {plain_calls()} ran "
             f"on the SSM serving path (K10/K11 must stay at 0)")
    for h, (_, n) in zip(hs, work):
        if (h.status != "done" or len(h.generated) != n
                or not all(0 <= t < cfg.vocab for t in h.generated)):
            fail(f"ssm: request {h.rid} {h.status} with {len(h.generated)} "
                 f"of {n} tokens")
    if (svc.pool.allocated or svc.stats["retries"]
            or svc.stats["preemptions"]):
        fail(f"ssm: pool {svc.pool.allocated}, stats {svc.stats}")
    toks = svc.stats["generated_tokens"]
    dev = svc.metrics.get("serve.decode_device_s").summary()
    host = svc.metrics.get("serve.decode_round_s").summary()
    ttft = np.array([h.ttft_s for h in hs]) * 1e3
    log(f"[ssm] {len(work)} requests through {SSM_SLOTS} slots (prompts 128,"
        f" 256 and ragged 37-101, budgets 16/64/128): {toks} tokens in "
        f"{wall:.2f} s = {toks / wall:.1f} tok/s; {dev['count']} decode "
        f"ticks, the round {dev['mean'] * 1e3:.3f} ms on the device and "
        f"{host['mean'] * 1e3:.3f} ms on the host (means); TTFT median "
        f"{float(np.median(ttft)):.1f} ms; path gather, no kernel launched, "
        f"pool empty; {card}")
    # the long request: the state's bytes do not grow with the prompt
    long = np.random.default_rng(5).integers(0, cfg.vocab, SSM_LONG,
                                             dtype=np.int32)
    h = svc.submit(long, SSM_LONG_NEW)
    svc.run_until_complete()
    bytes1 = pool_bytes(svc)
    log(f"[ssm] a {SSM_LONG}-token prompt with {SSM_LONG_NEW} new tokens: "
        f"{h.status}, {len(h.generated)} tokens; the pool's state "
        f"{bytes0:,} bytes before, {bytes1:,} after ({SSM_SLOTS} slots)")
    if h.status != "done" or len(h.generated) != SSM_LONG_NEW or (
            bytes1 != bytes0):
        fail("ssm: the long request was not served in the same state bytes")
    # a steady tick at 8 full slots under the profiler
    for p, _ in work[:SSM_SLOTS]:
        svc.submit(p, 12)
    svc.step()
    svc.step()
    prof = profile_ssm_ticks(torch, svc)
    svc.run_until_complete()
    del svc
    # prefill times at 256 and 4,096 tokens (batch 1, CUDA events)
    pf = {}
    for s in (256, SSM_LONG):
        tok = torch.as_tensor(np.random.default_rng(s).integers(
            0, cfg.vocab, (1, s)), device="cuda")
        with torch.no_grad():
            pf[s] = events_ms(torch, lambda: serving.prefill(params, cfg,
                                                             tok), 2)
    log(f"[ssm] prefill ms (batch 1, CUDA events, mean of 2): 256 tokens "
        f"{pf[256]:.2f}, {SSM_LONG} tokens {pf[SSM_LONG]:.2f}; {card}")
    check_i = ssm_logits_check(torch, np, params, cfg, SSM_LOGIT_RTOL)
    del params
    free_card(torch)
    # (i) again in fp32 at full depth: the bf16 reading's margin over its
    # control is thin (random weights' small dt make the state a few
    # percent of the last logits), fp32 separates them
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg32)
    check_i32 = ssm_logits_check(torch, np, params32, cfg32,
                                 SSM_LOGIT_RTOL_FP32)
    del params32
    free_card(torch)
    # (ii) and (iii): fp32 at full width, 8 layers
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=SSM_FP32_LAYERS)
    params32 = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg32)
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, cfg.vocab, pl, dtype=np.int32), n)
            for pl, n in ((37, 9), (128, 12), (50, 4), (256, 10), (64, 6),
                          (101, 8))]
    svc = ssm_service(torch, params32, cfg32, 3)
    hs = [svc.submit(p, n) for p, n in reqs]
    svc.run_until_complete()
    same = sum(h.generated == ssm_sequential(torch, params32, cfg32, p, n)
               for h, (p, n) in zip(hs, reqs))
    log(f"[ssm] (ii) fp32, full width, {SSM_FP32_LAYERS} layers: 6 requests "
        f"through 3 slots equal the sequential prefill + decode_step token "
        f"for token in {same} of {len(reqs)}")
    if same != len(reqs):
        fail("ssm (ii): the service's streams differ from the sequential "
             "reference")
    del svc
    check_iii = ssm_scan_check(torch, np, params32, cfg32)
    del params32
    free_card(torch)
    if any(pa_kernel.LAUNCHES.values()):
        fail(f"ssm: paged kernels launched {dict(pa_kernel.LAUNCHES)}")
    return {"arch": ARCH_SSM, "weights": n_par, "init_s": init_s,
            "init_peak_gib": init_peak, "requests": len(work),
            "tokens": toks, "wall_s": wall, "tok_per_s": toks / wall,
            "ticks": dev["count"], "tick_ms_device": dev["mean"] * 1e3,
            "tick_ms_host": host["mean"] * 1e3,
            "ttft_ms_median": float(np.median(ttft)),
            "pool_bytes": bytes0, "prefill_ms_256": pf[256],
            "prefill_ms_4096": pf[SSM_LONG], "profile": prof,
            "check_i": check_i, "check_i_fp32": check_i32,
            "check_iii": check_iii}


def phase_train_ssm(torch, np, card):
    """falcon-mamba-7b at full width cut to 8 layers, AdamW, 20 run_training
    steps at (128, 8), deterministic; the lr-0 control."""
    import dataclasses
    from repro_torch.configs import get_config
    free_card(torch)
    cfg = dataclasses.replace(get_config(ARCH_SSM),
                              n_layers=SSM_TRAIN_LAYERS)
    run = traced_run(torch, np, cfg, "ssm", SSM_TRAIN_STEPS,
                     seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                     lr=SSM_TRAIN_LR)
    n_weights = tree_numel(run["params"])
    del run["params"], run["opt"]
    free_card(torch)
    ctrl = traced_run(torch, np, cfg, "ssm-control", SSM_TRAIN_STEPS,
                      seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, lr=0.0)
    del ctrl["params"], ctrl["opt"]
    free_card(torch)

    def drop(losses):
        w = SSM_LOSS_WINDOW
        return float(np.mean(losses[:w]) - np.mean(losses[-w:]))

    d, dc = drop(run["losses"]), drop(ctrl["losses"])
    step_ms = statistics.median(run["step_s"][SSM_LOSS_WINDOW:]) * 1e3
    log(f"[ssm-train] {ARCH_SSM}, full width, {SSM_TRAIN_LAYERS} layers "
        f"({n_weights:,} weights, bf16), AdamW, lr {SSM_TRAIN_LR}, "
        f"{SSM_TRAIN_STEPS} steps at ({TRAIN_SEQ}, {TRAIN_BATCH}): loss "
        f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}, mean of the "
        f"first {SSM_LOSS_WINDOW} minus the last: {d:.4f} (margin "
        f"{SSM_LOSS_MARGIN}); lr-0 control {dc:.4f}; step {step_ms:.2f} ms "
        f"(host span median); peak {run['peak']:.2f} GiB; {card}")
    if ctrl["losses"][0] != run["losses"][0]:
        fail("ssm-train: the control's first loss is not the run's")
    if not d >= SSM_LOSS_MARGIN:
        fail(f"ssm-train: the loss fell {d:.4f}, under {SSM_LOSS_MARGIN}")
    if not dc < SSM_LOSS_MARGIN:
        fail(f"ssm-train: the lr-0 control fell {dc:.4f}")
    return {"layers": SSM_TRAIN_LAYERS, "weights": n_weights,
            "steps": SSM_TRAIN_STEPS, "lr": SSM_TRAIN_LR,
            "loss_first": run["losses"][0], "loss_last": run["losses"][-1],
            "loss_drop": d, "control_drop": dc, "margin": SSM_LOSS_MARGIN,
            "step_ms_host_median": step_ms, "peak_gib": run["peak"],
            "wall_s": run["wall"]}


# ---------------------------------------------------------------------------
# the hybrid, enc-dec and VLM families: serving.prefill / decode_step as
# the static launcher drives them (launch.serve.generate), and run_training
# ---------------------------------------------------------------------------

ARCH_HYBRID = "zamba2-7b"     # as published: 81 layers (13 sites of 6 and a
#                             3-layer tail), d 3584, d_inner 7168 (112 SSD
#                             heads of 64), N 64; 2 shared blocks at 2d =
#                             7168 (32 heads of 224, d_ff 14336); vocab 32,000
ARCH_ENCDEC = "whisper-tiny"  # as published: 4 + 4 layers, d 384, 6 heads of
#                             64, 1,500 encoder frames, vocab 51,865
ARCH_VLM = "internvl2-76b"    # full width: d 8192, 64/8 heads of 128, d_ff
#                             28672, vocab 128,256, 256 patch positions
VLM_LAYERS = 24               # of 80: 45.3 GB in bf16 (all 80, 141 GB, do not
#                             fit 80 GB), as deepseek-v3 is cut to 5
FAMILY_WORK = {ARCH_HYBRID: (8, 256, 64),    # (batch, prompt, new tokens):
               ARCH_ENCDEC: (8, 4, 128),     # whisper within its 448 text
               ARCH_VLM: (8, 256, 64)}       # positions; internvl2's prompt
#                                              follows its 256 patch positions
HYBRID_LONG, HYBRID_LONG_NEW = 4096, 16   # check (ii): one 4,096-token prompt
#                             (a multiple of the SSD chunk, 128: a ragged
#                             one is a single chunk, its (B, S, S, 112)
#                             float32 decay 7.5 GB a row at 4,095), batch 1
TEACHER_LEN = 257             # check (i): prefill 256 tokens and decode the
#                             257th against forward(257), batch 2 (zamba2:
#                             two SSD chunks and the carried state against
#                             one ragged chunk of 257)
FAMILY_FP32_LAYERS = {ARCH_HYBRID: 15, ARCH_ENCDEC: 4, ARCH_VLM: 2}   # check
#                             (i) in fp32 at full width: zamba2 2 sites and a
#                             3-layer tail, whisper as published
FAMILY_LIMITS = {             # check (i), ‖Δ‖/‖logits‖ of the last logits,
    ARCH_HYBRID: (0.1, 1e-3),  # (bf16, fp32); set before the first run.
    ARCH_ENCDEC: (0.02, 1e-4),  # bf16: falcon's 64 layers read 4.4e-2 on the
    ARCH_VLM: (0.05, 1e-4),    # card (phase 27); on the CPU at full depth and
}                             # narrow width (d 512) zamba2 reads 3.4e-2 and
#                             internvl2 (24 layers) 1.1e-2, whisper at its
#                             published width 0; the bf16 rounding of 2^-9
#                             grows ~sqrt(depth): 81 layers + 13 shared
#                             blocks, 24 layers, 8 blocks.  fp32: ~1e-5 at
#                             81 narrow layers on the CPU, x100 margin.  The
#                             control (the family's carried context lost:
#                             zamba2's SSD state h, whisper's cross K/V,
#                             internvl2's patch positions' K/V, zeroed) read
#                             0.43, 0.72 and 0.90 there and must fail both
FAMILY_TRAIN = {                # (layers, steps, lr-0 control, base lr) at
    ARCH_HYBRID: (15, 20, True, SSM_TRAIN_LR),   # (128, 8), AdamW: zamba2 2
    ARCH_ENCDEC: (None, 20, True, 1e-2),         # sites + a 3-layer tail
    ARCH_VLM: (2, 4, False, SSM_TRAIN_LR),       # (2.48e9 weights; AdamW at
}                               # 81 layers needs ~91 GB), whisper as
#                             published, internvl2 2 layers (~3.8e9).
#                             whisper's d is 384: at falcon's lr its loss
#                             fell 0.0094 in 20 steps, under the margin; a
#                             CPU calibration on the same data gave 0.068 at
#                             1e-2 (its lr-0 control 0.006) and a loss rising
#                             again past step 25 as the warmup goes on


def family_cfg(arch, **over):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == ARCH_VLM:
        over.setdefault("n_layers", VLM_LAYERS)
    return dataclasses.replace(cfg, **over)


def family_inputs(torch, np, cfg, batch, plen, seed):
    """Prompts (batch, plen) and the family's stub inputs (x 0.02, as
    tests/test_archs_smoke.py draws them) in cfg.dtype, from ``seed``, on
    the card."""
    from repro_torch.models import lm
    rng = np.random.default_rng(seed)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, plen)),
                          device="cuda")
    return tok, {k: (torch.as_tensor(rng.standard_normal(v.shape).astype(
        np.float32), device="cuda") * 0.02).to(v.dtype)
                 for k, v in lm.stub_inputs(cfg, batch, "cuda").items()}


def tree_bytes(tree):
    return sum(tree_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def tree_clone(tree):
    return {k: tree_clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def no_kernel_served(what):
    launched = {k: v for m in kernel_modules() for k, v in m.LAUNCHES.items()
                if v}
    if launched or plain_calls():
        fail(f"{what}: kernels {launched} or plain versions {plain_calls()} "
             f"ran (no kernel is on this path)")


def context_lost(cfg, cache):
    """The control's cache: the family's carried context zeroed — zamba2's
    SSD state h in every layer, whisper's cross K/V, internvl2's patch
    positions' K/V."""
    c = tree_clone(cache)
    if cfg.family == "hybrid":
        c["h"].zero_()
    elif cfg.family == "encdec":
        c["cross"]["k"].zero_()
        c["cross"]["v"].zero_()
    else:
        c["k"][:, :, :cfg.n_vis_tokens].zero_()
        c["v"][:, :, :cfg.n_vis_tokens].zero_()
    return c


def family_teacher_check(torch, np, params, cfg, limit):
    """Check (i): prefill(256) + decode_step of the 257th token against
    forward(257) in cfg.dtype, batch 2, the last logits within ``limit``
    (‖Δ‖/‖logits‖); the control, decoded from the cache with the family's
    carried context zeroed, must fail it."""
    from repro_torch.models import lm, serving
    tok, extra = family_inputs(torch, np, cfg, 2, TEACHER_LEN, 3)
    with torch.no_grad():
        h, _ = lm.forward(params, cfg, tok, extra=extra)
        full = lm.logits_fn(params, cfg, h[:, -1]).float()
        del h
        _, cache, pos = serving.prefill(params, cfg, tok[:, :-1],
                                        extra=extra)
        cache = serving.pad_seq(cache, 1)
        lost = context_lost(cfg, cache)
        dec, _ = serving.decode_step(params, cfg, cache, tok[:, -1:], pos)
        ctl, _ = serving.decode_step(params, cfg, lost, tok[:, -1:], pos)
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        fail(f"{cfg.name} (i): logits not finite")
    rel = float((dec.float() - full).norm() / full.norm())
    ctl_rel = float((ctl.float() - full).norm() / full.norm())
    log(f"[{cfg.name}] (i) {cfg.dtype}, {cfg.n_layers} layers, 2 x "
        f"{TEACHER_LEN} tokens: prefill({TEACHER_LEN - 1}) + decode_step vs "
        f"forward({TEACHER_LEN}), last-token logits ‖Δ‖/‖logits‖ {rel:.3e} "
        f"(limit {limit}); with the carried context zeroed {ctl_rel:.3e}")
    if not rel <= limit:
        fail(f"{cfg.name} (i) {cfg.dtype}: {rel:.3e} > {limit}")
    if not ctl_rel > limit:
        fail(f"{cfg.name} (i) {cfg.dtype}: the check cannot see a lost "
             f"context ({ctl_rel:.3e})")
    return {"rel": rel, "control_rel": ctl_rel, "limit": limit}


def profile_decode(torch, params, cfg, cache, tok, pos, n_steps=4):
    """Device busy share of ``n_steps`` decode steps under torch.profiler:
    kernels a step and their device time (the profiler lengthens the
    window, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import serving
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logits, cache = serving.decode_step(params, cfg, cache, tok, pos)
            tok, pos = torch.argmax(logits, -1)[:, None], pos + 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, count = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total
            count += e.count
    busy = sum(kernels.values())
    if busy <= 0:
        log(f"[{cfg.name}-profile] the profiler reported no device time: "
            f"busy share not measured")
        return None
    gemm = sum(v for k, v in kernels.items()
               if any(g in k.lower() for g in GEMM_SYMBOLS))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    out = {"steps": n_steps, "wall_ms_per_step": wall_us / n_steps / 1e3,
           "device_ms_per_step": busy / n_steps / 1e3,
           "busy_share": busy / wall_us, "kernels_per_step": count / n_steps,
           "gemm_share": gemm / busy,
           "top": [[k[:96], v / n_steps / 1e3] for k, v in top]}
    log(f"[{cfg.name}-profile] batch {tok.shape[0]}, {n_steps} decode steps "
        f"under torch.profiler: {out['wall_ms_per_step']:.3f} ms a step on "
        f"the host clock, kernels {out['device_ms_per_step']:.3f} ms a step "
        f"(busy share {out['busy_share']:.3f}), "
        f"{out['kernels_per_step']:.0f} kernels a step, matrix products' "
        f"share {out['gemm_share']:.3f}; top kernels (ms a step): "
        + ", ".join(f"{k[:48]} {v:.3f}" for k, v in out["top"]))
    return out


def served(torch, np, params, cfg, batch, plen, new, seed):
    """launch.serve.generate (prefill, pad, greedy decode_steps) with every
    count at 0: no kernel and no plain version may run; the tokens in the
    vocabulary."""
    from repro_torch.launch.serve import generate
    tok, extra = family_inputs(torch, np, cfg, batch, plen, seed)
    torch.cuda.synchronize()
    reset_all_counts()
    run = generate(params, cfg, tok, new, extra=extra)
    no_kernel_served(f"serve {cfg.name}")
    ids = run["ids"]
    if tuple(ids.shape) != (batch, new + 1) or not bool(
            ((ids >= 0) & (ids < cfg.vocab)).all()):
        fail(f"serve {cfg.name}: tokens {tuple(ids.shape)} outside the "
             f"vocabulary")
    run.update(tok=tok, extra=extra)
    return run


def phase_serve_family(torch, np, card, arch):
    """One family through the static launcher's path on the card (bf16,
    weights from seed 0): the workload of FAMILY_WORK with its timings and
    a profiler window; zamba2's 4,096-token request in the trunk state's
    bytes of a 64-token cache (check ii); whisper's cross cache bitwise
    the prefill's after its decode steps (check iii); check (i) in bf16
    at this depth and in fp32 at FAMILY_FP32_LAYERS."""
    from repro_torch.models import lm, serving
    free_card(torch)
    cfg = family_cfg(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = tree_numel(params)
    log(f"[{arch}] {cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab}, {cfg.dtype}: {n_par:,} weights "
        f"({tree_bytes(params) / 1e9:.1f} GB) drawn on the card in "
        f"{init_s:.2f} s (seed 0), peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    b, plen, new = FAMILY_WORK[arch]
    run = served(torch, np, params, cfg, b, plen, new, 0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"arch": arch, "layers": cfg.n_layers, "weights": n_par,
           "init_s": init_s, "batch": b, "prompt": plen, "new": new,
           "prefill_ms": run["prefill_s"] * 1e3,
           "step_ms": run["decode_s"] / new * 1e3,
           "tok_per_s": b * new / run["decode_s"], "peak_gib": peak}
    vis = cfg.n_vis_tokens if cfg.family == "vlm" else 0
    log(f"[{arch}] batch {b}, prompt {plen}" + (f" after {vis} patch "
        f"positions" if vis else "") + f", {new} new tokens (greedy, static "
        f"launcher path): prefill {out['prefill_ms']:.2f} ms, decode "
        f"{out['step_ms']:.3f} ms a step (host wall over {new} steps), "
        f"{out['tok_per_s']:.1f} tok/s, peak {peak:.2f} GiB; no kernel or "
        f"plain version ran; {card}")
    if cfg.family == "encdec":
        # (iii): the prefill's cross K/V (the prefill repeated: cuBLAS is
        # deterministic here, CUBLAS_WORKSPACE_CONFIG set) against the cache
        # after the decode steps
        with torch.no_grad():
            _, fresh, _ = serving.prefill(params, cfg, run["tok"],
                                          extra=run["extra"])
        same = all(torch.equal(fresh["cross"][k], run["cache"]["cross"][k])
                   for k in ("k", "v"))
        moved = not torch.equal(fresh["self"]["k"],
                                run["cache"]["self"]["k"][:, :, :plen])
        log(f"[{arch}] (iii) the cross cache ({tuple(fresh['cross']['k'].shape)}"
            f" x 2, {tree_bytes(fresh['cross']):,} bytes) after {new} decode "
            f"steps bitwise the prefill's: {same}; the self cache's prompt "
            f"positions too: {not moved}")
        if not same or moved:
            fail(f"{arch} (iii): decode changed the prefill's cache")
        out["cross_unchanged"] = same
        del fresh
    cache = serving.pad_seq(run["cache"], 4)
    out["profile"] = profile_decode(torch, params, cfg, cache,
                                    run["ids"][:, -1:], run["pos"])
    del cache, run
    if cfg.family == "hybrid":
        # (ii): the trunk state of the long request's cache is that of a
        # 64-token cache, byte for byte
        long = served(torch, np, params, cfg, 1, HYBRID_LONG, HYBRID_LONG_NEW,
                      5)
        trunk = {k: long["cache"][k] for k in serving.TRUNK_LEAVES}
        want = serving.init_cache(cfg, 1, 64, torch.device("cuda"))
        want = {k: want[k] for k in serving.TRUNK_LEAVES}
        got_b, want_b = tree_bytes(trunk), tree_bytes(want)
        shapes_same = all(trunk[k].shape == want[k].shape for k in want)
        shared_b = tree_bytes(long["cache"]["shared"])
        out.update(long_prefill_ms=long["prefill_s"] * 1e3,
                   long_step_ms=long["decode_s"] / HYBRID_LONG_NEW * 1e3,
                   trunk_bytes=got_b, shared_bytes_long=shared_b)
        log(f"[{arch}] (ii) a {HYBRID_LONG}-token prompt, batch 1, "
            f"{HYBRID_LONG_NEW} new tokens: prefill "
            f"{out['long_prefill_ms']:.2f} ms, decode "
            f"{out['long_step_ms']:.3f} ms a step; the trunk state "
            f"{got_b:,} bytes (a 64-token cache's: {want_b:,}), the shared "
            f"K/V {shared_b:,} bytes ({shared_b / (HYBRID_LONG + HYBRID_LONG_NEW):,.0f}"
            f" a position)")
        if got_b != want_b or not shapes_same:
            fail(f"{arch} (ii): the trunk state grew with the context")
        del long, trunk, want
    out["check_i"] = family_teacher_check(torch, np, params, cfg,
                                          FAMILY_LIMITS[arch][0])
    del params
    free_card(torch)
    cfg32 = family_cfg(arch, dtype="float32",
                       n_layers=FAMILY_FP32_LAYERS[arch])
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg32)
    out["check_i_fp32"] = family_teacher_check(torch, np, params, cfg32,
                                               FAMILY_LIMITS[arch][1])
    del params
    free_card(torch)
    return out


def phase_train_families(torch, np, card):
    """zamba2-7b (15 layers), whisper-tiny (as published) and
    internvl2-76b (2 layers) through run_training at (128, 8), AdamW at
    FAMILY_TRAIN's base lr, deterministic, with the families' zero stub
    inputs: zamba2 and whisper 20 steps beside the lr-0 control (the last 5 losses' mean below the
    first 5's by SSM_LOSS_MARGIN, which the control must not reach),
    internvl2 4 steps."""
    out = {}
    for arch, (layers, steps, control, lr) in FAMILY_TRAIN.items():
        cfg = family_cfg(arch, **({"n_layers": layers} if layers else {}))
        free_card(torch)
        run = traced_run(torch, np, cfg, arch, steps, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, lr=lr)
        n_weights = tree_numel(run["params"])
        del run["params"], run["opt"]
        free_card(torch)
        res = {"layers": cfg.n_layers, "weights": n_weights, "steps": steps,
               "lr": lr,
               "loss_first": run["losses"][0],
               "loss_last": run["losses"][-1],
               "step_ms_host_median": statistics.median(
                   run["step_s"][1:]) * 1e3,
               "peak_gib": run["peak"], "wall_s": run["wall"]}
        line = (f"[{arch}-train] {cfg.n_layers} layers ({n_weights:,} "
                f"weights, {cfg.dtype}), AdamW, lr {lr}, {steps} steps at "
                f"({TRAIN_SEQ}, {TRAIN_BATCH}): loss {res['loss_first']:.4f} "
                f"-> {res['loss_last']:.4f}; step "
                f"{res['step_ms_host_median']:.2f} ms (host span median "
                f"after the first); peak {run['peak']:.2f} GiB")
        if control:
            ctrl = traced_run(torch, np, cfg, f"{arch}-control", steps,
                              seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                              lr=0.0)
            del ctrl["params"], ctrl["opt"]
            free_card(torch)
            w = SSM_LOSS_WINDOW
            d = float(np.mean(run["losses"][:w]) - np.mean(run["losses"][-w:]))
            dc = float(np.mean(ctrl["losses"][:w])
                       - np.mean(ctrl["losses"][-w:]))
            res.update(loss_drop=d, control_drop=dc, margin=SSM_LOSS_MARGIN)
            line += (f"; mean of the first {w} losses minus the last: {d:.4f}"
                     f" (margin {SSM_LOSS_MARGIN}), lr-0 control {dc:.4f}")
            if ctrl["losses"][0] != run["losses"][0]:
                fail(f"{arch}-train: the control's first loss is not the "
                     f"run's")
            if not d >= SSM_LOSS_MARGIN:
                fail(f"{arch}-train: the loss fell {d:.4f}, under "
                     f"{SSM_LOSS_MARGIN}")
            if not dc < SSM_LOSS_MARGIN:
                fail(f"{arch}-train: the lr-0 control fell {dc:.4f}")
        log(line + f"; {card}")
        out[arch] = res
    return out


# ---------------------------------------------------------------------------
# phases 33-34: the distributed layer on the card, the dry run
# ---------------------------------------------------------------------------

MLP_SHAPE = (1024, 2048, 6144)   # qwen3's MLP product: (m, d) · (d, d_ff)
PSUM_STEPS = 200   # tests/test_dist.py's error-feedback accumulation
PSUM_ACC_TOL = 1e-4   # its limit on |acc + ef - sum g| (the reference's)
PSUM_SUM_ULPS = 2.0 ** -23   # out + ef' vs g + ef, per leaf, times the
#                   leaf's max |g + ef|: ef' = c - deq and the sum deq + ef'
#                   each round once, half an ulp of a value <= max|c| each
DRYRUN_DIR = ROOT / "build" / "dryrun"   # the dry run's records (ignored)
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", "single"),
                ("deepseek-v3-671b", "decode_32k", "multi"))


def dist_steps(torch, np, cfg, dev):
    """Check (a): one train step of ``cfg`` at (TRAIN_SEQ, TRAIN_BATCH) on
    plain tensors and on DTensors over the 1x1 NCCL mesh, without and
    with activation sharding, loss, gradients, parameters and moments
    bitwise equal; the plain step's FLOPs under the dry run's counter."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist.act_sharding import activation_sharding
    from repro_torch.dist.sharding import (batch_pspecs, opt_pspecs,
                                           param_pspecs, place, shardings_for)
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.optim.tree import leaves, tree_map
    from repro_torch.trainer.loop import deterministic
    from repro_torch.trainer.steps import loss_and_grads, make_train_step
    mesh = make_host_mesh(1, 1, device_type=dev.type)
    data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(0).items()}
    out = {}
    with deterministic(dev):
        params0 = lm.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg)
        step, _ = make_train_step(cfg, optimizer="adamw")
        pspecs = param_pspecs(params0, mesh)
        o_meta = adamw_init(lm.param_shapes(cfg))
        o_shard = shardings_for(opt_pspecs(pspecs, o_meta, mesh), mesh)
        reset_all_counts()
        t0 = time.perf_counter()
        p_plain = tree_map(torch.clone, params0)
        o_plain = adamw_init(p_plain)
        out["arg_bytes"] = sum(t.numel() * t.element_size()
                               for t in leaves((p_plain, o_plain, batch)))
        loss0, _, g_plain = loss_and_grads(p_plain, cfg, batch)
        with StepCounter() as counter:      # counts; computes nothing else
            p_plain, o_plain, m_plain = step(p_plain, o_plain, batch)
        torch.cuda.synchronize()
        out["plain_s"] = time.perf_counter() - t0
        out["flops"] = counter.flops
        # the plain step's results wait in host memory (24 GB), so the card
        # holds one step's state at a time
        host = lambda ts: [t.to("cpu", copy=True) for t in ts]  # noqa: E731
        want = {"loss": host([loss0]), "step loss": host([m_plain["loss"]]),
                "gradient": host(leaves(g_plain)),
                "parameter": host(leaves(p_plain)),
                "moment": host(leaves(o_plain))}
        # torch's own counter on one more step, beside ours (it decomposes
        # some operators, so it runs apart from the steps compared)
        with FlopCounterMode(display=False) as fc:
            step(p_plain, o_plain, batch)
        out["torch_flops"] = fc.get_total_flops()
        del p_plain, o_plain, g_plain, m_plain
        for act in (False, True):
            t0 = time.perf_counter()
            # leaf by leaf, so no second copy of a tree is ever whole
            p_d = tree_map(lambda t, s: s.place(t.clone()), params0,
                           shardings_for(pspecs, mesh))
            o_d = tree_map(lambda t, s: s.place(torch.zeros(
                t.shape, dtype=t.dtype, device=dev)), o_meta, o_shard)
            b_d = place(batch, shardings_for(batch_pspecs(batch, mesh), mesh))
            ctx = (activation_sharding("data", "model") if act
                   else contextlib.nullcontext())
            with ctx:
                with implicit_replication():
                    loss_d, _, g_d = loss_and_grads(p_d, cfg, b_d)
                p_d, o_d, m_d = step(p_d, o_d, b_d)
            torch.cuda.synchronize()
            what = f"dist (a){' act' if act else ''}"
            if not all(isinstance(t, DTensor) and t.device == dev
                       for t in leaves((p_d, o_d, g_d))):
                fail(f"{what}: a leaf is not a DTensor on the card")
            got = {"loss": [loss_d], "step loss": [m_d["loss"]],
                   "gradient": leaves(g_d), "parameter": leaves(p_d),
                   "moment": leaves(o_d)}
            for name, ws in want.items():
                bad = sum(not torch.equal(w, g.full_tensor().cpu())
                          for w, g in zip(ws, got[name], strict=True))
                if bad:
                    fail(f"{what}: {bad} of {len(ws)} {name} leaves differ "
                         f"from the plain step's")
            out["act_s" if act else "dtensor_s"] = time.perf_counter() - t0
            del p_d, o_d, g_d, b_d, loss_d, m_d, got
    no_kernel_ran("dist (a)")
    out["loss"] = float(want["loss"][0])
    out["n_grads"] = len(want["gradient"])
    del params0
    return out, want["gradient"]


def dist_psum(torch, np, dev, grads):
    """Check (b): compressed_psum over the NCCL group on the step's
    gradients, each leaf within scale/2 of g + ef and out + ef' equal to
    g + ef within PSUM_SUM_ULPS; the 200-step accumulation at the largest
    leaf's shape within PSUM_ACC_TOL, and its control (the residual not
    carried) past it."""
    import torch.distributed as dist
    from repro_torch.dist.compression import (compressed_psum,
                                              init_error_feedback)
    from repro_torch.optim.tree import leaves
    grads = [g.to(dev) for g in grads]
    ef = init_error_feedback(grads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    summed, ef2 = compressed_psum(grads, ef, group=dist.group.WORLD)
    e1.record()
    torch.cuda.synchronize()
    out = {"psum_ms": e0.elapsed_time(e1),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    worst_q = worst_sum = 0.0
    for g, e, s, r in zip(leaves(grads), leaves(ef), leaves(summed),
                          leaves(ef2)):
        c = g.float() + e
        cmax = float(c.abs().max())
        scale = cmax / 127.0 if cmax > 0 else 1.0
        q_err = float((s - c).abs().max())
        sum_err = float((s + r - c).abs().max())
        if q_err > scale / 2 + cmax * PSUM_SUM_ULPS:
            fail(f"dist (b): a leaf's error {q_err} passes scale/2 "
                 f"{scale / 2}")
        if sum_err > cmax * PSUM_SUM_ULPS:
            fail(f"dist (b): out + ef' is {sum_err} from g + ef, past "
                 f"{cmax * PSUM_SUM_ULPS}")
        worst_q = max(worst_q, q_err / scale)
        worst_sum = max(worst_sum, sum_err / cmax if cmax else 0.0)
    out["worst_err_over_scale"], out["worst_sum_rel"] = worst_q, worst_sum
    n = sum(g.numel() for g in leaves(grads))
    out["wire_bytes"] = n + 4 * len(leaves(grads))   # int8 + one fp32 each
    out["fp32_bytes"] = 4 * n
    out["residual_gb"] = sum(r.numel() * 4 for r in leaves(ef2)) / 1e9
    shape = max((g.shape for g in leaves(grads)), key=lambda s: s.numel())
    out["control_shape"] = list(shape)
    del summed, ef2, ef
    for carried in (True, False):
        gen = torch.Generator(device=dev).manual_seed(1)
        acc = torch.zeros(shape, device=dev)
        true = torch.zeros(shape, device=dev, dtype=torch.float64)
        res = {"g": torch.zeros(shape, device=dev)}
        for _ in range(PSUM_STEPS):
            g = torch.randn(shape, generator=gen, device=dev) * 0.01
            o, r = compressed_psum({"g": g}, res)
            acc += o["g"]
            true += g.double()
            res = r if carried else {"g": torch.zeros(shape, device=dev)}
        err = float((acc.double() + res["g"].double() - true).abs().max())
        out["acc_err_carried" if carried else "acc_err_control"] = err
        del acc, true, res, g, o, r
    if not out["acc_err_carried"] <= PSUM_ACC_TOL:
        fail(f"dist (b): {PSUM_STEPS} steps with the residual carried end "
             f"{out['acc_err_carried']} from the true sum, past "
             f"{PSUM_ACC_TOL}")
    if not out["acc_err_control"] > PSUM_ACC_TOL:
        fail(f"dist (b): the control (residual dropped) ends "
             f"{out['acc_err_control']} from the true sum, inside "
             f"{PSUM_ACC_TOL}: the limit does not tell the carry")
    return out


def dist_rings(torch, dev):
    """Check (c): both ring matmuls at axis size 1 at qwen3's MLP shape,
    bitwise equal to x @ w, with their times beside x @ w's."""
    import torch.distributed as dist
    from repro_torch.dist.collective import (allgather_matmul,
                                             reducescatter_matmul)
    m, k, n = MLP_SHAPE
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(
        torch.bfloat16)
    group = dist.group.WORLD
    fns = {"x @ w": lambda: x @ w,
           "allgather_matmul": lambda: allgather_matmul(x, w, group, 1),
           "reducescatter_matmul": lambda: reducescatter_matmul(x, w, group,
                                                                1)}
    want = fns["x @ w"]()
    out = {}
    for name, fn in fns.items():
        if not torch.equal(fn(), want):
            fail(f"dist (c): {name} at axis size 1 is not x @ w bitwise")
        out[f"{name}_ms"] = events_ms(torch, fn, 20)
    return out


def dist_restore(torch, np, dev):
    """Check (d): a 2-layer {params, opt} checkpoint saved as the training
    loop saves it, restored with shardings onto DTensors over the card's
    1x1 mesh, every leaf bit for bit."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist.sharding import (opt_pspecs, param_pspecs,
                                           shardings_for)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.optim.tree import leaves
    from repro_torch.trainer.loop import deterministic
    from repro_torch.trainer.steps import make_train_step
    cfg = train_cfg(torch, n_layers=DRILL_LAYERS)
    mesh = make_host_mesh(1, 1, device_type=dev.type)
    data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(0).items()}
    with deterministic(dev):
        params = lm.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg)
        opt = adamw_init(params)
        step, _ = make_train_step(cfg, optimizer="adamw")
        params, opt, _ = step(params, opt, batch)   # moments not zero
    tree = {"params": params, "opt": opt}
    ckpt = TRAIN_DIR / "dist_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt))
    t0 = time.perf_counter()
    mgr.save(1, tree)
    save_s = time.perf_counter() - t0
    ps = param_pspecs(params, mesh)
    shardings = shardings_for({"params": ps,
                               "opt": opt_pspecs(ps, opt, mesh)}, mesh)
    t0 = time.perf_counter()
    back = mgr.restore(1, tree, shardings)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ckpt)
    got, want = leaves(back), leaves(tree)
    wrong = [i for i, (a, b, s) in enumerate(zip(got, want,
                                                 leaves(shardings)))
             if a.device.type != dev.type or tuple(a.placements) != s.placements
             or a.dtype != b.dtype or not torch.equal(a.full_tensor(), b)]
    if wrong or len(got) != len(want):
        fail(f"dist (d): {len(wrong)} of {len(want)} leaves not restored bit "
             f"for bit with their placements")
    n_bytes = sum(t.numel() * t.element_size() for t in want)
    del back, tree, params, opt
    return {"layers": DRILL_LAYERS, "leaves": len(want),
            "ckpt_gb": n_bytes / 1e9, "save_s": save_s,
            "restore_s": restore_s}


def phase_dist(torch, np, card):
    """Phase 33: the distributed layer on the card.  NCCL at world size 1
    over an in-process store, a 1x1 DeviceMesh on cuda; checks (a)-(d) as
    the docstring lists them, then (e): the dry run of the same step at
    (TRAIN_SEQ, TRAIN_BATCH) on the 1x1 mesh against what the card held
    and counted."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    free_card(torch)
    dev = torch.device("cuda", 0)
    cfg = train_cfg(torch)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        out = {"nccl_init_s": time.perf_counter() - t0,
               "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
        out["steps"], grads = dist_steps(torch, np, cfg, dev)
        free_card(torch)
        out["psum"] = dist_psum(torch, np, dev, grads)
        del grads
        free_card(torch)
        out["rings"] = dist_rings(torch, dev)
        out["restore"] = dist_restore(torch, np, dev)
        free_card(torch)
    finally:
        dist.destroy_process_group()
    # (e) the dry run of the step of (a) on the 1x1 mesh
    t0 = time.perf_counter()
    with dr.fake_world(1):
        mesh = make_host_mesh(1, 1, device_type=dr.mesh_device_type())
        fn, args, _ = dr.build_cell(
            cfg, dict(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      kind="train"), mesh, False)
        rec = dr.analyse_step(fn, args)
        del fn, args
    out["dryrun_s"] = time.perf_counter() - t0
    steps = out["steps"]
    if rec["memory"]["argument_bytes"] != steps["arg_bytes"]:
        fail(f"dist (e): the dry run's argument bytes "
             f"{rec['memory']['argument_bytes']} are not the card's "
             f"{steps['arg_bytes']} (params, moments, batch)")
    if rec["flops_per_device"] != steps["flops"]:
        fail(f"dist (e): the dry run counts {rec['flops_per_device']} FLOPs, "
             f"the card's step {steps['flops']} under the same counter")
    if rec["collective_operand_bytes_per_device"] != 0:
        fail("dist (e): collectives on a 1x1 mesh")
    out["dryrun"] = {"argument_bytes": rec["memory"]["argument_bytes"],
                     "flops": rec["flops_per_device"]}
    ps, rg, rs = out["psum"], out["rings"], out["restore"]
    log(f"[dist] {card}: NCCL {out['nccl']} at world size 1 "
        f"({out['nccl_init_s']:.2f} s to open), 1x1 mesh on cuda")
    log(f"[dist (a)] {ARCH_TRAIN} at full width ({steps['n_grads']} leaves): "
        f"one train step at ({TRAIN_SEQ}, {TRAIN_BATCH}) on DTensors "
        f"(placed by param/opt/batch_pspecs) bitwise the plain step's — "
        f"loss {steps['loss']:.6f}, every gradient, parameter and moment — "
        f"and so inside activation_sharding('data', 'model'); no kernel and "
        f"no plain version ran; host s plain {steps['plain_s']:.2f}, "
        f"DTensor {steps['dtensor_s']:.2f}, with constraints "
        f"{steps['act_s']:.2f}")
    log(f"[dist (b)] compressed_psum over the NCCL group on those "
        f"gradients: worst error {ps['worst_err_over_scale']:.4f} x scale "
        f"(limit 0.5 plus one rounding), out + ef' vs g + ef {ps['worst_sum_rel']:.3e} x max "
        f"(limit {PSUM_SUM_ULPS:.3e}); wire {ps['wire_bytes'] / 1e9:.3f} GB "
        f"(int8 + scales) vs fp32 {ps['fp32_bytes'] / 1e9:.3f} GB; "
        f"{ps['psum_ms']:.1f} ms (CUDA events), peak "
        f"{ps['peak_gib']:.1f} GiB, residuals {ps['residual_gb']:.2f} GB; "
        f"{PSUM_STEPS} steps at {ps['control_shape']}: carried "
        f"{ps['acc_err_carried']:.3e}, control (dropped) "
        f"{ps['acc_err_control']:.3e} (limit {PSUM_ACC_TOL})")
    log(f"[dist (c)] ring matmuls at axis size 1, {MLP_SHAPE} bf16: bitwise "
        f"x @ w; ms x @ w {rg['x @ w_ms']:.3f}, allgather "
        f"{rg['allgather_matmul_ms']:.3f}, reducescatter "
        f"{rg['reducescatter_matmul_ms']:.3f}")
    log(f"[dist (d)] {rs['leaves']} leaves ({rs['ckpt_gb']:.2f} GB, "
        f"{rs['layers']} layers) restored with shardings onto the card bit "
        f"for bit; save {rs['save_s']:.2f} s, restore {rs['restore_s']:.2f} s")
    log(f"[dist (e)] dry run of that step on the 1x1 mesh "
        f"({out['dryrun_s']:.1f} s): argument bytes "
        f"{rec['memory']['argument_bytes']:,} = the card's; FLOPs "
        f"{rec['flops_per_device']:.6e} = the card's step under the same "
        f"counter (torch's FlopCounterMode: {steps['torch_flops']:.6e}); "
        f"the record leaves the peak out (meta tensors have no allocator)")
    return out


def phase_dryrun(torch, np, card):
    """Phase 34: two cells of the dry run at production size on this
    machine (fake process groups of 256 and 512, meta shards): each
    cell's wall time, per-device bytes, FLOPs and collective counts.
    Predictions over the reference's mesh shapes, not times of the card."""
    from repro_torch.launch import dryrun as dr
    out = {}
    for arch, shape, mesh_kind in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dr.run_cell(arch, shape, mesh_kind, str(DRYRUN_DIR),
                          extrapolate=False)
        wall = time.perf_counter() - t0
        if rec["status"] != "ok":
            fail(f"dryrun {mesh_kind}/{arch}/{shape}: {rec.get('error')}")
        full = rec["full"]
        colls = {k: v["count"] for k, v in full["collectives"].items()
                 if v["count"]}
        if not full["flops_per_device"] > 0 or not colls:
            fail(f"dryrun {arch}/{shape}: no FLOPs or no collectives")
        out[f"{mesh_kind}/{arch}/{shape}"] = {
            "wall_s": wall, "flops_per_device": full["flops_per_device"],
            "memory": full["memory"], "collectives": colls,
            "collective_operand_bytes_per_device":
                full["collective_operand_bytes_per_device"]}
        log(f"[dryrun] {mesh_kind}/{arch}/{shape} on {rec['chips']} fake "
            f"ranks in {wall:.1f} s: per device {full['flops_per_device']:.4e}"
            f" FLOPs, arguments {full['memory']['argument_bytes'] / 2**30:.3f}"
            f" GiB, outputs {full['memory']['output_bytes'] / 2**30:.3f} GiB,"
            f" collectives {colls} moving "
            f"{full['collective_operand_bytes_per_device'] / 2**30:.3f} GiB "
            f"of operands (predictions, not the card's)")
    return out


# ---------------------------------------------------------------------------
# slice 10: the examples' twins (phase 35); the published configurations
# served on K10 (phase 36) are with starcoder2-7b's phase above
# ---------------------------------------------------------------------------

EXAMPLE_DIR = ROOT / "build" / "examples"   # the trace and the training
#                                             workdirs (git-ignored), deleted
NBODY_MEDIAN_TOL, NBODY_MEAN_TOL = 2e-2, 5e-2   # per-particle relative force
#   error against the direct sum, median and mean: the reference's accuracy
#   bounds (tests/test_barneshut.py::test_accuracy_vs_direct); the control,
#   the same accelerations read in the input order instead of the tree's
#   sorted one, must exceed both
# efficiencies the card run simulates again on the host beside the
# example's own (the simulator is host code; at 64 workers it takes ~27 s at
# 20k particles on one core, the reference's as well, so that one is held
# only in tests/test_torch_examples.py, against the reference, at 2,000)
NBODY_RESIMULATE = (1, 8, 32)


def load_example(name):
    """examples/<name>_torch.py as a module (the examples are scripts, not
    a package), so its ``main()`` runs in this process."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_quickstart(torch, np):
    """quickstart_torch.main() on the card against itself on the CPU."""
    from repro_torch.kernels.qr_tile import kernel as qk
    qs = load_example("quickstart")
    reset_all_counts()
    cpu = qs.main(["--device", "cpu"])
    cpu_calls = dict(qk.PLAIN_CALLS)
    reset_all_counts()
    t0 = time.perf_counter()
    out = qs.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(qk.LAUNCHES), plain_calls()
    if out["order"][0] != "A" or sorted(out["order"]) != ["A", "B", "C"]:
        fail(f"quickstart: execution order {out['order']}")
    if out["makespan"] != 3.0:
        fail(f"quickstart: makespan {out['makespan']}, wanted 3.0")
    a, r = out["a"].double(), out["r"].double()
    gram = float((r.T @ r - a.T @ a).norm() / a.norm() ** 2)
    # control: R rounded to half precision (TF32's 10-bit mantissa)
    rh = out["r"].half().double()
    gram_ctrl = float((rh.T @ rh - a.T @ a).norm() / a.norm() ** 2)
    if not gram <= GRAM_TOL < gram_ctrl:
        fail(f"quickstart: ‖RᵀR − AᵀA‖_F/‖A‖_F² {gram:.3e}, its control "
             f"(R in half precision) {gram_ctrl:.3e}, limit {GRAM_TOL}")
    if not torch.equal(out["r_engine"], out["r"]):
        fail("quickstart: the engine's R is not bitwise the sequential R")
    vs_cpu = float((out["r"].cpu() - cpu["r"]).norm() / cpu["r"].norm())
    if not vs_cpu <= CPU_TOL:
        fail(f"quickstart: R on the card vs the CPU {vs_cpu:.3e} > {CPU_TOL}")
    for k in ("order", "makespan", "nr_tasks", "host_dispatches",
              "engine_dispatches", "speedups"):
        if out[k] != cpu[k]:
            fail(f"quickstart: {k} {out[k]} on the card, {cpu[k]} on the CPU")
    if plain or launches != cpu_calls or not all(launches.values()):
        fail(f"quickstart: kernels launched {launches} (the CPU's plain "
             f"calls {cpu_calls}), plain versions on the card {plain}")
    log(f"[quickstart] order {out['order']}, makespan {out['makespan']}; "
        f"{out['nr_tasks']} tasks, |RᵀR − AᵀA| max {out['gram_err']:.2e}, "
        f"‖·‖_F/‖A‖_F² {gram:.3e} (limit {GRAM_TOL}; R in half precision "
        f"{gram_ctrl:.3e}); engine R bitwise the sequential R; R vs the CPU "
        f"{vs_cpu:.3e}; host dispatches {out['host_dispatches']} -> "
        f"{out['engine_dispatches']} as on the CPU; launches {launches} = "
        f"the CPU's plain calls, no plain version on the card; "
        f"{wall:.2f} s")
    return {"wall_s": wall, "gram_rel": gram, "gram_control": gram_ctrl,
            "gram_err_max": out["gram_err"], "vs_cpu": vs_cpu,
            "launches": launches, "speedups": out["speedups"]}


def example_nbody(torch, np):
    """nbody_torch.main() at its defaults on the card: K6/K7 one launch a
    task, the accuracy bounds with their control, the host's graph and
    simulation."""
    from repro_torch.apps import barneshut as bh
    from repro_torch.core import simulate
    from repro_torch.kernels.nbody import kernel as nbk
    nb = load_example("nbody")
    reset_all_counts()
    t0 = time.perf_counter()
    out = nb.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(nbk.LAUNCHES), plain_calls()
    g = out["state"].g
    want = {"acc_self": sum(len(v) for v in g.self_blocks.values()),
            "acc_pair": 2 * sum(len(v) for d in (g.self_pairs, g.pair_pairs)
                                for v in d.values())
            + sum(1 for v in g.pc_lists.values() if v), "bh_walk": 0}
    if plain or launches != want or not want["acc_self"]:
        fail(f"nbody: kernels launched {launches}, wanted {want} (one a "
             f"self block, two a direct pair, one a PC list); plain versions "
             f"on the card {plain}")
    x, m = out["x"], out["m"]
    host = bh.build_graph(bh.Octree(x, m, n_max=nb.N_MAX), n_task=nb.N_TASK)
    if out["counts"] != host.counts:
        fail(f"nbody: graph counts {out['counts']}, the host's build "
             f"{host.counts}")
    for w in NBODY_RESIMULATE:
        gw = bh.build_graph(bh.Octree(x, m, n_max=nb.N_MAX),
                            n_task=nb.N_TASK, nr_queues=w)
        r = simulate(gw.sched, w)
        if out["efficiency"][w] != r.total_cost / (w * r.makespan):
            fail(f"nbody: efficiency at {w} workers {out['efficiency'][w]}, "
                 f"the host's simulation {r.total_cost / (w * r.makespan)}")
    dev = out["acc"].device
    ctrl = nb.relative_errors(out["acc"], nb.direct_sum(
        torch.as_tensor(x.T, dtype=torch.float32, device=dev),
        torch.as_tensor(m, dtype=torch.float32, device=dev)))
    med, mean = out["median_rel"], out["mean_rel"]
    c_med, c_mean = float(np.median(ctrl)), float(ctrl.mean())
    if not (med < NBODY_MEDIAN_TOL and mean < NBODY_MEAN_TOL):
        fail(f"nbody: relative force error median {med:.3e}, mean "
             f"{mean:.3e} (limits {NBODY_MEDIAN_TOL}, {NBODY_MEAN_TOL})")
    if c_med < NBODY_MEDIAN_TOL or c_mean < NBODY_MEAN_TOL:
        fail(f"nbody: the control (input order) passes the limits: median "
             f"{c_med:.3e}, mean {c_mean:.3e}")
    log(f"[nbody] N {out['n']}: solve {out['solve_s']:.2f} s on the card "
        f"(sequential, one launch a task), graph {out['counts']} = the "
        f"host's build; launches {launches}; relative force error vs the "
        f"direct sum median {med:.3e}, mean {mean:.3e} (limits "
        f"{NBODY_MEDIAN_TOL}, {NBODY_MEAN_TOL}; read in the input order "
        f"{c_med:.3e}, {c_mean:.3e}); efficiencies "
        f"{ {w: round(e, 6) for w, e in out['efficiency'].items()} } "
        f"({list(NBODY_RESIMULATE)} = the host's simulation again); "
        f"{wall:.2f} s")
    return {"wall_s": wall, "solve_s": out["solve_s"], "counts": out["counts"],
            "launches": launches, "median_rel": med, "mean_rel": mean,
            "control_median": c_med, "control_mean": c_mean,
            "efficiency": out["efficiency"]}


def example_trace_qr(torch, np):
    """trace_qr_torch.main() on the card: one QR walk launch a round and an
    item (and a warm-up of each), a valid two-process trace."""
    from repro_torch.kernels.qr_tile import kernel as qk
    from repro_torch.obs import validate_chrome_trace
    tq = load_example("trace_qr")
    EXAMPLE_DIR.mkdir(parents=True, exist_ok=True)
    path = EXAMPLE_DIR / "trace_qr.json"
    reset_all_counts()
    t0 = time.perf_counter()
    out = tq.main(["--out", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(qk.LAUNCHES), plain_calls()
    info = validate_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    path.unlink()
    names = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    tasks = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X" and e.get("cat") == "task":
            tasks[names[e["pid"]]] = tasks.get(names[e["pid"]], 0) + 1
    items = out["nr_items"]
    if (info["processes"] != ["measured", "predicted"]
            or tasks != {"measured": items, "predicted": items}
            or out["n_pred"] != items):
        fail(f"trace_qr: processes {info['processes']}, task events "
             f"{tasks}, {out['n_pred']} predicted, wanted {items} each")
    rounds = int((np.diff(out["tables"].round_offsets) > 0).sum())
    want = {k: 0 for k in launches}
    want["qr_walk"] = 2 * rounds + 1 + items   # warm-up and timed rounds,
    #                                            one item warm-up, the items
    if plain or launches != want:
        fail(f"trace_qr: kernels launched {launches}, wanted {want}; plain "
             f"versions on the card {plain}")
    bad = json.loads(json.dumps(trace))
    task = next(e for e in bad["traceEvents"] if e.get("cat") == "task")
    task["dur"] = -1.0
    try:
        validate_chrome_trace(bad)
    except ValueError:
        pass
    else:
        fail("trace_qr: the validator took an event of negative duration")
    log(f"[trace_qr] {out['nr_tasks']} tasks, {items} items; qr_walk "
        f"launches {launches['qr_walk']} ({rounds} rounds twice, one warm-up"
        f" item, {items} items); measured serial "
        f"{out['measured_s'] * 1e3:.3f} ms, predicted makespan "
        f"{out['makespan'] * 1e3:.3f} ms; trace {info['events']} events, "
        f"processes {info['processes']}, task events {tasks}, valid (a copy "
        f"with a negative duration refused); {wall:.2f} s")
    return {"wall_s": wall, "items": items, "launches": launches["qr_walk"],
            "measured_ms": out["measured_s"] * 1e3,
            "predicted_ms": out["makespan"] * 1e3, "events": info["events"]}


def example_train_lm(torch, np, full_width):
    """train_lm_torch.main() on the card at its defaults (300 steps),
    default width or --full-width: no kernel and no plain version, the loss
    windows' drop beside the lr-0 control's, its checkpoints, 16 greedy
    ids."""
    import shutil
    tl = load_example("train_lm")
    tag = "train_lm" + ("_full" if full_width else "")
    workdir = EXAMPLE_DIR / tag
    shutil.rmtree(workdir, ignore_errors=True)
    reset_all_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = tl.main(["--workdir", str(workdir)]
                  + (["--full-width"] if full_width else []))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    no_kernel_ran(f"{tag} (example)")
    ckpts = sorted(os.listdir(workdir / "ckpt"))
    shutil.rmtree(workdir, ignore_errors=True)
    losses, cfg = out["losses"], out["cfg"]
    if ckpts != ["step_00000100", "step_00000200", "step_00000300"]:
        fail(f"{tag}: checkpoints {ckpts}")
    if len(out["sample"]) != 16 or not all(0 <= t < cfg.vocab
                                           for t in out["sample"]):
        fail(f"{tag}: greedy sample {out['sample']}")
    ctrl = traced_run(torch, np, cfg, f"{tag}-control", CONTROL_STEPS,
                      lr=0.0)
    drop, c_drop = loss_drop(np, losses), loss_drop(np, ctrl["losses"])
    if ctrl["losses"][0] != losses[0]:
        fail(f"{tag}: the lr-0 control's first loss {ctrl['losses'][0]} is "
             f"not the run's {losses[0]}")
    if not (drop >= LOSS_MARGIN > c_drop):
        fail(f"{tag}: the first {LOSS_WINDOW} losses' mean minus the last's "
             f"{drop:.4f}, the lr-0 control's {c_drop:.4f}, margin "
             f"{LOSS_MARGIN}")
    log(f"[{tag}] {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{out['n_params']:,} params (param_count), {len(losses)} steps at "
        f"(128, 8): loss {losses[0]:.4f} -> {losses[-1]:.4f}, window drop "
        f"{drop:.4f} (margin {LOSS_MARGIN}; lr-0 control over "
        f"{CONTROL_STEPS} steps {c_drop:.4f}); checkpoints {ckpts}; greedy "
        f"ids {out['sample']}; no kernel ran; {wall:.2f} s "
        f"({wall / len(losses) * 1e3:.1f} ms a step with the checkpoints "
        f"and the sample), peak {peak:.2f} GiB")
    return {"wall_s": wall, "steps": len(losses), "params": out["n_params"],
            "loss_first": losses[0], "loss_last": losses[-1],
            "loss_drop": drop, "control_drop": c_drop, "peak_gib": peak,
            "sample": out["sample"]}


def phase_examples(torch, np, card):
    """Phase 35: the four examples' twins in this process, on the card."""
    import shutil
    out = {"quickstart": example_quickstart(torch, np),
           "nbody": example_nbody(torch, np),
           "trace_qr": example_trace_qr(torch, np)}
    for full in (False, True):
        out["train_lm" + ("_full" if full else "")] = example_train_lm(
            torch, np, full)
        free_card(torch)
    shutil.rmtree(EXAMPLE_DIR, ignore_errors=True)
    log(f"[examples] the four twins passed on the card; {card}")
    return out


@contextlib.contextmanager
def phase_clock(name, times):
    """Log the seconds of the phases run inside, into ``times[name]``."""
    t0 = time.perf_counter()
    yield
    times[name] = time.perf_counter() - t0
    log(f"[phase-s] {name}: {times[name]:.1f} s")


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
    times = {}
    with phase_clock("1-2 device, build", times):
        card = phase_device(torch)
        phase_build()
    with phase_clock("3-6 QR", times):
        errs = phase_ops(torch, np)
        walk_err = phase_walk(torch, np)
        a, launches, vs_cpu, wide = phase_main(torch, np)
        rows = phase_timing(torch, np, a, launches, errs, walk_err, vs_cpu,
                            wide, card)
        del a
        torch.cuda.empty_cache()
    with phase_clock("7-11 Barnes-Hut", times):
        nb_errs = phase_nbody_ops(torch, np)
        bh_err, ms20k, plain20k, rows20k = phase_bh_walk(torch, np)
        bh_launches, firsts = phase_bh_main(torch, np)
        paper_launches, paper_rounds, paper_run = phase_bh_paper(torch, np)
        rows += phase_bh_timing(torch, np, firsts, bh_launches,
                                paper_launches, paper_rounds, paper_run,
                                nb_errs, bh_err,
                                {"ms": ms20k, "plain_ms": plain20k,
                                 "rows": rows20k}, card)
        del paper_run
        torch.cuda.empty_cache()
    with phase_clock("12-14 K10, qwen3-1.7b", times):
        k10_errs = phase_k10(torch, np)
        serve = phase_serve(torch, np)
        k10_row = phase_k10_timing(torch, np, k10_errs, serve, card)
        rows.append(k10_row)
        log("[serve-json] " + json.dumps(
            {k: serve[k] for k in ("a", "b", "bf16_logit_rel", "profile")}))
        del serve
        free_card(torch)
    with phase_clock("14a starcoder2-7b", times):
        sc2 = phase_serve_starcoder2(torch, np)
        k10_row["launches_starcoder2"] = sc2["launches"]
        log("[serve-sc2-json] " + json.dumps(sc2))
        del sc2
    with phase_clock("15-17 K11, deepseek-v3-671b", times):
        k11_errs = phase_k11(torch, np)
        serve_mla = phase_serve_mla(torch, np)
        rows.append(phase_k11_timing(torch, np, k11_errs, serve_mla, card))
        log("[serve-mla-json] " + json.dumps(
            {k: serve_mla[k] for k in ("weights", "init_peak_gib", "a", "b",
                                       "bf16_logit_rel", "profile")}))
        del serve_mla
        free_card(torch)
    with phase_clock("18-20 K9, pipeline", times):
        k9_err, k9_wide = phase_k9(torch, np)
        pipe_run = phase_pipe(torch, np)
        rows.append(phase_pipe_timing(torch, np, k9_err, k9_wide, pipe_run,
                                      card))
        del pipe_run
    with phase_clock("21-22 K12", times):
        k12_errs = phase_k12(torch, np)
        k12_launches, qkvo = phase_k12_path(torch)
        rows.append(phase_k12_timing(torch, np, k12_errs, k12_launches, qkvo,
                                     card))
        del qkvo
    with phase_clock("23-25 training", times):
        train = phase_train(torch, np, card)
        train["drill"] = phase_drill(torch, np, card)
        train["fp32"] = phase_train_fp32(torch, np, card)
        log("[train-json] " + json.dumps(train))
        del train
        free_card(torch)
    with phase_clock("26 round times", times):
        log("[rounds-json] " + json.dumps(phase_rounds(torch, np, card)))
        free_card(torch)
    with phase_clock("27 falcon-mamba-7b serving", times):
        log("[ssm-json] " + json.dumps(phase_serve_ssm(torch, np, card)))
        free_card(torch)
    with phase_clock("28 falcon-mamba-7b training", times):
        log("[ssm-train-json] " + json.dumps(phase_train_ssm(torch, np,
                                                             card)))
        free_card(torch)
    for i, arch in zip((29, 30, 31), (ARCH_HYBRID, ARCH_ENCDEC, ARCH_VLM)):
        with phase_clock(f"{i} {arch}", times):
            log(f"[{arch}-json] " + json.dumps(phase_serve_family(
                torch, np, card, arch)))
            free_card(torch)
    with phase_clock("32 family training", times):
        log("[family-train-json] " + json.dumps(phase_train_families(
            torch, np, card)))
        free_card(torch)
    with phase_clock("33 distributed", times):
        log("[dist-json] " + json.dumps(phase_dist(torch, np, card)))
        free_card(torch)
    with phase_clock("34 dry run", times):
        log("[dryrun-json] " + json.dumps(phase_dryrun(torch, np, card)))
    with phase_clock("35 examples", times):
        log("[examples-json] " + json.dumps(phase_examples(torch, np, card)))
        free_card(torch)
    with phase_clock("36 configurations", times):
        configs = phase_serve_configs(torch, np)
        for name, (arch, *_) in zip(K10_LAYOUTS, CONFIG_SERVES):
            k10_row[f"launches_{name}"] = configs[arch]["launches"]
            k10_row[f"launches_per_tick_{name}"] = (
                configs[arch]["launches"] / configs[arch]["ticks"])
        log("[serve-configs-json] " + json.dumps(configs))
        del configs
    leaked = sorted(k for k in sys.modules if k == "jax"
                    or k.startswith("jax.") or k == "repro"
                    or k.startswith("repro."))
    if leaked:
        fail(f"imported {leaked}")
    log("[phase-json] " + json.dumps(times))
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
