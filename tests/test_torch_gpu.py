"""The port's CUDA kernels on the card (``gpu`` marker; skipped without a
card).  No jax import, so the file runs on the machine with the H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, at the reference's kernel-vs-oracle tolerance (QR: atol 2e-5,
rtol 1e-4, tests/test_kernels_qr.py, at every tile size, past 64 through
the blocked bodies; N-body: rtol 2e-4, atol 1e-5,
tests/test_kernels_nbody.py).  Across the four execution modes the card's
QR R is bitwise equal (one set of ``__device__`` functions, one
blockDim); against the plain path on the CPU it agrees to atol
1e-4·max|R|, rtol 1e-4 (two float32 summation orders).  The QR walk (K5),
one cooperative launch a plan, is held to the plain walk per tile at
``WALK_TOL`` (max|Δ| / max(1, max|plain|) 1e-4, chip_smoke.py's), also on
a table whose phases are longer than the resident grid.  The N-body
tolerance applies to each target's acceleration vector, not to each of its
components: a component that cancels to ~1 out of terms of ~10³ keeps no
relative precision in any float32 sum, and the kernel and its plain
version sum in different orders (rsqrtf in order j = 0, 1, ... against
PyTorch's reductions).  The Barnes-Hut walk K8 walks only each leaf's
real particles, so it is held to the plain walk over the padded blocks on
every real particle, the pads' accelerations left at zero.  Barnes-Hut's
modes sum in different orders (a leaf's COM sources in one launch or in
rows of 8), so they agree within 1e-4 per particle, relative, with each
other and with the CPU plain path (the reference's cross-mode tolerance).
The paged decode kernels K10 (GQA) and K11 (MLA; bf16 on the tensor
cores) are held to ``PAGED_TOL``: the reference's in fp32, one output ulp
in bf16.  The
pipeline walk K9 (one cooperative launch a plan) is held to its plain walk
on every state buffer at the reference's pipeline tolerance (rtol 1e-5, atol 1e-6,
tests/test_backends.py) and is bitwise repeatable; the four pipeline modes
on the card to a float64 ``torch.autograd`` of the monolithic loss at the
same tolerance.  Flash attention K12 is held to its plain version at the
reference's tolerance (tests/test_kernels_flash.py): atol 2e-5, rtol 1e-4
in fp32, 2e-2 in bf16.  The training step (no kernel on its path) is held
to the same step on the CPU in fp32 at the reference's kernel-test
tolerance (atol 2e-5, rtol 1e-4), and the kill-and-resume drill on the
card bit for bit.
"""

import os

import numpy as np
import pytest

# deterministic cuBLAS for the restart-exact training tests: read at the
# process's first cuBLAS call, so set before any test runs
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch import engine  # noqa: E402
from repro_torch.apps import barneshut as bh  # noqa: E402
from repro_torch.apps import qr  # noqa: E402
from repro_torch.core import lower  # noqa: E402
from repro_torch.kernels.nbody import kernel as nb_kernel  # noqa: E402
from repro_torch.kernels.nbody import ops as nb_ops  # noqa: E402
from repro_torch.kernels.nbody import ref as nb_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pa_ref  # noqa: E402
from repro_torch.kernels.qr_tile import kernel, ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-5, rtol=1e-4)
MODES = ("sequential", "threaded", "rounds", "engine")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (H100)")
    return torch.device("cuda")


def rand(shape, seed, device):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape),
                        dtype=torch.float32, device=device)


def close(got, want):
    for g, w in zip(got, want):
        assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)


# K1-K4 tile sizes: the shared-memory bodies' edges (1, 7, 16, 33, 64),
# the reference tests' and run_qr's 32, and the blocked bodies past 64
# (65, 96, 128, 256: panels of 64 + 1, 64 + 32, two of 64, eight of 32)
QR_SIZES = [1, 7, 16, 32, 33, 64, 65, 96, 128, 256]


@pytest.mark.parametrize("b", QR_SIZES)
@pytest.mark.parametrize("n", [1, 8])
def test_kernels_match_plain_on_card(cuda, b, n):
    """K1-K4 against their plain versions.  At batch 8 each op's dense
    input has the Householder guards: tile 1 a zero column, tile 2
    already triangular, tile 3 zero (tau = 0 throughout).  tsqrf's R is a
    random triangle: with R = 0 its T and V2 are ill-conditioned in
    float32 (the plain version itself lies up to 1.2e-3 from float64 at
    b = 64), so no two summation orders agree there to the limit."""
    a, c1, c2, r = (rand((n, b, b), b + k, cuda) for k in range(4))
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
    for i in range(n):
        close((rv[i], tau[i], t[i]), ref.geqrf_ref(a[i]))
        close((r1[i], v2[i], tau2[i], t2[i]), ref.tsqrf_ref(r[i], c1[i]))
        close((q1[i],), (ref.apply_qt_ref(rv[i], t[i], c2[i]),))
        close((s1[i], s2[i]), ref.apply_tsqt_ref(v2[i], t2[i], c1[i], c2[i]))


def tol_dist(got, want):
    """max |got - want| / (atol + rtol |want|) at TOL: 1 is the limit."""
    g, w = got.double().cpu(), want.double().cpu()
    assert bool(torch.isfinite(g).all())
    return float(((g - w).abs() / (TOL["atol"] + TOL["rtol"] * w.abs()))
                 .max())


def float64_tiles(b, device):
    """The inputs (a, c1, c2, r) of the float64 test at tile size b: at b
    = 256 the 40 seeded tiles on which tools/qr_wide_accuracy.py measures
    K1-K4 (tile s, input k from np.random.default_rng(1000 + 4 s + k));
    elsewhere 2 tiles from np.random.default_rng(b), 1 past 4096 (an op
    takes tens of seconds there)."""
    if b == 256:
        a, c1, c2, r = (torch.tensor(np.stack([
            np.random.default_rng(1000 + 4 * s + k).standard_normal((b, b))
            for s in range(40)]), dtype=torch.float32, device=device)
            for k in range(4))
    else:
        rng = np.random.default_rng(b)
        n = 1 if b > 4096 else 2
        a, c1, c2, r = (torch.tensor(rng.standard_normal((n, b, b)),
                                     dtype=torch.float32, device=device)
                        for _ in range(4))
    return a, c1, c2, torch.triu(r)


@pytest.mark.parametrize("b", [256, 512, 1000, 1025, 2048, 2049, 4097])
def test_wide_kernels_no_further_from_float64_than_plain(cuda, b):
    """K1-K4 at b = 256, 512 and 1000 (panels of 32, 16 and 8), at 1025 and
    2048 (panels of 4, a column over two warps), 2049 (panels of 2, four
    warps) and 4097 (one-column panels, eight warps); past 1024 the
    register panels factor 64-column outer panels and the applies go in
    64-reflector blocks, one 64-column chunk of C a block.  From 256 on two
    float32 QRs lie about the kernel-vs-plain limit apart (the plain
    version itself lies past it from float64 at b = 256 and 1000), so each
    output is held to the float64 version of its plain function on the
    same float32 inputs: within the limit, or no further than the plain
    float32 version is.  At 256 on 40 seeded tiles (float64_tiles), where
    W = V^T M summed as one float chain lay past both on 2."""
    a, c1, c2, r = float64_tiles(b, cuda)
    got_f = [ops.geqrf(a), ops.tsqrf(r, c1)]
    for i in range(a.shape[0]):
        rv, _, t = ref.geqrf_ref(a[i])
        _, v2, _, t2 = ref.tsqrf_ref(r[i], c1[i])
        d64 = [x.double() for x in (a[i], r[i], c1[i], c2[i], rv, t, v2,
                                    t2)]
        cases = [
            ([y[i] for y in got_f[0]], ref.geqrf_ref(a[i]),
             ref.geqrf_ref(d64[0])),
            ([y[i] for y in got_f[1]], ref.tsqrf_ref(r[i], c1[i]),
             ref.tsqrf_ref(d64[1], d64[2])),
            (ops.apply_qt(rv[None], t[None], c2[i][None]),
             (ref.apply_qt_ref(rv, t, c2[i]),),
             (ref.apply_qt_ref(d64[4], d64[5], d64[3]),)),
            ([y[0] for y in ops.apply_tsqt(v2[None], t2[None], c1[i][None],
                                           c2[i][None])],
             ref.apply_tsqt_ref(v2, t2, c1[i], c2[i]),
             ref.apply_tsqt_ref(d64[6], d64[7], d64[2], d64[3]))]
        torch.cuda.synchronize()
        for op, (got, plain, exact) in zip("K1 K2 K3 K4".split(), cases):
            for k, (g, p, e) in enumerate(zip(got, plain, exact)):
                dk, dp = tol_dist(g.squeeze(0), e), tol_dist(p, e)
                assert dk <= max(1.0, dp), (op, i, k, dk, dp)


@pytest.mark.parametrize("b", [1025, 2048])
def test_wide_applies_bitwise_across_batches(cuda, b):
    """Past b = 1024 an apply runs a tile as ceil(b / 64) work items, one a
    64-column chunk of C, each on a block of its own: the per-op grid is
    (tiles, chunks).  A tile's result depends on b alone, never on the
    grid: K3 and K4 on a batch of 3 give, tile for tile, the bits of the
    same tiles launched one at a time."""
    assert kernel.lib().qr_chunks(b) == kernel.apply_chunks(b) == -(-b // 64)
    a, c1, c2, r = (rand((3, b, b), b + k, cuda) for k in range(4))
    rv, _, t = ops.geqrf(a)
    _, v2, _, t2 = ops.tsqrf(torch.triu(r), c1)
    q3 = ops.apply_qt(rv, t, c2)
    s3 = ops.apply_tsqt(v2, t2, c1, c2)
    for i in range(3):
        one = slice(i, i + 1)
        q1 = ops.apply_qt(rv[one], t[one], c2[one])
        s1 = ops.apply_tsqt(v2[one], t2[one], c1[one], c2[one])
        torch.cuda.synchronize()
        assert torch.equal(q3[i], q1[0]), i
        assert torch.equal(s3[0][i], s1[0][0]) and torch.equal(s3[1][i],
                                                                s1[1][0]), i


def test_ops_check_operands(cuda):
    with pytest.raises(ValueError, match="float32"):
        ops.apply_qt(*(torch.zeros((8, 8), device=cuda,
                                   dtype=torch.float64),) * 3)
    empty = torch.zeros((0, 0), device=cuda)
    with pytest.raises(ValueError, match="b >= 1"):
        ops.geqrf(empty)
    for b in (128, 1025):              # b > 64 and b > 1024 are taken
        rv, tau, t = ops.geqrf(torch.eye(b, device=cuda))
        torch.cuda.synchronize()
        assert bool(torch.isfinite(rv).all()) and bool((tau == 0).all())
    with pytest.raises(ValueError, match="b <= "):
        ops.geqrf(torch.zeros((kernel.WIDE_MAX_B + 1,) * 2, device=cuda))
    nc = torch.zeros((16, 32), device=cuda)[:, :16]
    with pytest.raises(ValueError, match="contiguous"):
        ops.geqrf(nc)


def test_shared_memory_fits_a_block(cuda):
    """Every kind of tile size takes at most a block's 227 KB of shared
    memory, b = 64's bodies fit two blocks an SM, and the walk keeps a
    block on every SM: each panel width's edges (64 columns to 128, 32 to
    256, 16 to 512, 8 to 1024, 4 to 2048, 2 to 4096, 1 to 8192)."""
    for b in (1, 33, 64, 65, 96, 128, 129, 256, 257, 512, 513, 1000, 1024,
              1025, 2048, 2049, 4096, 4097, kernel.WIDE_MAX_B):
        assert kernel.lib().qr_smem_bytes(b) <= 232448, b
        assert kernel.walk_grid(b) >= torch.cuda.get_device_properties(
            cuda).multi_processor_count, b
    assert 2 * (kernel.lib().qr_smem_bytes(64) + 1024) <= 233472


def modes_bitwise_equal(cuda, n, b):
    """run_qr of a seeded n² matrix at tile b in the four modes on the
    card: bitwise equal, every QR kernel launched, one walk launch a plan,
    no plain version, R valid (Gram and float64 LAPACK up to row signs,
    chip_smoke.py's limits).  Returns (a, the engine's R)."""
    a = np.random.default_rng(1).standard_normal((n, n)).astype(
        np.float32)
    kernel.reset_counts()
    rs = {m: qr.run_qr(a, tile=b, mode=m, nr_queues=4, device=cuda)[0]
          for m in MODES}
    torch.cuda.synchronize()
    assert all(v > 0 for v in kernel.LAUNCHES.values()), kernel.LAUNCHES
    assert kernel.LAUNCHES["qr_walk"] == 1       # the engine's one plan
    assert all(v == 0 for v in kernel.PLAIN_CALLS.values())
    for m in MODES[1:]:
        assert torch.equal(rs[m], rs["sequential"]), m
    r, a64 = rs["engine"].double().cpu().numpy(), a.astype(np.float64)
    assert np.isfinite(r).all() and np.abs(np.tril(r, -1)).max() == 0.0
    gram = np.linalg.norm(r.T @ r - a64.T @ a64) / np.linalg.norm(a64) ** 2
    r64 = np.linalg.qr(a64, mode="r")
    sign = np.sign(np.diag(r)) * np.sign(np.diag(r64))
    lapack = np.linalg.norm(r * sign[:, None] - r64) / np.linalg.norm(r64)
    assert gram < 1e-5 and lapack < 1e-4, (gram, lapack)
    return a, rs["engine"]


@pytest.mark.parametrize("n,b", [(256, 32), (512, 64), (1024, 128),
                                 (1024, 256), (2048, 512), (2050, 1025)])
def test_modes_bitwise_equal_and_match_cpu(cuda, n, b):
    """The four modes bitwise equal on the card (at 1024² / 128² and 256²,
    2048² / 512² and 2050² / 1025² through the blocked bodies: panels of
    64, 32, 16 and 4, the last a column over two warps), one walk launch a
    plan, R valid (Gram and float64 LAPACK up to row signs, chip_smoke.py's
    limits) and close to the plain path on the CPU."""
    a, r_engine = modes_bitwise_equal(cuda, n, b)
    want = qr.run_qr(a, tile=b, mode="engine", device="cpu")[0].numpy()
    assert_allclose(r_engine.cpu().numpy(), want,
                    atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_modes_bitwise_equal_tiles_of_2048(cuda):
    """The four modes at 4096² / 2048² (2 x 2 tiles, panels of 4):
    bitwise equal, one walk launch, R within the Gram and float64 LAPACK
    limits.  The plain path on the CPU is not run: at b = 2048 it takes
    minutes of the card run's time."""
    modes_bitwise_equal(cuda, 4096, 2048)


def test_threaded_workers_launch_on_the_callers_stream(cuda):
    """Worker threads enter the caller's stream, so a run under a side
    stream keeps its dependency order and equals the sequential R."""
    a = np.random.default_rng(2).standard_normal((128, 128)).astype(
        np.float32)
    want, _ = qr.run_qr(a, tile=32, mode="sequential", device=cuda)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got, _ = qr.run_qr(a, tile=32, mode="threaded", nr_queues=4,
                           device=cuda)
    side.synchronize()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


WALK_TOL = 1e-4


def qr_table(n, b):
    mt = n // b
    s, _ = qr.make_qr_graph(mt, mt, nr_queues=4)
    st = qr._TileState({(i, j): torch.empty(0) for i in range(mt)
                        for j in range(mt)})
    return engine.lower_tables(lower(s, 4), s, st.batch_registry(),
                               arg_width=engine.QR_ARG_WIDTH,
                               row_access=engine.qr_row_access)


def qr_stack(n, b, seed, device):
    a = rand((n, n), seed, device)
    mt = n // b
    tiles = torch.stack([a[i * b:(i + 1) * b, j * b:(j + 1) * b]
                         for j in range(mt) for i in range(mt)]).contiguous()
    return tiles, torch.zeros_like(tiles)


def walk_once(tab, init):
    """One engine walk of ``tab`` over a copy of ``init``, as execute_plan
    hands it (desc and offsets uploaded together)."""
    tiles, tmat = (x.clone() for x in init)
    desc, phases = engine.upload_phases(tab.desc, tab.phase_offsets,
                                        tiles.device)
    engine.qr_round_fn(desc, phases, (), (tiles, tmat))
    torch.cuda.synchronize()
    return tiles, tmat


@pytest.mark.parametrize("n,b", [(256, 32), (1024, 16), (2048, 64),
                                 (1024, 128)])
def test_walk_one_launch_matches_plain_walk(cuda, n, b):
    """K5 in one launch against the plain walk, per tile; at 1024²/16² the
    longest phase (1,135 rows) is longer than the resident grid, so blocks
    take a phase's rows in turns; at 1024²/128² the rows run the
    blocked bodies."""
    tab = qr_table(n, b)
    init = qr_stack(n, b, n + b, cuda)
    kernel.reset_counts()
    got = walk_once(tab, init)
    assert kernel.LAUNCHES["qr_walk"] == 1
    assert kernel.PLAIN_CALLS["qr_walk"] == 0
    if (n, b) == (1024, 16):
        assert tab.stats["max_phase_len"] > kernel.walk_grid(b)
    want = tuple(x.clone() for x in init)
    engine.qr_walk_plain(tab.desc, tab.phase_offsets, *want)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        err = (g - w).abs().amax((1, 2)) / w.abs().amax((1, 2)).clamp_min(1)
        assert float(err.max()) <= WALK_TOL


@pytest.mark.parametrize("fault", ["slot", "bounds", "tuple", "copy"])
def test_walk_refuses_bad_tables_on_card(cuda, fault):
    """The card walk checks every call: a slot past the stack or bounds
    past the rows (in the host copy its phases record), phases not made
    by upload_phases, or a desc other than the uploaded one raise before
    the launch, and nothing is written."""
    tab = qr_table(256, 32)
    if fault == "slot":
        tab.desc[len(tab.desc) // 2, 2] = 64       # 64 tiles: 0..63
    bounds = list(tab.phase_offsets)
    if fault == "bounds":
        bounds[-1] += 1
    init = qr_stack(256, 32, 7, cuda)
    tiles, tmat = (x.clone() for x in init)
    desc, phases = engine.upload_phases(tab.desc, bounds, cuda)
    if fault == "tuple":
        phases = tuple(phases)
    if fault == "copy":
        desc = desc.clone()
    kernel.reset_counts()
    with pytest.raises(ValueError):
        engine.qr_round_fn(desc, phases, (), (tiles, tmat))
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["qr_walk"] == 0
    assert torch.equal(tiles, init[0]) and torch.equal(tmat, init[1])


def test_walk_repeats_bitwise(cuda):
    tab = qr_table(512, 64)
    init = qr_stack(512, 64, 5, cuda)
    first, again = walk_once(tab, init), walk_once(tab, init)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_walk_repeats_bitwise_wide_tiles(cuda):
    """The blocked bodies (b = 128) repeat bit for bit too."""
    tab = qr_table(512, 128)
    init = qr_stack(512, 128, 5, cuda)
    first, again = walk_once(tab, init), walk_once(tab, init)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_walk_repeats_bitwise_tiles_of_256(cuda):
    """At b = 256 (panels of 32, eight a tile) as well."""
    tab = qr_table(1024, 256)
    init = qr_stack(1024, 256, 5, cuda)
    first, again = walk_once(tab, init), walk_once(tab, init)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_walk_repeats_bitwise_tiles_of_2048(cuda):
    """At b = 2048 (panels of 4, a column over two warps, its sums taken
    across the warps through shared memory in a fixed order) as well."""
    tab = qr_table(4096, 2048)
    init = qr_stack(4096, 2048, 5, cuda)
    first, again = walk_once(tab, init), walk_once(tab, init)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_walk_noop_table_leaves_state(cuda):
    """A table of QR_NOOP rows (the barrier floor chip_smoke.py times) is
    one launch and touches nothing."""
    tab = qr_table(512, 64)
    tab.desc[:, 0] = engine.QR_NOOP
    init = qr_stack(512, 64, 6, cuda)
    kernel.reset_counts()
    got = walk_once(tab, init)
    assert kernel.LAUNCHES["qr_walk"] == 1
    assert all(torch.equal(x, y) for x, y in zip(got, init))


NB_RTOL, NB_ATOL = 2e-4, 1e-5


def close_vec(got, want, axis):
    """|got - want| <= 2e-4 |want| + 1e-5 for each target's vector (the
    coordinates run along ``axis``)."""
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.isfinite(g).all()
    err = np.linalg.norm(g - w, axis=axis)
    bound = NB_RTOL * np.linalg.norm(w, axis=axis) + NB_ATOL
    assert (err <= bound).all(), float((err / bound).max())


def cloud(n, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.random((3, n)), dtype=torch.float32, device=device)
    m = torch.tensor(rng.random(n) + 0.1, dtype=torch.float32,
                     device=device)
    return x, m


@pytest.mark.parametrize("ni,nj", [(1, 1), (37, 100), (58, 463),
                                   (128, 128), (300, 29)])
def test_nbody_kernels_match_plain_on_card(cuda, ni, nj):
    xi, mi = cloud(ni, ni, cuda)
    xj, mj = cloud(nj, nj + 1, cuda)
    xj[:, :3] = xi[:, :1]              # coincident with a target
    mj[-5:] = 0.0                      # zero masses
    nb_kernel.reset_counts()
    got = nb_ops.acc_pair(xi, xj, mj)
    self_ = nb_ops.acc_self(xi, mi)
    strided = nb_ops.acc_pair(xi[:, : ni // 2 + 1],
                              xj.T.contiguous()[1:].T, mj[1:])
    torch.cuda.synchronize()
    assert nb_kernel.LAUNCHES["acc_pair"] == 2
    assert nb_kernel.LAUNCHES["acc_self"] == 1
    assert all(v == 0 for v in nb_kernel.PLAIN_CALLS.values())
    for g, w in ((got, nb_ref.acc_pair_ref(xi, xj, mj)),
                 (self_, nb_ref.acc_self_ref(xi, mi)),
                 (strided, nb_ref.acc_pair_ref(xi[:, : ni // 2 + 1],
                                               xj[:, 1:], mj[1:]))):
        close_vec(g, w, axis=0)


NB_SIZES = [1, 30, 37, 58, 100, 128, 463, 1000]


@pytest.mark.parametrize("ni", NB_SIZES)
def test_nbody_pair_kernels_every_size_on_card(cuda, ni):
    """K6 at every (Ni, Nj) of NB_SIZES and K7 at Ni, with coincident
    particles and zero masses, against their plain versions; each launch
    again gives the same bits (the slices' partial sums add in a fixed
    order)."""
    xi, mi = cloud(ni, 3 * ni, cuda)
    if ni > 2:
        xi[:, 1] = xi[:, 0]            # two coincident targets
        mi[ni // 2] = 0.0
    got = nb_ops.acc_self(xi, mi)
    assert torch.equal(got, nb_ops.acc_self(xi, mi))
    close_vec(got, nb_ref.acc_self_ref(xi, mi), axis=0)
    for nj in NB_SIZES:
        xj, mj = cloud(nj, 3 * ni + nj, cuda)
        xj[:, : min(3, nj)] = xi[:, :1]          # sources on a target
        mj[nj - nj // 4:] = 0.0                  # a zero-mass tail
        got = nb_ops.acc_pair(xi, xj, mj)
        assert torch.equal(got, nb_ops.acc_pair(xi, xj, mj))
        close_vec(got, nb_ref.acc_pair_ref(xi, xj, mj), axis=0)
    torch.cuda.synchronize()


def test_nbody_pair_kernel_without_sources_is_zero(cuda):
    """The launch floor chip_smoke.py times: Nj = 0 through the binding."""
    xi, _ = cloud(30, 0, cuda)
    empty = torch.empty((3, 0), device=cuda)
    out = torch.full((3, 30), float("nan"), device=cuda)
    nb_kernel.acc_pair(xi, empty, torch.empty(0, device=cuda), 1e-4, out)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def bh_lowered(n, seed, n_max, n_task, device):
    rng = np.random.default_rng(seed)
    x, m = rng.random((n, 3)), rng.random(n) + 0.5
    g = bh.build_graph(bh.Octree(x, m, n_max=n_max), n_task=n_task,
                       nr_queues=4)
    st = bh.BHState(g, device=device)
    plan = lower(g.sched, 4)
    tab = engine.lower_tables(plan, g.sched, st.batch_registry(),
                              arg_width=engine.BH_ARG_WIDTH,
                              row_access=engine.bh_row_access)
    return x, m, st, tab


def walk_on_card(st, tab, lg, cuda):
    """One K8 walk of ``tab`` from fresh buffers: (statics, buffers)."""
    hooks = st.engine_hooks()
    statics = hooks.statics()
    walked = hooks.buffers()
    desc = torch.as_tensor(tab.desc[lg.order], device=cuda)
    hooks.round_fn(desc, lg, statics, walked)
    return statics, walked


def close_real(walked, plain, counts):
    """K8 against the plain walk on every real particle and every COM row;
    the pad particles' accelerations are left as they were (zero)."""
    real = (torch.arange(walked[0].shape[2], device=counts.device)[None, :]
            < counts[:, None])
    acc_w, acc_p = walked[0].permute(0, 2, 1), plain[0].permute(0, 2, 1)
    close_vec(acc_w[real], acc_p[real], axis=1)
    assert not bool(acc_w[~real].any())
    for got, want in zip(walked[1:], plain[1:]):     # com, cmass
        close_vec(got, want, axis=1)


@pytest.mark.parametrize("n,n_max,n_task", [(3000, 48, 192),
                                             (400, 4, 16)])   # P < 8
def test_bh_walk_matches_plain_walk_on_card(cuda, n, n_max, n_task):
    _, _, st, tab = bh_lowered(n, 5, n_max, n_task, cuda)
    lg = engine.launch_groups(tab, engine.bh_row_keys)
    nb_kernel.reset_counts()
    (xs, ms, counts), walked = walk_on_card(st, tab, lg, cuda)
    plain = st.engine_hooks().buffers()
    engine.bh_walk_plain(tab.desc, xs, ms, *plain, st.eps)
    torch.cuda.synchronize()
    assert nb_kernel.LAUNCHES["bh_walk"] <= lg.nr_groups <= tab.nr_rounds
    close_real(walked, plain, counts)


def test_bh_walk_skips_pad_sources_at_20k(cuda):
    """K8 at 20k particles (n_max 64: blocks of P slots, leaves of fewer
    real particles), which walks only each leaf's real sources and
    targets, against the plain walk over the padded blocks; two walks
    bitwise equal."""
    _, _, st, tab = bh_lowered(20000, 7, 64, 256, cuda)
    lg = engine.launch_groups(tab, engine.bh_row_keys)
    (xs, ms, counts), walked = walk_on_card(st, tab, lg, cuda)
    _, again = walk_on_card(st, tab, lg, cuda)
    plain = st.engine_hooks().buffers()
    engine.bh_walk_plain(tab.desc, xs, ms, *plain, st.eps)
    torch.cuda.synchronize()
    assert int(counts.sum()) == 20000 and int(counts.max()) == xs.shape[2]
    assert bool((counts < xs.shape[2]).any())
    for got, twice in zip(walked, again):
        assert torch.equal(got, twice)
    close_real(walked, plain, counts)


def rel_err(a, want):
    a, want = a.double().cpu().numpy(), want.double().cpu().numpy()
    num = np.linalg.norm(a - want, axis=0)
    return num / np.maximum(np.linalg.norm(want, axis=0), 1e-12)


def test_bh_modes_agree_on_card_and_with_cpu(cuda):
    rng = np.random.default_rng(2)
    x, m = rng.random((2000, 3)), rng.random(2000) + 0.5
    nb_kernel.reset_counts()
    accs = {md: bh.solve(x, m, n_max=32, n_task=128, mode=md,
                         nr_workers=4, device=cuda)[0] for md in MODES}
    torch.cuda.synchronize()
    assert all(v > 0 for v in nb_kernel.LAUNCHES.values())
    assert all(v == 0 for v in nb_kernel.PLAIN_CALLS.values())
    cpu = bh.solve(x, m, n_max=32, n_task=128, mode="engine",
                   device="cpu")[0]
    for md in MODES:
        assert rel_err(accs[md], accs["sequential"]).max() < 1e-4, md
        assert rel_err(accs[md], cpu).max() < 1e-4, md


def test_bh_walk_launches_per_plan_within_rounds(cuda):
    x, m, _, tab = bh_lowered(20000, 7, 64, 256, cuda)
    nb_kernel.reset_counts()
    bh.solve(x, m, n_max=64, n_task=256, mode="engine", nr_workers=4,
             device=cuda)
    torch.cuda.synchronize()
    assert 1 <= nb_kernel.LAUNCHES["bh_walk"] <= tab.nr_rounds


# --- K10: paged GQA decode ---------------------------------------------------
# fp32: the reference's kernel-vs-oracle tolerance
# (tests/test_paged_properties.py: atol 1e-5, rtol 1e-5).  bf16: kernel and
# plain version compute in float from the same bf16 operands and each
# rounds its output to bf16 once, so they may differ by one bf16 ulp,
# 2^-7 of the value at most.
PAGED_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}
PAGED_SHAPES = [(4, 2, 32, 8, torch.float32),        # qwen3-1.7b reduced
                (16, 8, 128, 8, torch.float32),      # qwen3-1.7b as published
                (16, 8, 128, 16, torch.float32),
                (16, 8, 128, 8, torch.bfloat16),
                (16, 8, 128, 16, torch.bfloat16),
                (36, 4, 128, 8, torch.float32),      # starcoder2-7b: H/Hkv 9
                (36, 4, 128, 16, torch.bfloat16),
                (32, 8, 128, 8, torch.float32),      # granite-8b: H/Hkv 4
                (32, 8, 128, 16, torch.bfloat16),
                (24, 8, 128, 8, torch.float32),      # phi4-mini-3.8b: 3
                (24, 8, 128, 16, torch.bfloat16),
                (64, 8, 128, 8, torch.float32),      # kimi-k2-1t-a32b: 8
                (64, 8, 128, 16, torch.bfloat16),
                (32, 2, 128, 8, torch.bfloat16),     # n_rep 16
                (8, 2, 20, 8, torch.bfloat16)]       # rows not on 16 bytes




def paged_check(operands, rows, pos, ps):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    q = operands[0]
    plain = [x.clone() for x in operands]
    n0 = pa_ops.LAUNCHES["paged_gqa"]
    o, kp, vp = pa_ops.paged_gqa_decode(*operands, page_size=ps)
    torch.cuda.synchronize()
    assert pa_ops.LAUNCHES["paged_gqa"] == n0 + 1
    ro, rk, rv = pa_ref.paged_gqa_decode_ref(*plain, page_size=ps)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert torch.isfinite(o).all(), "the kernel read a poisoned position"
    assert_allclose(o.float().cpu().numpy(), ro.float().cpu().numpy(),
                    **PAGED_TOL[q.dtype])
    for got, want in ((kp, rk), (vp, rv)):     # the walked pages, bitwise
        for t in range(len(pos)):
            pages = torch.as_tensor(rows[t, :pos[t] // ps + 1])
            assert torch.equal(got[pages].isnan(), want[pages].isnan())
            assert torch.equal(got[pages].nan_to_num(), want[pages].nan_to_num())


@pytest.mark.parametrize("bs", [1, 3, 8])
@pytest.mark.parametrize("n_heads,n_kv,hd,ps,dtype", PAGED_SHAPES)
def test_paged_gqa_kernel_matches_plain_on_card(cuda, bs, n_heads, n_kv, hd,
                                                ps, dtype):
    ops_, rows, pos = pa_ref.random_case(bs, ps, dtype, bs, cuda,
                                         n_heads=n_heads, n_kv=n_kv, hd=hd)
    paged_check(ops_, rows, pos, ps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_gqa_kernel_matches_plain_at_serving_depth(cuda, dtype):
    """Workload (b) of chip_smoke.py's serving phase: 8 slots of 40 pages
    at positions spread over 256-319 (288 among them), up to 40 pages
    walked a slot, at the heads of every GQA model served on K10: qwen3-1.7b,
    starcoder2-7b, granite-8b, phi4-mini-3.8b and kimi-k2-1t-a32b."""
    pos = [256, 263, 264, 277, 288, 300, 311, 319]
    for n_heads, n_kv in ((16, 8), (36, 4), (32, 8), (24, 8), (64, 8)):
        ops_, rows, p = pa_ref.random_case(8, 8, dtype, 21, cuda,
                                           max_pages=40, pos=pos,
                                           n_heads=n_heads, n_kv=n_kv, hd=128)
        paged_check(ops_, rows, p, 8)


def test_paged_gqa_kernel_repeats_bitwise(cuda):
    """The split walk merges its partials in a fixed order, with no float
    atomics: two launches on the same inputs give the same bits."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    pos = [256, 263, 264, 277, 288, 300, 311, 319]
    ops_, _, _ = pa_ref.random_case(8, 8, torch.bfloat16, 21, cuda,
                                    max_pages=40, pos=pos, n_heads=36,
                                    n_kv=4, hd=128)
    a, b = (pa_ops.paged_gqa_decode(*[x.clone() for x in ops_],
                                    page_size=8)[0] for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_gqa_kernel_skips_stale_nonfinite_tail(cuda, dtype):
    """Unlisted pages are NaN and every slot's last page holds +inf keys
    and NaN values after pos: the result stays finite and equal to the
    plain version, at pos 0, ps - 1, ps and mid-page."""
    ps = 8
    ops_, rows, pos = pa_ref.random_case(4, ps, dtype, 11, cuda,
                                         stale_tail=True,
                                         pos=[0, ps - 1, ps, 13], n_heads=16,
                                         n_kv=8, hd=128)
    paged_check(ops_, rows, pos, ps)


def test_paged_gqa_kernel_leaves_other_slots_pages_bitwise(cuda):
    """A launch for slot 0 alone writes one cell of its own page and
    nothing of slot 1's pages (or any other byte of the pools)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    ps = 8
    ops_, rows, pos = pa_ref.random_case(2, ps, torch.bfloat16, 5, cuda,
                                         pos=[12, 20], n_heads=16, n_kv=8,
                                         hd=128)
    q, kn, vn, kp, vp, pr, po = ops_
    k0, v0 = kp.clone(), vp.clone()
    pa_ops.paged_gqa_decode(q[:1].contiguous(), kn[:1].contiguous(),
                            vn[:1].contiguous(), kp, vp, pr[:1].contiguous(),
                            po[:1].contiguous(), page_size=ps)
    torch.cuda.synchronize()
    cell = (int(rows[0, pos[0] // ps]), int(pos[0] % ps))
    for pool, before, new in ((kp, k0, kn), (vp, v0, vn)):
        assert torch.equal(pool[cell], new[0])
        pool[cell] = before[cell]
        assert torch.equal(pool.isnan(), before.isnan())
        assert torch.equal(pool.nan_to_num(), before.nan_to_num())


def test_paged_gqa_kernel_out_of_range_gives_nan(cuda):
    """A position past the row makes the slot's output NaN (the guard's
    signal) and writes nothing."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    ps = 8
    ops_, rows, pos = pa_ref.random_case(2, ps, torch.float32, 9, cuda,
                                         pos=[3, 9], n_heads=4, n_kv=2, hd=32)
    q, kn, vn, kp, vp, pr, po = ops_
    po[1] = pr.shape[1] * ps
    k0 = kp.clone()
    o, _, _ = pa_ops.paged_gqa_decode(q, kn, vn, kp, vp, pr, po,
                                      page_size=ps)
    torch.cuda.synchronize()
    assert torch.isfinite(o[0]).all() and torch.isnan(o[1]).all()
    changed = ~((kp == k0) | (kp.isnan() & k0.isnan()))
    assert int(changed.sum()) == 2 * 32      # slot 0's cell: Hkv x hd


def test_paged_gqa_kernel_bad_page_id_writes_nothing(cuda):
    """A page id outside the pool among the pages a slot walks (here its
    first, not the page of the new cell) makes that slot's output NaN and
    writes no cell of it: every listed id is checked before the write."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    ps = 8
    ops_, rows, pos = pa_ref.random_case(2, ps, torch.float32, 9, cuda,
                                         pos=[3, 20], n_heads=4, n_kv=2, hd=32)
    q, kn, vn, kp, vp, pr, po = ops_
    pr[1, 0] = kp.shape[0]
    k0 = kp.clone()
    o, _, _ = pa_ops.paged_gqa_decode(q, kn, vn, kp, vp, pr, po,
                                      page_size=ps)
    torch.cuda.synchronize()
    assert torch.isfinite(o[0]).all() and torch.isnan(o[1]).all()
    changed = ~((kp == k0) | (kp.isnan() & k0.isnan()))
    assert int(changed.sum()) == 2 * 32      # slot 0's cell: Hkv x hd


def _card_service(cuda, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import GenerateService
    cfg = get_config("qwen3-1.7b").reduced()
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    return GenerateService(params, cfg, max_batch=2, max_seq=32,
                           page_size=8, device=cuda, **kw)


def test_service_on_card_takes_k10_and_raises_on_its_fault(cuda):
    """On the card "auto" is the K10 path; a page id out of the pool makes
    K10 write NaN, and the service raises rather than recompute the slot
    on the plain path."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.serve import KernelFault
    svc = _card_service(cuda)
    assert svc.decode_path == "kernel"
    for i in range(2):
        svc.submit(np.arange(8, dtype=np.int32) + i, 8)
    pa_ops.reset_counts()
    svc.step()                      # admission, prefill and one decode tick
    assert pa_ops.LAUNCHES["paged_gqa"] == svc.cfg.n_layers
    assert pa_ops.PLAIN_CALLS["paged_gqa"] == 0
    svc._pt[1, 0] = svc.pool.n_pages
    with pytest.raises(KernelFault) as err:
        svc.step()
    assert err.value.slots == [1]
    assert svc.stats["retries"] == 0


def test_service_on_card_injected_fault_walks_the_ladder(cuda):
    """An injected NaN is the chaos harness's, not the kernel's: the slot
    is retried on the gather path and the tick degrades, with a warning."""
    from repro_torch.serve import FaultEvent, FaultPlan
    svc = _card_service(cuda, faults=FaultPlan(
        [FaultEvent(tick=1, kind="nan_decode", victim=0)]))
    hs = [svc.submit(np.arange(8, dtype=np.int32) + i, 8) for i in range(2)]
    with pytest.warns(RuntimeWarning, match="degraded"):
        svc.run_until_complete()
    assert svc.stats["retries"] == 1
    assert all(h.status == "done" and len(h.generated) == 8 for h in hs)


def test_paged_gqa_ops_check_operands(cuda):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    ops_, _, _ = pa_ref.random_case(1, 8, torch.float32, 1, cuda, n_heads=4,
                                    n_kv=2, hd=32)
    bad = list(ops_)
    bad[3] = bad[3].to(torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        pa_ops.paged_gqa_decode(*bad, page_size=8)
    bad = list(ops_)
    bad[5] = bad[5].long()
    with pytest.raises(ValueError, match="int32"):
        pa_ops.paged_gqa_decode(*bad, page_size=8)
    with pytest.raises(ValueError, match="shapes"):
        pa_ops.paged_gqa_decode(*ops_, page_size=4)


# --- K11: paged MLA decode ---------------------------------------------------

# (H, lat, rope, page, dtype, scale): deepseek-v3-671b --reduced, the
# reference property test's widths, and the published widths
MLA_SHAPES = [(4, 32, 16, 8, torch.float32, 48 ** -0.5),
              (4, 16, 8, 16, torch.bfloat16, 24 ** -0.5),
              (128, 512, 64, 8, torch.float32, 192 ** -0.5),
              (128, 512, 64, 16, torch.bfloat16, 192 ** -0.5)]




def mla_check(operands, rows, pos, ps, scale):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    q = operands[0]
    plain = [x.clone() for x in operands]
    n0 = pa_ops.LAUNCHES["paged_mla"]
    ctx, cp, rp = pa_ops.paged_mla_decode(*operands, page_size=ps,
                                          scale=scale)
    torch.cuda.synchronize()
    assert pa_ops.LAUNCHES["paged_mla"] == n0 + 1
    rc, rcp, rrp = pa_ref.paged_mla_decode_ref(*plain, page_size=ps,
                                               scale=scale)
    assert ctx.dtype == q.dtype and ctx.shape == q.shape
    assert torch.isfinite(ctx).all(), "the kernel read a poisoned position"
    assert_allclose(ctx.float().cpu().numpy(), rc.float().cpu().numpy(),
                    **PAGED_TOL[q.dtype])
    for got, want in ((cp, rcp), (rp, rrp)):   # the walked pages, bitwise
        for t in range(len(pos)):
            pages = torch.as_tensor(rows[t, :pos[t] // ps + 1])
            assert torch.equal(got[pages].isnan(), want[pages].isnan())
            assert torch.equal(got[pages].nan_to_num(),
                               want[pages].nan_to_num())


@pytest.mark.parametrize("bs", [1, 3, 8])
@pytest.mark.parametrize("n_heads,lat,rope,ps,dtype,scale", MLA_SHAPES)
def test_paged_mla_kernel_matches_plain_on_card(cuda, bs, n_heads, lat, rope,
                                                ps, dtype, scale):
    ops_, rows, pos = pa_ref.random_case(bs, ps, dtype, bs, cuda, mla=True,
                                         n_heads=n_heads, lat=lat, rope=rope)
    mla_check(ops_, rows, pos, ps, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_mla_kernel_matches_plain_at_serving_depth(cuda, dtype, ps):
    """Workload (b) of chip_smoke.py's deepseek phase at full width: 8
    slots of 320 positions at positions spread over 256-319, with stale
    non-finite tails after each slot's position."""
    pos = [256, 263, 264, 277, 288, 300, 311, 319]
    ops_, rows, pos = pa_ref.random_case(8, ps, dtype, 21, cuda, mla=True,
                                         max_pages=320 // ps, pos=pos,
                                         stale_tail=True, n_heads=128, lat=512,
                                         rope=64)
    mla_check(ops_, rows, pos, ps, 192 ** -0.5)


# bf16 through the tensor-core kernel: every width chip_smoke.py's
# MLA_SHAPES holds (deepseek-v3-671b --reduced, the reference property
# test's, the published), each at page 8 and 16, and widths off the
# kernel's tiles: H 6 / lat 40 / rope 12 (rope not on 16 bytes: element
# loads) and H 3 / lat 20 / rope 4
MLA_BF16_SHAPES = [(4, 32, 16, 48 ** -0.5), (4, 16, 8, 24 ** -0.5),
                   (128, 512, 64, 192 ** -0.5), (6, 40, 12, 0.1),
                   (3, 20, 4, 0.2)]


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("n_heads,lat,rope,scale", MLA_BF16_SHAPES)
def test_paged_mla_bf16_kernel_every_width_on_card(cuda, n_heads, lat, rope,
                                                   scale, ps):
    """K11 bf16 at bs 1, 3 and 8 against its plain version (unwalked pages
    NaN: only listed pages are read); two launches bitwise equal."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    for bs in (1, 3, 8):
        ops_, rows, pos = pa_ref.random_case(bs, ps, torch.bfloat16, bs + 40,
                                             cuda, mla=True, n_heads=n_heads,
                                             lat=lat, rope=rope)
        again = [x.clone() for x in ops_]
        mla_check(ops_, rows, pos, ps, scale)
        first = pa_ops.paged_mla_decode(*[x.clone() for x in again],
                                        page_size=ps, scale=scale)[0]
        second = pa_ops.paged_mla_decode(*again, page_size=ps,
                                         scale=scale)[0]
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_paged_mla_bf16_kernel_at_the_timed_shape(cuda):
    """deepseek-v3-671b's published widths at 8 slots x 37 pages (position
    288 of 320, workload (b)'s middle, chip_smoke.py's timed shape):
    against the plain version, two launches bitwise equal, and a launch
    for slot 0 alone leaves every other cell of both pools as it was."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    scale = 192 ** -0.5
    ops_, rows, pos = pa_ref.random_case(8, 8, torch.bfloat16, 31, cuda,
                                         mla=True, max_pages=40,
                                         pos=[288] * 8, n_heads=128, lat=512,
                                         rope=64)
    again = [x.clone() for x in ops_]
    mla_check(ops_, rows, pos, 8, scale)
    a = pa_ops.paged_mla_decode(*[x.clone() for x in again], page_size=8,
                                scale=scale)[0]
    b = pa_ops.paged_mla_decode(*[x.clone() for x in again], page_size=8,
                                scale=scale)[0]
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    qe, qr_, cn, rn, cp, rp, pr, po = again
    c0, r0 = cp.clone(), rp.clone()
    pa_ops.paged_mla_decode(qe[:1].contiguous(), qr_[:1].contiguous(),
                            cn[:1].contiguous(), rn[:1].contiguous(), cp, rp,
                            pr[:1].contiguous(), po[:1].contiguous(),
                            page_size=8, scale=scale)
    torch.cuda.synchronize()
    cell = (int(rows[0, 288 // 8]), 288 % 8)
    for pool, old, new in ((cp, c0, cn), (rp, r0, rn)):
        assert torch.equal(pool[cell], new[0])
        pool[cell] = old[cell]
        assert torch.equal(pool.isnan(), old.isnan())
        assert torch.equal(pool.nan_to_num(), old.nan_to_num())


def test_paged_mla_kernel_bad_page_id_writes_nothing(cuda):
    """A page id outside the pool among a slot's walked pages gives NaN
    for that slot's heads and writes neither of its cells."""
    mla_bad_page(cuda, torch.float32)


def test_paged_mla_bf16_kernel_bad_page_id_writes_nothing(cuda):
    """The same through the bf16 tensor-core kernel (split walk)."""
    mla_bad_page(cuda, torch.bfloat16)


def mla_bad_page(cuda, dtype):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    ops_, rows, pos = pa_ref.random_case(2, 8, dtype, 9, cuda,
                                         mla=True, pos=[3, 20], n_heads=128,
                                         lat=512, rope=64)
    qe, qr, cn, rn, cp, rp, pr, po = ops_
    pr[1, 0] = cp.shape[0]
    c0, r0 = cp.clone(), rp.clone()
    ctx, _, _ = pa_ops.paged_mla_decode(qe, qr, cn, rn, cp, rp, pr, po,
                                        page_size=8, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(ctx[0]).all() and torch.isnan(ctx[1]).all()
    cell = (int(rows[0, pos[0] // 8]), int(pos[0] % 8))
    for pool, old, new, width in ((cp, c0, cn, 512), (rp, r0, rn, 64)):
        changed = ~((pool == old) | (pool.isnan() & old.isnan()))
        if dtype == torch.float32:   # bf16: a new value may equal the old
            assert int(changed.sum()) == width  # slot 0's cell only
        assert torch.equal(pool[cell], new[0])  # slot 0's cell written ...
        pool[cell] = old[cell]                  # ... and nothing else
        assert torch.equal(pool.isnan(), old.isnan())
        assert torch.equal(pool.nan_to_num(), old.nan_to_num())


def test_paged_mla_ops_check_operands(cuda):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    ops_, _, _ = pa_ref.random_case(1, 8, torch.float32, 1, cuda, mla=True,
                                    n_heads=4, lat=32, rope=16)
    bad = list(ops_)
    bad[4] = bad[4].to(torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        pa_ops.paged_mla_decode(*bad, page_size=8, scale=0.1)
    with pytest.raises(ValueError, match="shapes"):
        pa_ops.paged_mla_decode(*ops_, page_size=4, scale=0.1)
    wide = pa_ref.random_case(1, 8, torch.float32, 1, cuda, mla=True,
                              n_heads=4, lat=544, rope=16)[0]
    with pytest.raises(ValueError, match="latent width up to 512"):
        pa_ops.paged_mla_decode(*wide, page_size=8, scale=0.1)


def test_deepseek_service_on_card_takes_k11_and_raises_on_its_fault(cuda):
    """deepseek-v3-671b --reduced on the card: "auto" is the kernel path,
    each tick launches K11 once a layer and no plain version; a bad page id
    makes K11 write NaN and the service raises KernelFault."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import lm
    from repro_torch.serve import GenerateService, KernelFault
    cfg = get_config("deepseek-v3-671b").reduced()
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    svc = GenerateService(params, cfg, max_batch=2, max_seq=32, page_size=8,
                          device=cuda)
    assert svc.decode_path == "kernel"
    for i in range(2):
        svc.submit(np.arange(8, dtype=np.int32) + i, 8)
    pa_ops.reset_counts()
    svc.step()                      # admission, prefill and one decode tick
    assert pa_ops.LAUNCHES == {"paged_gqa": 0, "paged_mla": cfg.n_layers}
    assert not any(pa_ops.PLAIN_CALLS.values())
    svc._pt[1, 0] = svc.pool.n_pages
    with pytest.raises(KernelFault) as err:
        svc.step()
    assert err.value.slots == [1]
    assert svc.stats["retries"] == 0


# ---------------------------------------------------------------------------
# the pipeline walk (K9) and flash attention (K12)
# ---------------------------------------------------------------------------

PIPE_TOL = dict(rtol=1e-5, atol=1e-6)


def pipe_case(S, M, Bt, D, seed, device):
    from repro_torch import pipeline as pipe
    rng = np.random.default_rng(seed)
    params = [{"w": rng.standard_normal((D, D)) / np.sqrt(D),
               "b": rng.standard_normal(D) * 0.1} for _ in range(S)]
    micro = [{"x": rng.standard_normal((Bt, D)),
              "y": rng.standard_normal((Bt, D))} for _ in range(M)]
    return pipe.pipeline_inputs(params, micro, device=device)


def pipe_walk_state(S, M, Bt, D, seed, device):
    from repro_torch.pipeline import exec as pexec
    from repro_torch.pipeline import lower_pipeline_plan
    params, micro = pipe_case(S, M, Bt, D, seed, device)
    sched, _, plan = lower_pipeline_plan(S, M, per_stage_window=True)
    reg = pexec._PipeRunner([pexec.dense_stage] * S, pexec.mse_loss,
                            params, micro).registry()
    tab = engine.lower_tables(plan, sched, reg,
                              arg_width=engine.PIPE_ARG_WIDTH,
                              row_access=engine.pipe_row_access)
    hooks = pexec._engine_hooks(params, micro, (S, M, Bt, D), {}, device)
    return tab, hooks.statics(), hooks.buffers


@pytest.mark.parametrize("S,M,Bt,D", [(3, 6, 4, 8), (8, 64, 4, 32),
                                      (1, 3, 4, 40), (3, 1, 1, 100),
                                      (2, 4, 33, 65)])
def test_pipe_walk_matches_plain_walk_on_card(cuda, S, M, Bt, D):
    from repro_torch.kernels.pipe_walk import kernel as pw_kernel
    tab, statics, fresh = pipe_walk_state(S, M, Bt, D, S + M + D, cuda)
    desc = torch.as_tensor(tab.desc, device=cuda)
    bounds = tuple(int(b) for b in tab.phase_offsets)
    runs = []
    for _ in range(2):
        pw_kernel.reset_counts()
        bufs = fresh()
        engine.pipe_round_fn(1.0 / M)(desc, bounds, statics, bufs)
        torch.cuda.synchronize()
        assert pw_kernel.LAUNCHES["pipe_walk"] == \
            engine.PIPE_LAUNCHES_PER_PLAN == 1
        assert pw_kernel.PLAIN_CALLS["pipe_walk"] == 0
        runs.append(bufs)
    plain = fresh()
    engine.pipe_walk_plain(tab.desc, bounds, statics, plain, 1.0 / M)
    for got, again, want in zip(runs[0], runs[1], plain):
        assert torch.equal(got, again)
        assert bool(torch.isfinite(got).all())
        assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **PIPE_TOL)


# K9 vs its plain walk where the F and cot_in reductions split (D > 512:
# 2 splits, the last ragged) and Bt spans row tiles (40, 65): each buffer
# by norm, as chip_smoke.py holds the full width (elementwise, acts near 0
# differ by ~1e-6 from the other summation order); the plain walk under
# TF32 reads 2.8e-4 and more there on an H100
K9_REL_TOL = 1e-5


@pytest.mark.parametrize("S,M,Bt,D", [(2, 3, 40, 600), (3, 2, 65, 513)])
def test_pipe_walk_split_tiles_match_plain_walk_on_card(cuda, S, M, Bt, D):
    tab, statics, fresh = pipe_walk_state(S, M, Bt, D, S + M + D, cuda)
    desc = torch.as_tensor(tab.desc, device=cuda)
    bounds = tuple(int(b) for b in tab.phase_offsets)
    runs = []
    for _ in range(2):
        bufs = fresh()
        engine.pipe_round_fn(1.0 / M)(desc, bounds, statics, bufs)
        runs.append(bufs)

    def plain():
        bufs = fresh()
        engine.pipe_walk_plain(tab.desc, bounds, statics, bufs, 1.0 / M)
        return bufs

    def rel(got, want):
        return max(float((g.double() - w.double()).norm()
                         / w.double().norm()) for g, w in zip(got, want))

    want = plain()
    for got, again in zip(*runs):
        assert torch.equal(got, again)
    assert rel(runs[0], want) <= K9_REL_TOL
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = plain()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert rel(control, want) > K9_REL_TOL


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_modes_on_card_match_float64_autograd(cuda, mode):
    from repro_torch import pipeline as pipe
    S, M, Bt, D = 3, 6, 4, 8
    params, micro = pipe_case(S, M, Bt, D, 2, cuda)
    loss, grads = pipe.pipelined_value_and_grad_plan(
        [pipe.dense_stage] * S, pipe.mse_loss, params, micro, mode=mode)
    ps = [{k: v.double().requires_grad_() for k, v in p.items()}
          for p in params]
    total = 0.0
    for mb in micro:
        h = mb["x"].double()
        for p in ps:
            h = torch.tanh(h @ p["w"] + p["b"])
        total = total + torch.mean((h - mb["y"].double()) ** 2)
    total = total / M
    total.backward()
    assert loss.device.type == "cuda"
    assert abs(float(loss) - float(total.detach())) < 1e-6
    for g, p in zip(grads, ps):
        for k in ("w", "b"):
            assert_allclose(g[k].double().cpu().numpy(),
                            p[k].grad.cpu().numpy(), **PIPE_TOL)


FA_CASES = [(4, 128, 64, 64, 64), (4, 256, 64, 128, 64),
            (4, 512, 64, 128, 128), (2, 128, 32, 64, 128),
            (2, 256, 16, 64, 64), (1, 256, 128, 128, 128),
            (2, 192, 112, 32, 96), (1, 256, 256, 128, 64),
            (2, 288, 112, 96, 32)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,hd,bq,bk", FA_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, bh, s, hd, bq, bk, dtype,
                                            causal):
    from repro_torch.kernels.flash_attention import kernel as fa, ref as far
    g = torch.Generator(device=cuda).manual_seed(s + hd)
    q, k, v = (torch.randn(bh, s, hd, generator=g, device=cuda) * 0.5
               for _ in range(3))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    fa.reset_counts()
    got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    assert fa.PLAIN_CALLS["flash_attention"] == 0
    want = far.attention_ref(q, k, v, causal=causal)
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=2e-5, rtol=1e-4))
    assert got.dtype == dtype
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    **tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [257, 320, 512])
def test_flash_kernel_takes_wide_heads_on_card(cuda, hd, dtype, causal):
    """hd > 256 (the chunked path), Sq != Sk, at the existing limits."""
    from repro_torch.kernels.flash_attention import kernel as fa, ref as far
    g = torch.Generator(device=cuda).manual_seed(hd)
    q = (torch.randn(2, 192, hd, generator=g, device=cuda) * 0.5).to(dtype)
    k, v = ((torch.randn(2, 128, hd, generator=g, device=cuda) * 0.5)
            .to(dtype) for _ in range(2))
    fa.reset_counts()
    got = fa.flash_attention(q, k, v, causal=causal, block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    want = far.attention_ref(q, k, v, causal=causal)
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=2e-5, rtol=1e-4))
    assert got.dtype == dtype
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    **tol)


def test_flash_op_on_card_pads_and_sums_to_one(cuda):
    from repro_torch.kernels.flash_attention import kernel as fa, ops as fops
    from repro_torch.kernels.flash_attention import ref as far
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 100, 3, 32, generator=g, device=cuda) * 0.5
               for _ in range(3))
    got = fops.flash_attention_bshd(q, k, v, block_q=64, block_k=64)
    want = fops.attention_ref_bshd(q, k, v)
    assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5,
                    rtol=1e-4)
    ones = fa.flash_attention(q[0].transpose(0, 1)[:, :64].contiguous(),
                              k[0].transpose(0, 1)[:, :64].contiguous(),
                              torch.ones(3, 64, 32, device=cuda),
                              block_q=64, block_k=64)
    assert_allclose(ones.cpu().numpy(), np.ones((3, 64, 32)), atol=1e-5)
    # hd 48 is built at 64 with the columns past 48 zero
    q48, k48, v48 = (torch.randn(2, 64, 48, generator=g, device=cuda) * 0.5
                     for _ in range(3))
    got = fa.flash_attention(q48, k48, v48, block_q=64, block_k=64)
    assert_allclose(got.cpu().numpy(),
                    far.attention_ref(q48, k48, v48).cpu().numpy(),
                    atol=2e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(*(torch.zeros(1, 64, 32, device=cuda,
                                         dtype=torch.float16)
                             for _ in range(3)), block_q=64, block_k=64)


# --- training (slice 6): no kernel on this path; card against CPU ------------

TRAIN_ARCHS = {"qwen3-1.7b": {}, "deepseek-v3-671b": {"capacity_factor": 8.0}}
TRAIN_KW = dict(optimizer="adamw", lr=1e-2, warmup=1, total_steps=10)


def _train_cfg(arch):
    from repro_torch.configs import get_config
    return get_config(arch).reduced(**TRAIN_ARCHS[arch])


def _named(tree):
    from repro_torch.optim.tree import flatten_with_path
    return {"/".join(map(str, p)): t.cpu() for p, t in flatten_with_path(tree)}


def _one_step(cfg, params0, tokens, dev):
    from repro_torch.optim.tree import tree_map
    from repro_torch.models import lm
    from repro_torch.trainer import steps
    params = tree_map(lambda t: t.to(dev, copy=True), params0)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    batch.update(lm.stub_inputs(cfg, tokens.shape[0], dev))
    _, _, grads = steps.loss_and_grads(params, cfg, batch)
    step, init = steps.make_train_step(cfg, **TRAIN_KW)
    params, opt, metrics = step(params, init(params), batch)
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            _named(grads), _named(params), _named(opt.inner))


@pytest.mark.parametrize("arch", list(TRAIN_ARCHS))
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One fp32 step (TF32 off) on the card against the same step on the
    CPU: loss, grad norm and every gradient leaf within the reference's
    kernel-test tolerance, the moments everywhere and the parameters where
    the clipped |g| exceeds its atol."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import lm
    assert torch.backends.cuda.matmul.allow_tf32 is False
    cfg = _train_cfg(arch)
    params0 = lm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = SyntheticTokens(cfg.vocab, 32, 2, seed=0).batch_at(0)["tokens"]
    got = _one_step(cfg, params0, tokens, cuda)
    want = _one_step(cfg, params0, tokens, torch.device("cpu"))
    assert_allclose(got[0], want[0], **TOL)
    assert_allclose(got[1], want[1], **TOL)
    scale = min(1.0, 1.0 / want[1])
    for name, g in want[2].items():
        assert_allclose(got[2][name].numpy(), g.numpy(), err_msg=name, **TOL)
        big = (g * scale).abs() > TOL["atol"]
        assert_allclose(got[3][name][big].numpy(), want[3][name][big].numpy(),
                        err_msg=name, **TOL)
    for name, m in want[4].items():
        assert_allclose(got[4][name].numpy(), m.numpy(), err_msg=name, **TOL)


def _drill(cfg, tmp_path, cuda):
    from repro_torch.trainer import loop
    common = dict(steps=20, seq_len=32, global_batch=4, ckpt_every=5,
                  log_every=100, log_fn=lambda s: None, device=cuda)
    pa, oa, hist_a = loop.run_training(cfg, str(tmp_path / "a"), **common)
    with pytest.raises(loop.InjectedFailure):
        loop.run_training(cfg, str(tmp_path / "b"), fail_at_step=12,
                          **common)
    pb, ob, hist_b = loop.run_training(cfg, str(tmp_path / "b"), **common)
    assert [s for s, _ in hist_b] == list(range(10, 20))
    return (pa, oa, hist_a), (pb, ob, hist_b)


@pytest.mark.parametrize("arch", list(TRAIN_ARCHS))
def test_training_resumes_bitwise_on_card(cuda, arch, tmp_path, monkeypatch):
    """The kill-and-resume drill on the card: losses, parameters and
    moments bit for bit those of the uninterrupted run, under deterministic
    algorithms that the loop turns on and restores."""
    from repro_torch.optim.tree import leaves
    from repro_torch.trainer import steps
    seen = []
    real = steps.loss_and_grads

    def spy(*a, **k):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return real(*a, **k)

    monkeypatch.setattr(steps, "loss_and_grads", spy)
    before = torch.are_deterministic_algorithms_enabled()
    (pa, oa, hist_a), (pb, ob, hist_b) = _drill(_train_cfg(arch), tmp_path,
                                                cuda)
    assert seen and all(seen)
    assert torch.are_deterministic_algorithms_enabled() == before
    tail_a = dict(hist_a)
    assert all(tail_a[s] == l for s, l in hist_b)
    assert all(t.device.type == "cuda" for t in leaves((pa, oa, pb, ob)))
    assert all(torch.equal(x, y)
               for x, y in zip(leaves((pa, oa)), leaves((pb, ob))))


@pytest.mark.parametrize("arch", list(TRAIN_ARCHS))
def test_training_drill_without_deterministic_mode(cuda, arch, tmp_path,
                                                   monkeypatch):
    """Context, not a check: the same drill with deterministic algorithms
    left off may differ (atomics in the embedding and MoE backward passes);
    it prints how far."""
    import contextlib
    from repro_torch.optim.tree import leaves
    from repro_torch.trainer import loop
    monkeypatch.setattr(loop, "deterministic",
                        lambda dev: contextlib.nullcontext())
    (pa, oa, hist_a), (pb, ob, hist_b) = _drill(_train_cfg(arch), tmp_path,
                                                cuda)
    tail_a = dict(hist_a)
    assert all(np.isfinite(l) for _, l in hist_a + hist_b)
    gaps = [abs(tail_a[s] - l) for s, l in hist_b]
    unequal = sum(not torch.equal(x, y)
                  for x, y in zip(leaves((pa, oa)), leaves((pb, ob))))
    print(f"{arch} without deterministic algorithms: max loss gap "
          f"{max(gaps):.3e}, {unequal} of {len(leaves((pa, oa)))} leaves "
          f"differ")


# --- measured round times and the SSM family on the card ------------------------

def test_measure_round_times_on_card(cuda):
    """measure_round_times on a QR plan on the card: one walk launch a
    round (and a warm-up pass), the caller's buffers untouched, the final
    state bitwise the fused execute_plan's, the 1-worker replay the sum of
    the round times."""
    from repro_torch import core
    a = rand((512, 512), 21, cuda)
    tiles, mt, nt = qr._split_tiles(a, 64)
    sched, _ = qr.make_qr_graph(mt, nt, nr_queues=4)
    plan = lower(sched, 4)
    tables = engine.lower_tables(
        plan, sched, qr._TileState(dict(tiles)).batch_registry(),
        arg_width=engine.QR_ARG_WIDTH, row_access=engine.qr_row_access)
    stack = torch.stack([tiles[i, j] for j in range(nt) for i in range(mt)])
    before = stack.clone()
    kernel.reset_counts()
    t = engine.measure_round_times(tables, engine.qr_round_fn, (),
                                   (stack, torch.zeros_like(stack)),
                                   per_item=True)
    busy = int((np.diff(tables.round_offsets) > 0).sum())
    assert kernel.LAUNCHES["qr_walk"] == 2 * busy + 1 + tables.nr_items
    assert not any(kernel.PLAIN_CALLS.values())
    assert torch.equal(stack, before)
    want = engine.execute_plan(tables, engine.qr_round_fn, (),
                               (stack.clone(), torch.zeros_like(stack)))
    assert all(torch.equal(x, y) for x, y in zip(t.buffers, want))
    res = core.replay_round_times(sched, plan, t.round_s, nr_workers=1)
    assert res.makespan == pytest.approx(sum(t.round_s), rel=1e-9)
    assert len(t.item_s) == tables.nr_items and (t.item_s > 0).all()


def test_ssm_forward_and_decode_on_card_match_cpu(cuda):
    """falcon-mamba-7b --reduced, fp32: the forward logits and a prefill
    plus one decode step on the card against the port on the CPU (the
    reference's kernel-test tolerance: two float32 summation orders)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm, serving
    from repro_torch.optim.tree import tree_map
    cfg = get_config("falcon-mamba-7b").reduced()
    cpu = lm.init_params(torch.Generator().manual_seed(0), cfg)
    card = tree_map(lambda t: t.to(cuda), cpu)
    tok = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 128)))
    with torch.no_grad():
        outs = []
        for p, dev in ((cpu, "cpu"), (card, cuda)):
            t = tok.to(dev)
            h, _ = lm.forward(p, cfg, t)
            logits = lm.logits_fn(p, cfg, h)
            _, cache, pos = serving.prefill(p, cfg, t[:, :-1])
            dec, _ = serving.decode_step(p, cfg, cache, t[:, -1:], pos)
            outs.append((logits.cpu(), dec.cpu(),
                         {k: v.cpu() for k, v in cache.items()}))
    (l0, d0, c0), (l1, d1, c1) = outs
    assert_allclose(l1.numpy(), l0.numpy(), **TOL)
    assert_allclose(d1.numpy(), d0.numpy(), **TOL)
    for k in c0:
        assert_allclose(c1[k].numpy(), c0[k].numpy(), **TOL)


# --- the hybrid, enc-dec and VLM families on the card -------------------------

FAMILY_ARCHS = ("zamba2-7b", "whisper-tiny", "internvl2-76b")


def _family_inputs(cfg, b, s, seed):
    """Tokens and the family's stub inputs (x 0.02), on the CPU."""
    from repro_torch.models import lm
    rng = np.random.default_rng(seed)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))
    return tok, {k: torch.tensor(rng.standard_normal(v.shape) * 0.02,
                                 dtype=v.dtype)
                 for k, v in lm.stub_inputs(cfg, b, "cpu").items()}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_and_decode_on_card_match_cpu(cuda, arch):
    """``--reduced``, fp32: the forward logits, a prefill of S - 1 tokens
    (every cache leaf) and one decode step on the card against the port on
    the CPU (the reference's kernel-test tolerance: two float32 summation
    orders); no kernel and no plain version of one runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.models import lm, serving
    from repro_torch.optim.tree import flatten_with_path, tree_map
    cfg = get_config(arch).reduced()
    cpu = lm.init_params(torch.Generator().manual_seed(0), cfg)
    card = tree_map(lambda t: t.to(cuda), cpu)
    tok, extra = _family_inputs(cfg, 2, 40, 3)
    pa_kernel.reset_counts()
    outs = []
    with torch.no_grad():
        for p, dev in ((cpu, "cpu"), (card, cuda)):
            t = tok.to(dev)
            e = {k: v.to(dev) for k, v in extra.items()}
            h, _ = lm.forward(p, cfg, t, extra=e)
            logits = lm.logits_fn(p, cfg, h)
            _, cache, pos = serving.prefill(p, cfg, t[:, :-1], extra=e)
            cache = serving.pad_seq(cache, 2)
            dec, _ = serving.decode_step(p, cfg, cache, t[:, -1:], pos)
            outs.append((logits.cpu(), dec.cpu(),
                         {k: v.cpu() for k, v in flatten_with_path(cache)}))
    assert not any(pa_kernel.LAUNCHES.values())
    assert not any(pa_kernel.PLAIN_CALLS.values())
    (l0, d0, c0), (l1, d1, c1) = outs
    assert_allclose(l1.numpy(), l0.numpy(), **TOL)
    assert_allclose(d1.numpy(), d0.numpy(), **TOL)
    assert_allclose(d1.numpy(), l1[:, -1].numpy(), atol=2e-4, rtol=1e-3)
    assert set(c0) == set(c1)
    for k in c0:
        assert_allclose(c1[k].numpy(), c0[k].numpy(), err_msg=str(k), **TOL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_on_card_matches_cpu(cuda, arch):
    """One fp32 AdamW step with the family's zero stub inputs on the card
    against the same step on the CPU: loss, grad norm and every gradient
    leaf within the reference's kernel-test tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import lm
    cfg = get_config(arch).reduced()
    params0 = lm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = SyntheticTokens(cfg.vocab, 32, 2, seed=0).batch_at(0)["tokens"]
    got = _one_step(cfg, params0, tokens, cuda)
    want = _one_step(cfg, params0, tokens, torch.device("cpu"))
    assert_allclose(got[0], want[0], **TOL)
    assert_allclose(got[1], want[1], **TOL)
    for name, g in want[2].items():
        assert_allclose(got[2][name].numpy(), g.numpy(), err_msg=name, **TOL)
