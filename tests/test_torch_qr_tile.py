"""Port of the tiled-QR tile kernels (``repro_torch.kernels.qr_tile``):
the plain PyTorch ops against the reference's Pallas kernels (interpret
mode) and its jnp oracles, the factorization invariants, the Householder
guards, and the wrappers' dispatch by device.

Tolerances are the reference's own kernel-vs-oracle ones
(tests/test_kernels_qr.py): atol 2e-5 / rtol 1e-4 for the factorizations,
whose column recurrences reassociate float32 sums differently in the two
frameworks, and atol 1e-5 for the applies (three products each).  The CUDA
kernels themselves are held against the plain ops on the card
(``chip_smoke.py`` and tests/test_torch_gpu.py).
"""

import functools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels.qr_tile import kernel as jkernel  # noqa: E402
from repro.kernels.qr_tile import ref as jref  # noqa: E402
from repro_torch.kernels.qr_tile import kernel, ops, ref  # noqa: E402

SIZES = [4, 8, 16, 32, 64, 128]
FACT = dict(atol=2e-5, rtol=1e-4)     # reference: factorization tolerance
APPLY = dict(atol=1e-5)               # reference: apply tolerance


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain ops run column loops over small tiles: one intra-op thread
    runs them many times faster than a pool contending with the other test
    workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def tt(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def close(got, *wants, **tol):
    for want in wants:
        for g, w in zip(got, want):
            assert_allclose(np.asarray(g), np.asarray(w), **tol)


@pytest.mark.parametrize("b", SIZES)
def test_geqrf_matches_reference(b):
    a = rand((b, b), b)
    got = [x.numpy() for x in ops.geqrf(tt(a))]
    assert got[1].shape == (b,)
    close(got, jkernel.geqrf(jnp.asarray(a), interpret=True),
          jref.geqrf_ref(jnp.asarray(a)), **FACT)


@pytest.mark.parametrize("b", SIZES)
def test_tsqrf_matches_reference(b):
    r0, a = np.triu(rand((b, b), b + 1)), rand((b, b), b + 2)
    got = [x.numpy() for x in ops.tsqrf(tt(r0), tt(a))]
    assert got[2].shape == (b,)
    close(got, jkernel.tsqrf(jnp.asarray(r0), jnp.asarray(a),
                             interpret=True),
          jref.tsqrf_ref(jnp.asarray(r0), jnp.asarray(a)), **FACT)


@pytest.mark.parametrize("b", SIZES)
def test_apply_qt_matches_reference(b):
    rv, _, t = jref.geqrf_ref(jnp.asarray(rand((b, b), b + 3)))
    c = rand((b, b), b + 4)
    got = ops.apply_qt(tt(rv), tt(t), tt(c)).numpy()
    close([got], [jkernel.apply_qt(rv, t, jnp.asarray(c), interpret=True)],
          [jref.apply_qt_ref(rv, t, jnp.asarray(c))], **APPLY)


@pytest.mark.parametrize("b", SIZES)
def test_apply_tsqt_matches_reference(b):
    _, v2, _, t = jref.tsqrf_ref(jnp.asarray(np.triu(rand((b, b), b + 5))),
                                 jnp.asarray(rand((b, b), b + 6)))
    c1, c2 = rand((b, b), b + 7), rand((b, b), b + 8)
    got = [x.numpy() for x in ops.apply_tsqt(tt(v2), tt(t), tt(c1), tt(c2))]
    close(got, jkernel.apply_tsqt(v2, t, jnp.asarray(c1), jnp.asarray(c2),
                                  interpret=True),
          jref.apply_tsqt_ref(v2, t, jnp.asarray(c1), jnp.asarray(c2)),
          **APPLY)


@pytest.mark.parametrize("b", SIZES)
def test_geqrf_reconstructs(b):
    """Q @ R == A and Q orthonormal (reference tolerance 5e-4)."""
    a = rand((b, b), 7 * b)
    rv, _, t = (x.numpy().astype(np.float64) for x in ref.geqrf_ref(tt(a)))
    v = np.tril(rv, -1) + np.eye(b)
    q = np.eye(b) - v @ t @ v.T
    assert_allclose(q @ np.triu(rv), a, atol=5e-4)
    assert_allclose(q.T @ q, np.eye(b), atol=5e-4)


@pytest.mark.parametrize("b", SIZES)
def test_tsqrf_reconstructs(b):
    r0, a = np.triu(rand((b, b), 3 * b)), rand((b, b), 3 * b + 1)
    r1, v2, _, t = (x.numpy() for x in ref.tsqrf_ref(tt(r0), tt(a)))
    vfull = np.vstack([np.eye(b), v2])
    q = np.eye(2 * b) - vfull @ t @ vfull.T
    rec = q @ np.vstack([r1, np.zeros((b, b), np.float32)])
    assert_allclose(rec, np.vstack([r0, a]), atol=5e-4)


@pytest.mark.parametrize("case", ["zero_column", "triangular", "zero_tile"])
def test_householder_guards(case):
    """sigma2 == 0 gives tau 0 (no reflection) and no NaN; the port agrees
    with the reference on such tiles."""
    b = 8
    a = rand((b, b), 11)
    if case == "zero_column":
        a[:, 2] = 0.0
    elif case == "triangular":
        a = np.triu(a)
    else:
        a[:] = 0.0
    rv, tau, t = (x.numpy() for x in ref.geqrf_ref(tt(a)))
    assert np.isfinite(rv).all() and np.isfinite(t).all()
    close([rv, tau, t], jref.geqrf_ref(jnp.asarray(a)), **FACT)
    if case != "zero_column":
        assert (tau == 0.0).all()          # nothing below the diagonal
    # the dense block of tsqrf: an all-zero column means tau_j = 0
    d = rand((b, b), 12)
    d[:, 5] = 0.0
    outs = [x.numpy() for x in ref.tsqrf_ref(tt(np.triu(a)), tt(d))]
    assert all(np.isfinite(o).all() for o in outs)
    close(outs, jref.tsqrf_ref(jnp.asarray(np.triu(a)), jnp.asarray(d)),
          **FACT)


def _float32_excess(fn, seed, b=64):
    """How far the plain float32 ``fn`` lies past the kernel-vs-plain
    limit (FACT) from the same function in float64, on one seeded tile:
    > 0 where float32 rounding alone misses the limit."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, b))
    r = np.triu(rng.standard_normal((b, b)))
    lo = fn(torch.tensor(a, dtype=torch.float32),
            torch.tensor(r, dtype=torch.float32))
    hi = fn(torch.tensor(a), torch.tensor(r))
    return max(float((np.abs(x.double().numpy() - y.numpy())
                      - (FACT["atol"] + FACT["rtol"] * np.abs(y.numpy())))
                     .max()) for x, y in zip(lo, hi))


@pytest.mark.parametrize("case,conditioned", [
    ("geqrf, dense tile", True),
    ("tsqrf, random triangle R", True),
    ("tsqrf, R = 0", False),
])
def test_float32_conditioning_of_the_card_test_data(case, conditioned):
    """Why the card tests (tests/test_torch_gpu.py, chip_smoke.py) give
    tsqrf a random triangle R and put the zero tiles in the dense inputs:
    at b = 64, over 40 seeded tiles, the plain float32 geqrf and tsqrf
    with such an R stay inside the kernel-vs-plain limit of float64, so two
    float32 orders can be held to it; tsqrf with R = 0 leaves T and V2
    ill-conditioned, and float32 alone misses the limit there."""
    fn = {"geqrf, dense tile": lambda a, r: ref.geqrf_ref(a),
          "tsqrf, random triangle R": lambda a, r: ref.tsqrf_ref(r, a),
          "tsqrf, R = 0": lambda a, r: ref.tsqrf_ref(0 * r, a)}[case]
    worst = max(_float32_excess(fn, seed) for seed in range(40))
    assert (worst <= 0) == conditioned, worst


@pytest.mark.parametrize("case", ["geqrf, dense tile",
                                  "tsqrf, random triangle R"])
def test_float32_conditioning_past_64(case):
    """The card's limit holds past 64 too: at b = 128, on 5 seeded tiles,
    the plain float32 geqrf and tsqrf with a random triangle R stay inside
    the kernel-vs-plain limit of float64, so the global-memory bodies are
    held to the same limit as the shared-memory ones."""
    fn = {"geqrf, dense tile": lambda a, r: ref.geqrf_ref(a),
          "tsqrf, random triangle R": lambda a, r: ref.tsqrf_ref(r, a)}[case]
    worst = max(_float32_excess(fn, seed, b=128) for seed in range(5))
    assert worst <= 0, worst


def test_ops_cpu_tensors_take_plain_path():
    """A CPU tensor gets the plain version, counted in PLAIN_CALLS and never
    in LAUNCHES; a stack of tiles loops the single-tile version, so the
    batched result is bitwise equal to the per-tile calls."""
    kernel.reset_counts()
    b, n = 8, 3
    a = tt(rand((n, b, b), 21))
    rv, tau, t = ops.geqrf(a)
    assert rv.shape == (n, b, b) and tau.shape == (n, b)
    for i in range(n):
        one = ref.geqrf_ref(a[i])
        for x, y in zip((rv[i], tau[i], t[i]), one):
            assert torch.equal(x, y)
    c = tt(rand((n, b, b), 22))
    out = ops.apply_qt(rv, t, c)
    for i in range(n):
        assert torch.equal(out[i], ref.apply_qt_ref(rv[i], t[i], c[i]))
    assert kernel.PLAIN_CALLS["geqrf"] == 1
    assert kernel.PLAIN_CALLS["apply_qt"] == 1
    assert all(v == 0 for v in kernel.LAUNCHES.values())


def test_launch_counts_exact_under_threads():
    """The counters are shared by the threaded backend's workers: no
    increment may be lost, even with a short switch interval."""
    import threading
    kernel.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [kernel.count(kernel.LAUNCHES, "apply_tsqt")
                            for _ in range(2000)]) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert kernel.LAUNCHES["apply_tsqt"] == 16 * 2000
    kernel.reset_counts()


def test_check_shape_takes_any_tile_size():
    """The kernels take every b from 1 to WIDE_MAX_B = 8192 (shared-memory
    bodies to 64, blocked bodies above: panels of 8 columns to 1024, then
    of 4, 2 and 1, a column over 2, 4 and 8 warps), with no global scratch,
    and refuse the rest; the check needs no card (tests/test_torch_gpu.py
    holds each tile size's shared memory to a block's on the card)."""
    for b in (1, 33, 64, 65, 96, 128, 256, 1000, 1024, 1025, 2048, 2049,
              4096, 4097, 8192):
        kernel.check_shape(b)
    with pytest.raises(ValueError, match="b >= 1"):
        kernel.check_shape(0)
    assert kernel.WIDE_MAX_B == 8192
    kernel.check_shape(kernel.WIDE_MAX_B)
    with pytest.raises(ValueError, match="b <= "):
        kernel.check_shape(kernel.WIDE_MAX_B + 1)


@pytest.mark.parametrize("op", ["geqrf", "tsqrf", "apply_qt", "apply_tsqt",
                                "qr_walk"])
def test_cpu_path_refuses_past_the_widest_tile(op):
    """The plain path on CPU tensors refuses b = WIDE_MAX_B + 1 as the card
    does, before any arithmetic and before counting a plain call, so a
    tile size is never taken on one device and refused on the other.  The
    operands are one zero broadcast to (b, b): no memory, no work."""
    b = kernel.WIDE_MAX_B + 1
    x = torch.zeros((1, 1)).expand(b, b)
    kernel.reset_counts()
    with pytest.raises(ValueError, match=f"b <= {kernel.WIDE_MAX_B}"):
        if op == "qr_walk":
            from repro_torch import engine
            engine.qr_round_fn(np.zeros((1, 4), np.int32), [0, 1], (),
                               (x[None], x[None]))
        else:
            n = {"geqrf": 1, "tsqrf": 2, "apply_qt": 3, "apply_tsqt": 4}[op]
            getattr(ops, op)(*(x,) * n)
    assert kernel.PLAIN_CALLS[op] == 0


# ---------------------------------------------------------------------------
# The blocked algorithm of the b > 64 bodies (csrc/qr_tile.cuh, qr_*_wide),
# in float64 torch: panels factored column by column, each panel's T from
# its Gram matrix, the trailing columns updated with the panel's compact
# WY, T merged panel by panel as [[T1, -T1 (V1^T V2) T2], [0, T2]]; the
# applies go panel by panel with the diagonal blocks of T.  Past b = 1024
# (qr_o_*) the panels nest: each outer panel (64 columns) is factored in
# inner panels (the register panels: 4, 2 or 1 columns) that update and
# merge their T into the rest of the outer panel only, then the outer
# panel's compact WY updates the trailing columns once and its T merges
# into the whole T; the applies go in 64-reflector blocks.  Held to the
# plain column-by-column versions (ref) in float64, where the two orders
# agree to rounding: 1e-12.
# ---------------------------------------------------------------------------

# (b, outer width, inner width): the wide bodies' panels of 64 and 32, the
# narrow panels of 4, 2 and 1 columns updating the whole trailing matrix,
# and the bodies past 1024 (outer panels of 64 in inner panels of 4, 2
# and 1; the algorithm does not depend on b, so small tiles hold them)
BLOCKED = [(65, 64, 64), (96, 64, 64), (128, 64, 64), (256, 64, 64),
           (256, 32, 32), (96, 4, 4), (96, 2, 2), (65, 1, 1), (96, 64, 4),
           (130, 64, 2), (65, 64, 1)]
BLOCKED_IDS = [f"{b}-{o}" if o == i else f"{b}-{o}-{i}"
               for b, o, i in BLOCKED]
BLOCKED_TOL = 1e-12


@functools.lru_cache(maxsize=None)
def _plain_factors(b, seed):
    """geqrf_ref and tsqrf_ref in float64 on the seeded (a, r) of
    test_blocked_factorizations_match_plain, computed once a module: the
    cases of one b and seed share them."""
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.standard_normal((b, b)))
    r = torch.triu(torch.tensor(rng.standard_normal((b, b))))
    return a, r, ref.geqrf_ref(a), ref.tsqrf_ref(r, a)


def _panel_t(v, taus):
    """T of one panel from its Gram matrix G = V^T V (qr_build_t):
    T[:j, j] = -tau_j T[:j, :j] G[:j, j], T[j, j] = tau_j."""
    g = v.T @ v
    nb = v.shape[1]
    t = torch.zeros((nb, nb), dtype=v.dtype)
    for j in range(nb):
        t[:j, j] = -taus[j] * (t[:j, :j] @ g[:j, j])
        t[j, j] = taus[j]
    return t


def _merge_t(t, y, j0, nb, lo=0):
    """T[lo:j0, J] = -T[lo:j0, lo:j0] (Y T_J), Y = V[:, lo:j0]^T V_J."""
    t[lo:j0, j0:j0 + nb] = -t[lo:j0, lo:j0] @ (y @ t[j0:j0 + nb,
                                                     j0:j0 + nb])


def _blocked_geqrf(a, outer, inner):
    a = a.clone()
    b = a.shape[0]
    t = torch.zeros_like(a)
    taus = torch.zeros(b, dtype=a.dtype)
    for j0 in range(0, b, outer):
        je = min(j0 + outer, b)
        for j1 in range(j0, je, inner):
            nb = min(inner, je - j1)
            p = a[j1:, j1:j1 + nb]          # the inner panel, a view
            for j in range(nb):
                x = p[:, j].clone()
                beta, tau, inv = ref._householder(x[j],
                                                  torch.sum(x[j + 1:] ** 2))
                v = torch.zeros_like(x)
                v[j] = 1.0
                v[j + 1:] = x[j + 1:] * inv
                p[:, j + 1:] -= torch.outer(v, tau * (v @ p[:, j + 1:]))
                p[j, j] = beta
                p[j + 1:, j] = v[j + 1:]
                taus[j1 + j] = tau
            v = torch.tril(p, -1) + torch.eye(*p.shape, dtype=a.dtype)
            t[j1:j1 + nb, j1:j1 + nb] = _panel_t(v, taus[j1:j1 + nb])
            tk = t[j1:j1 + nb, j1:j1 + nb]
            c = a[j1:, j1 + nb:je]           # the rest of the outer panel
            c -= v @ (tk.T @ (v.T @ c))
            _merge_t(t, a[j1:, j0:j1].T @ v, j1, nb, lo=j0)
        blk = a[j0:, j0:je]                  # the outer panel's WY
        v = torch.tril(blk, -1) + torch.eye(*blk.shape, dtype=a.dtype)
        tk = t[j0:je, j0:je]
        c = a[j0:, je:]
        c -= v @ (tk.T @ (v.T @ c))
        _merge_t(t, a[j0:, :j0].T @ v, j0, je - j0)
    return a, taus, t


def _blocked_tsqrf(r, a, outer, inner):
    r, a = r.clone(), a.clone()
    b = a.shape[0]
    t = torch.zeros_like(a)
    taus = torch.zeros(b, dtype=a.dtype)
    for j0 in range(0, b, outer):
        je = min(j0 + outer, b)
        for j1 in range(j0, je, inner):
            nb = min(inner, je - j1)
            p, rb = a[:, j1:j1 + nb], r[j1:j1 + nb, j1:j1 + nb]
            for j in range(nb):
                x = p[:, j].clone()
                beta, tau, inv = ref._householder(rb[j, j].clone(),
                                                  torch.sum(x * x))
                v = x * inv
                w = rb[j, j + 1:] + v @ p[:, j + 1:]
                rb[j, j + 1:] -= tau * w
                p[:, j + 1:] -= tau * torch.outer(v, w)
                rb[j, j] = beta
                p[:, j] = v
                taus[j1 + j] = tau
            t[j1:j1 + nb, j1:j1 + nb] = _panel_t(p, taus[j1:j1 + nb])
            tk = t[j1:j1 + nb, j1:j1 + nb]
            w = r[j1:j1 + nb, j1 + nb:je] + p.T @ a[:, j1 + nb:je]
            x = tk.T @ w
            r[j1:j1 + nb, j1 + nb:je] -= x
            a[:, j1 + nb:je] -= p @ x
            _merge_t(t, a[:, j0:j1].T @ p, j1, nb, lo=j0)
        v, tk = a[:, j0:je], t[j0:je, j0:je]
        w = r[j0:je, je:] + v.T @ a[:, je:]
        x = tk.T @ w
        r[j0:je, je:] -= x
        a[:, je:] -= v @ x
        _merge_t(t, a[:, :j0].T @ v, j0, je - j0)
    return r, a, taus, t


def _blocked_apply_qt(rv, t, c, nbw):
    c = c.clone()
    b = c.shape[0]
    for j0 in range(0, b, nbw):
        nb = min(nbw, b - j0)
        blk = rv[j0:, j0:j0 + nb]
        v = torch.tril(blk, -1) + torch.eye(*blk.shape, dtype=c.dtype)
        tk = t[j0:j0 + nb, j0:j0 + nb]
        c[j0:] -= v @ (tk.T @ (v.T @ c[j0:]))
    return c


def _blocked_apply_tsqt(v2, t, c1, c2, nbw):
    c1, c2 = c1.clone(), c2.clone()
    for j0 in range(0, c1.shape[0], nbw):
        nb = min(nbw, c1.shape[0] - j0)
        v, tk = v2[:, j0:j0 + nb], t[j0:j0 + nb, j0:j0 + nb]
        x = tk.T @ (c1[j0:j0 + nb] + v.T @ c2)
        c1[j0:j0 + nb] -= x
        c2 -= v @ x
    return c1, c2


def _max_gap(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


@pytest.mark.parametrize("b,outer,inner", BLOCKED, ids=BLOCKED_IDS)
def test_blocked_factorizations_match_plain(b, outer, inner):
    """The panel split (inner panels within outer ones) and the T merges
    reproduce geqrf_ref's and tsqrf_ref's RV / R', V2, taus and T."""
    a, r, plain_f, plain_t = _plain_factors(b, b + outer)
    assert _max_gap(_blocked_geqrf(a, outer, inner), plain_f) <= BLOCKED_TOL
    got = _blocked_tsqrf(r, a, outer, inner)
    assert _max_gap(got, plain_t) <= BLOCKED_TOL


@pytest.mark.parametrize("b,outer,inner", BLOCKED, ids=BLOCKED_IDS)
def test_blocked_applies_match_plain(b, outer, inner):
    """Applying block by block (outer width) with the diagonal blocks of
    the merged T, whose panels were factored inner columns at a time,
    equals apply_qt_ref and apply_tsqt_ref with the whole T."""
    rng = np.random.default_rng(2 * b + outer)
    a, c1, c2 = (torch.tensor(rng.standard_normal((b, b))) for _ in range(3))
    r = torch.triu(torch.tensor(rng.standard_normal((b, b))))
    rv, _, t = _blocked_geqrf(a, outer, inner)
    got = _blocked_apply_qt(rv, t, c1, outer)
    assert _max_gap([got], [ref.apply_qt_ref(rv, t, c1)]) <= BLOCKED_TOL
    _, v2, _, t2 = _blocked_tsqrf(r, a, outer, inner)
    got = _blocked_apply_tsqt(v2, t2, c1, c2, outer)
    assert _max_gap(got, ref.apply_tsqt_ref(v2, t2, c1, c2)) <= BLOCKED_TOL


def test_ops_refuse_other_devices():
    """Neither a non-CPU tensor without a kernel nor mixed devices quietly
    run the plain version."""
    m = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.apply_qt(m, m, m)
    with pytest.raises(ValueError, match="CUDA"):
        ops.apply_qt(torch.zeros(8, 8), torch.zeros(8, 8), m)


def test_kernel_builds_only_at_launch_and_needs_nvcc(tmp_path, monkeypatch):
    """The binding imported (at the top of this file) with no nvcc and no
    card: nothing is built at import.  A launch builds first, and with no
    nvcc the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernel, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.lib()
    assert kernel._LIB is None
