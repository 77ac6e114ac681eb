"""The port's plain K10 (paged GQA decode) and K11 (paged MLA decode)
against the reference's oracles.

``repro_torch.kernels.paged_attention.ref.paged_gqa_decode_ref`` and
``paged_mla_decode_ref`` are what ``ops.paged_gqa_decode`` and
``ops.paged_mla_decode`` run on CPU tensors and what the CUDA kernels are
held against on the card.  Here they are held against
``repro.kernels.paged_attention.ref``'s on the same seeded numpy inputs,
at the reference's kernel-vs-oracle tolerance (atol 1e-5, rtol 1e-5,
``tests/test_paged_properties.py``), and against the access contract: unlisted pages and the stale tail of the last page
never reach the result, even when non-finite, and the call writes the
one new cell of each slot and nothing else.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels.paged_attention import ref as jref  # noqa: E402
from repro_torch.kernels.paged_attention import ops, ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
N_HEADS, HD, MAX_PAGES = 4, 32, 4


def _case(bs, n_kv, ps, seed, pos=None, stale_tail=False, n_heads=N_HEADS,
          hd=HD):
    rows, pos, walked, n_pages = ref.random_layout(bs, ps, MAX_PAGES, 3,
                                                   seed, pos)
    arrs = ref.random_operands(rows, pos, walked, n_pages, n_heads=n_heads,
                               n_kv=n_kv, hd=hd, page_size=ps,
                               seed=seed + 1, stale_tail=stale_tail)
    return list(arrs) + [rows, pos]


def _both(arrs, ps):
    """(port's o, k_pool, v_pool) and (reference's), as numpy."""
    got = ops.paged_gqa_decode(*[torch.tensor(a) for a in arrs],
                               page_size=ps)
    want = jref.paged_gqa_decode_ref(*[jnp.asarray(a) for a in arrs],
                                     page_size=ps)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def _same_pages(got, want, rows, pos, ps):
    """The walked pages of each slot are bitwise equal (NaN for NaN)."""
    for t in range(len(pos)):
        pages = rows[t, :pos[t] // ps + 1]
        np.testing.assert_array_equal(got[pages], want[pages])


# (Hkv, H, hd): H/Hkv 1, 2, 4 at the reduced widths; 9, starcoder2-7b as
# published (36 / 4 heads of 128), and 16 (32 / 2), which K10 now takes
@pytest.mark.parametrize("n_kv,n_heads,hd", [(4, 4, 32), (2, 4, 32),
                                             (1, 4, 32), (4, 36, 128),
                                             (2, 32, 128)],
                         ids=["4", "2", "1", "36-4-128", "32-2-128"])
@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("where", ["zero", "page_end", "page_start", "mid"])
def test_plain_k10_matches_reference_oracle(n_kv, n_heads, hd, ps, where):
    p = {"zero": 0, "page_end": ps - 1, "page_start": ps,
         "mid": ps + ps // 2 + 1}[where]
    arrs = _case(3, n_kv, ps, seed=10 * n_kv + ps,
                 pos=[p, MAX_PAGES * ps - 1 - p, p], n_heads=n_heads, hd=hd)
    (o, kp, vp), (ro, rk, rv) = _both(arrs, ps)
    assert np.isfinite(o).all()
    assert_allclose(o, ro, **TOL)
    for got, want in ((kp, rk), (vp, rv)):
        _same_pages(got, want, arrs[5], arrs[6], ps)


@pytest.mark.parametrize("seed", range(8))
def test_plain_k10_never_reads_unlisted_pages(seed):
    """test_paged_properties.py's property on seeded layouts: every page
    no slot walks is NaN and each row's tail points at one; the output
    stays finite and equal to the reference."""
    rng = np.random.default_rng(100 + seed)
    ps = int(rng.choice([4, 8]))
    arrs = _case(int(rng.integers(1, 4)), int(rng.choice([1, 2, 4])), ps,
                 seed=seed)
    (o, kp, vp), (ro, rk, rv) = _both(arrs, ps)
    assert np.isfinite(o).all(), "read a poisoned (unlisted) page"
    assert_allclose(o, ro, **TOL)
    for got, want in ((kp, rk), (vp, rv)):
        _same_pages(got, want, arrs[5], arrs[6], ps)


def test_plain_k10_skips_stale_nonfinite_tail():
    """The last page of every slot holds +inf keys and NaN values after
    pos (a reused page's stale tail): masked out, not multiplied by 0."""
    ps = 8
    arrs = _case(4, 2, ps, seed=3, pos=[0, ps - 1, ps, 13],
                 stale_tail=True)
    (o, _, _), (ro, _, _) = _both(arrs, ps)
    assert np.isfinite(o).all()
    assert_allclose(o, ro, **TOL)


def test_plain_k10_writes_the_cell_and_nothing_else():
    ps = 4
    arrs = _case(3, 2, ps, seed=7)
    rows, pos = arrs[5], arrs[6]
    before = [a.copy() for a in arrs[3:5]]
    q, kn, vn, kp, vp, pr, po = [torch.tensor(a) for a in arrs]
    ops.paged_gqa_decode(q, kn, vn, kp, vp, pr, po, page_size=ps)
    for pool, old, new in ((kp.numpy(), before[0], arrs[1]),
                           (vp.numpy(), before[1], arrs[2])):
        for t in range(len(pos)):
            cell = (rows[t, pos[t] // ps], pos[t] % ps)
            np.testing.assert_array_equal(pool[cell], new[t])
            pool[cell] = old[cell]
        np.testing.assert_array_equal(pool, old)


def test_cpu_tensors_take_the_plain_version_and_others_raise():
    arrs = [torch.tensor(a) for a in _case(1, 2, 4, seed=1)]
    ops.reset_counts()
    ops.paged_gqa_decode(*arrs, page_size=4)
    assert ops.PLAIN_CALLS["paged_gqa"] == 1 and ops.LAUNCHES["paged_gqa"] == 0
    meta = [a.to("meta") for a in arrs]
    with pytest.raises(ValueError, match="CUDA"):       # no fallback
        ops.paged_gqa_decode(*meta, page_size=4)
    assert ops.PLAIN_CALLS["paged_gqa"] == 1
    assert ops.pages_occupied(torch.tensor([0, 3, 4, 9]), 4).tolist() == [
        1, 1, 2, 3]


def test_k10_check_shape_limits():
    """K10's limits, device-free: any H/Hkv (the limit H/Hkv * hd <= 1,024
    is gone), hd up to 256; hd > 256, fp16, Hkv not dividing H and a page
    too large for shared memory raise."""
    from repro_torch.kernels.paged_attention import kernel
    for h, hkv, hd in ((36, 4, 128), (32, 2, 128), (64, 1, 256),
                       (16, 8, 128), (4, 2, 32), (8, 2, 20)):
        for ps in (1, 8, 16, 64):
            kernel.check_shape(torch.bfloat16, h, hkv, hd, ps)
            kernel.check_shape(torch.float32, h, hkv, hd, ps)
    with pytest.raises(ValueError, match="hd <= 256"):
        kernel.check_shape(torch.bfloat16, 4, 2, 257, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel.check_shape(torch.float16, 4, 2, 32, 8)
    with pytest.raises(ValueError, match="dividing"):
        kernel.check_shape(torch.float32, 36, 8, 128, 8)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.check_shape(torch.float32, 4, 2, 256, 512)


# --- K11: the MLA flavour ----------------------------------------------------

# test_paged_properties.py::_mla_case's widths and scale
MLA_HEADS, LAT, ROPE = 4, 16, 8
MLA_SCALE = (LAT + ROPE) ** -0.5


def _mla_case(bs, ps, max_pages, spare, seed, pos=None, stale_tail=False):
    rows, pos, walked, n_pages = ref.random_layout(bs, ps, max_pages, spare,
                                                   seed, pos)
    arrs = ref.random_mla_operands(rows, pos, walked, n_pages,
                                   n_heads=MLA_HEADS, lat=LAT, rope=ROPE,
                                   page_size=ps, seed=seed + 2,
                                   stale_tail=stale_tail)
    return list(arrs) + [rows, pos]


def _both_mla(arrs, ps):
    got = ops.paged_mla_decode(*[torch.tensor(a) for a in arrs],
                               page_size=ps, scale=MLA_SCALE)
    want = jref.paged_mla_decode_ref(*[jnp.asarray(a) for a in arrs],
                                     page_size=ps, scale=MLA_SCALE)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


@pytest.mark.parametrize("seed", range(8))
def test_plain_k11_never_reads_unlisted_pages(seed):
    """test_paged_properties.py's MLA property on seeded layouts of its
    strategy (1-3 slots, page 4 or 8, 2-4 pages a row, 1-3 spare pages):
    every page no slot walks is NaN and each row's tail points at one; the
    context stays finite and equal to the reference's, and the walked pages
    of both pools equal the reference's bitwise."""
    rng = np.random.default_rng(200 + seed)
    ps = int(rng.choice([4, 8]))
    arrs = _mla_case(int(rng.integers(1, 4)), ps, int(rng.integers(2, 5)),
                     int(rng.integers(1, 4)), seed)
    (ctx, cp, rp), (rctx, rc, rr) = _both_mla(arrs, ps)
    assert np.isfinite(ctx).all(), "read a poisoned (unlisted) page"
    assert_allclose(ctx, rctx, **TOL)
    for got, want in ((cp, rc), (rp, rr)):
        _same_pages(got, want, arrs[6], arrs[7], ps)


@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("where", ["zero", "page_end", "page_start", "mid"])
def test_plain_k11_matches_reference_oracle(ps, where):
    p = {"zero": 0, "page_end": ps - 1, "page_start": ps,
         "mid": ps + ps // 2 + 1}[where]
    arrs = _mla_case(3, ps, MAX_PAGES, 3, seed=ps,
                     pos=[p, MAX_PAGES * ps - 1 - p, p])
    (ctx, cp, rp), (rctx, rc, rr) = _both_mla(arrs, ps)
    assert np.isfinite(ctx).all()
    assert_allclose(ctx, rctx, **TOL)
    for got, want in ((cp, rc), (rp, rr)):
        _same_pages(got, want, arrs[6], arrs[7], ps)


def test_plain_k11_skips_stale_nonfinite_tail():
    """NaN latents and +inf RoPE keys after pos in each slot's last page:
    masked out, not multiplied by 0."""
    ps = 8
    arrs = _mla_case(4, ps, MAX_PAGES, 3, seed=3, pos=[0, ps - 1, ps, 13],
                     stale_tail=True)
    (ctx, _, _), (rctx, _, _) = _both_mla(arrs, ps)
    assert np.isfinite(ctx).all()
    assert_allclose(ctx, rctx, **TOL)


def test_plain_k11_writes_the_cells_and_nothing_else():
    ps = 4
    arrs = _mla_case(3, ps, MAX_PAGES, 3, seed=7)
    rows, pos = arrs[6], arrs[7]
    before = [a.copy() for a in arrs[4:6]]
    ts = [torch.tensor(a) for a in arrs]
    ops.reset_counts()
    ops.paged_mla_decode(*ts, page_size=ps, scale=MLA_SCALE)
    assert ops.PLAIN_CALLS == {"paged_gqa": 0, "paged_mla": 1}
    for pool, old, new in ((ts[4].numpy(), before[0], arrs[2]),
                           (ts[5].numpy(), before[1], arrs[3])):
        for t in range(len(pos)):
            cell = (rows[t, pos[t] // ps], pos[t] % ps)
            np.testing.assert_array_equal(pool[cell], new[t])
            pool[cell] = old[cell]
        np.testing.assert_array_equal(pool, old)
    meta = [t.to("meta") for t in ts]
    with pytest.raises(ValueError, match="CUDA"):       # no fallback
        ops.paged_mla_decode(*meta, page_size=ps, scale=MLA_SCALE)
    assert ops.PLAIN_CALLS["paged_mla"] == 1
