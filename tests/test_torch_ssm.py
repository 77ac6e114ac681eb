"""The port's SSM family on the CPU against the reference, at
``falcon-mamba-7b --reduced`` (Mamba1, fp32, 4 layers, d 128, dI 256,
N 16) with the reference's parameters (``repro.models.lm.init_params(
PRNGKey(0))``) through ``repro_torch.models.convert``, and the Mamba2
functions at ``zamba2-7b --reduced``'s dims.

Tolerances: the reference's kernel-test tolerance (atol 2e-5, rtol 1e-4)
for the blocks, the scans, the loss and every gradient leaf; the serving
tolerance of ``tests/test_torch_serve.py`` (atol 1e-5, rtol 1e-4) for
logits and caches; the reference's own prefill→decode consistency bound
(atol 2e-4, rtol 1e-3, ``tests/test_archs_smoke.py``).  The chunked scan
is a Hillis-Steele doubling where the reference's is jax's
``associative_scan``: two float32 evaluation orders of one recurrence.

* the blocks: ``conv1d_causal``/``conv1d_step``, both scans at S 256 (two
  chunks) and S 37 (the stepwise fallback), ``mamba1_apply`` with its
  state and ``mamba1_decode``, ``mamba2_apply``/``mamba2_apply_ref``/
  ``mamba2_decode``, and the init constants;
* the model: ``lm.forward`` at S 32 and 128, ``serving.prefill`` and three
  ``decode_step``s, prefill→decode consistency, a state independent of
  ``max_seq``;
* the service token for token against the reference's (``PLENS``/
  ``BUDGETS`` of ``tests/test_serve.py`` through 3 slots, ``kernel``
  forced and resolved to ``gather``, no K10/K11 call), a request longer
  than ``max_seq``, sampling, and the fault retry restoring the state;
* training: ``loss_fn`` and every gradient leaf against
  ``jax.value_and_grad`` with remat on, one ``make_train_step``,
  ``run_training``, both launchers, parameters and moments through
  ``convert`` and a checkpoint round trip.

The reference's calls are shared through module fixtures (one forward a
shape, one service run, one ``value_and_grad`` a shape).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import serving as tserving  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim.tree import flatten_with_path, leaves  # noqa: E402
from repro_torch.optim.tree import tree_map  # noqa: E402
from repro_torch.trainer import loop as tloop  # noqa: E402
from repro_torch.trainer import steps as tsteps  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-4)         # the reference's kernel tests
SERVE_TOL = dict(atol=1e-5, rtol=1e-4)   # tests/test_torch_serve.py
CONSIST_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_archs_smoke.py
ARCH = "falcon-mamba-7b"
MAX_SEQ = 24
PLENS = (5, 7, 5, 9, 5)                  # tests/test_serve.py
BUDGETS = (4, 9, 2, 6, 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These models are tiny: one intra-op thread is as fast, and the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tensors(tree):
    return {k: (_tensors(v) if isinstance(v, dict)
                else torch.tensor(np.asarray(v))) for k, v in tree.items()}


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_reference(_np(jp), tcfg)
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def layer(model):
    """Layer 0's Mamba1 parameters in both packages."""
    jcfg, jp, tcfg, tp = model
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mamba"])
    tl = {k: v[0] for k, v in tp["layers"]["mamba"].items()}
    return jcfg, jl, tcfg, tl


@pytest.fixture(scope="module")
def mamba2():
    """One Mamba2 block at zamba2-7b --reduced's dims (8 heads of 32)."""
    jcfg = jconfigs.get_config("zamba2-7b").reduced()
    tcfg = tconfigs.get_config("zamba2-7b").reduced()
    jp = jssm.mamba2_init(jax.random.PRNGKey(4), jcfg)
    return jcfg, jp, tcfg, _tensors(jp)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# --- init constants --------------------------------------------------------------

def test_init_constants_and_dtypes_match_reference():
    """The inits of ``dt_bias`` (-4.6), ``d_skip`` (1), ``conv_b`` (0) and
    Mamba2's constants equal the reference's exactly; ``a_log`` is
    ``log(1..N)`` rounded correctly to float32, which is the reference's
    but for ``log(7)``, where XLA's CPU log is one ulp off.  Every leaf
    has the reference's shape and dtype, in bf16 too."""
    for dtype in ("float32", "bfloat16"):
        jcfg = jconfigs.get_config(ARCH).reduced(dtype=dtype)
        tcfg = tconfigs.get_config(ARCH).reduced(dtype=dtype)
        jp = _np(jlm.init_params(jax.random.PRNGKey(0), jcfg))
        tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
        want = {k: v for k, v in _flat_ref(jp).items()}
        got = {k: v for k, v in flatten_with_path(tp)}
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == want[k].shape, k
            assert str(v.dtype).split(".")[-1] == want[k].dtype.name, k
        m = {k[-1]: v for k, v in got.items() if k[1] == "mamba"}
        jm = {k[-1]: v for k, v in want.items() if k[1] == "mamba"}
        for k in ("dt_bias", "d_skip", "conv_b"):
            assert np.array_equal(m[k].numpy(), jm[k]), k
        n = tcfg.ssm_state
        exact = np.log(np.arange(1, n + 1, dtype=np.float64)).astype(
            np.float32)
        assert np.array_equal(m["a_log"].numpy(),
                              np.broadcast_to(exact, m["a_log"].shape))
        np.testing.assert_array_max_ulp(m["a_log"].numpy(), jm["a_log"],
                                        maxulp=1)
    jcfg = jconfigs.get_config("zamba2-7b").reduced()
    tcfg = tconfigs.get_config("zamba2-7b").reduced()
    jp = _np(jssm.mamba2_init(jax.random.PRNGKey(0), jcfg))
    tp = tssm.mamba2_init(torch.Generator().manual_seed(0), tcfg)
    for k in ("conv_b_x", "conv_b_b", "conv_b_c", "dt_bias", "a_log",
              "d_skip"):
        assert np.array_equal(tp[k].numpy(), jp[k]), k
    assert np.array_equal(tp["norm"]["scale"].numpy(), jp["norm"]["scale"])
    for k, v in jp.items():
        if k != "norm":
            assert tuple(tp[k].shape) == v.shape and tp[k].dtype == \
                torch.float32, k


def _flat_ref(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# --- the blocks --------------------------------------------------------------------

def test_conv1d_causal_and_step_match_reference():
    x, w, b = _x((2, 37, 24), 0), _x((24, 4), 1), _x((24,), 2)
    want = jssm.conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tssm.conv1d_causal(torch.tensor(x), torch.tensor(w),
                             torch.tensor(b))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    win, xt = _x((2, 3, 24), 3), _x((2, 24), 4)
    jy, jw = jssm.conv1d_step(jnp.asarray(win), jnp.asarray(xt),
                              jnp.asarray(w), jnp.asarray(b))
    ty, tw = tssm.conv1d_step(torch.tensor(win), torch.tensor(xt),
                              torch.tensor(w), torch.tensor(b))
    assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert np.array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("s", [256, 37])
def test_scans_match_reference(s):
    """S 256 is two chunks of the chunked scan; S 37 is not a multiple of
    the chunk, so the chunked scan falls back to the stepwise one."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 32, 16)).astype(np.float32)
    b = _x((2, s, 32, 16), 1, 0.1)
    h0 = _x((2, 32, 16), 2)
    want = np.asarray(jssm.linear_scan_chunked(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)))
    ta, tb, th = torch.tensor(a), torch.tensor(b), torch.tensor(h0)
    assert_allclose(tssm.linear_scan_chunked(ta, tb, th).numpy(), want,
                    **TOL)
    ref = tssm.linear_scan_ref(ta, tb, th)
    assert_allclose(ref.numpy(), np.asarray(jssm.linear_scan_ref(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))), **TOL)
    if s % tssm.SSM_CHUNK:
        assert torch.equal(tssm.linear_scan_chunked(ta, tb, th), ref)


@pytest.mark.parametrize("chunked", [True, False])
def test_mamba1_apply_and_decode_match_reference(layer, chunked):
    jcfg, jl, tcfg, tl = layer
    x = _x((2, 128, jcfg.d_model), 5)
    jo, jst = jssm.mamba1_apply(jl, jcfg, jnp.asarray(x), chunked=chunked,
                                return_state=True)
    to, tst = tssm.mamba1_apply(tl, tcfg, torch.tensor(x), chunked=chunked,
                                return_state=True)
    assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for k in ("conv", "h"):
        assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)
    xt = _x((2, 1, jcfg.d_model), 6)
    jd, jc = jssm.mamba1_decode(jl, jcfg, jnp.asarray(xt), jst)
    td, tc = tssm.mamba1_decode(tl, tcfg, torch.tensor(xt), tst)
    assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    for k in ("conv", "h"):
        assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    cache = tssm.mamba1_init_cache(tcfg, 2)
    for k, v in jssm.mamba1_init_cache(jcfg, 2).items():
        assert cache[k].shape == v.shape and cache[k].dtype == torch.float32


@pytest.mark.parametrize("s", [256, 37])
def test_mamba2_matches_reference(mamba2, s):
    """S 256 is two SSD chunks with the carried state; S 37 one chunk of
    37; the stepwise oracle and one decode step from the chunk form's
    state too."""
    jcfg, jp, tcfg, tp = mamba2
    x = _x((2, s, jcfg.d_model), 7)
    jo, jst = jssm.mamba2_apply(jp, jcfg, jnp.asarray(x), return_state=True)
    to, tst = tssm.mamba2_apply(tp, tcfg, torch.tensor(x), return_state=True)
    assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for k in jst:
        assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)
    if s == 37:
        want = jssm.mamba2_apply_ref(jp, jcfg, jnp.asarray(x))
        got = tssm.mamba2_apply_ref(tp, tcfg, torch.tensor(x))
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert_allclose(got.numpy(), to.numpy(), **TOL)
    xt = _x((2, 1, jcfg.d_model), 8)
    jd, jc = jssm.mamba2_decode(jp, jcfg, jnp.asarray(xt), jst)
    td, tc = tssm.mamba2_decode(tp, tcfg, torch.tensor(xt), tst)
    assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    for k in jc:
        assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
    cache = tssm.mamba2_init_cache(tcfg, 3)
    for k, v in jssm.mamba2_init_cache(jcfg, 3).items():
        assert cache[k].shape == v.shape


# --- the model -----------------------------------------------------------------------

@pytest.mark.parametrize("s", [32, 128])
def test_forward_logits_match_reference(model, s):
    jcfg, jp, tcfg, tp = model
    tok = _tokens(jcfg.vocab, (2, s), s)
    jh, _ = jlm.forward(jp, jcfg, jnp.asarray(tok))
    want = jlm.logits_fn(jp, jcfg, jh)
    with torch.no_grad():
        th, aux = tlm.forward(tp, tcfg, torch.tensor(tok))
        got = tlm.logits_fn(tp, tcfg, th)
    assert float(aux) == 0.0
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_cache_and_decode_match_reference(model):
    jcfg, jp, tcfg, tp = model
    tok = _tokens(jcfg.vocab, (3, 9), 11)
    jl, jc, jpos = jserving.prefill(jp, jcfg, jnp.asarray(tok))
    with torch.no_grad():
        tl, tc, tpos = tserving.prefill(tp, tcfg, torch.tensor(tok))
    assert_allclose(tl.numpy(), np.asarray(jl), **SERVE_TOL)
    assert set(tc) == set(jc) == {"conv", "h"}
    for k in tc:
        assert tc[k].dtype == torch.float32
        assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **SERVE_TOL)
    assert tpos.tolist() == np.asarray(jpos).tolist()
    assert tserving.pad_seq(tc, 7) == tc          # O(1) state: no padding
    for step in range(3):
        nxt = _tokens(jcfg.vocab, (3, 1), 20 + step)
        jl, jc = jserving.decode_step(jp, jcfg, jc, jnp.asarray(nxt), jpos)
        with torch.no_grad():
            tl, tc2 = tserving.decode_step(tp, tcfg, tc, torch.tensor(nxt),
                                           tpos)
        assert tc2 is tc                          # updated in place
        assert_allclose(tl.numpy(), np.asarray(jl), **SERVE_TOL)
        for k in tc:
            assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **SERVE_TOL)
        jpos, tpos = jpos + 1, tpos + 1
    with pytest.raises(ValueError, match="not paged"):
        tserving.decode_step_paged(tp, tcfg, tc, torch.zeros((3, 1)),
                                   torch.tensor(nxt), tpos, page_size=4)


def test_prefill_decode_consistency(model):
    """Twin of ``tests/test_archs_smoke.py::test_prefill_decode_
    consistency``: prefill S-1 tokens, decode token S-1, against the full
    forward's last logits."""
    _, _, tcfg, tp = model
    tok = torch.tensor(_tokens(tcfg.vocab, (2, 16), 3))
    with torch.no_grad():
        h, _ = tlm.forward(tp, tcfg, tok)
        full = tlm.logits_fn(tp, tcfg, h[:, -1])
        _, cache, pos = tserving.prefill(tp, tcfg, tok[:, :-1])
        cache = tserving.pad_seq(cache, 4)
        dec, _ = tserving.decode_step(tp, tcfg, cache, tok[:, -1:], pos)
    assert_allclose(dec.numpy(), full.numpy(), **CONSIST_TOL)


def test_state_is_constant_size(model):
    """Twin of ``test_long_context_state_is_constant_size``: the decode
    state does not grow with ``max_seq``."""
    jcfg, _, tcfg, _ = model
    c1 = tserving.init_cache(tcfg, 1, 64, torch.device("cpu"))
    c2 = tserving.init_cache(tcfg, 1, 4096, torch.device("cpu"))
    assert {k: v.shape for k, v in c1.items()} == {
        k: v.shape for k, v in c2.items()}
    want = jserving.init_cache(jcfg, batch=1, max_seq=64)
    assert {k: tuple(v.shape) for k, v in c1.items()} == {
        k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in c1.values())


# --- the service -----------------------------------------------------------------------

def _prompts(vocab, plens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=pl, dtype=np.int32) for pl in plens]


@pytest.fixture(scope="module")
def reference_streams(model):
    """The reference service's greedy streams (``tests/test_serve.py``'s
    workload: 3 slots, mid-stream joins and leaves), run once."""
    jcfg, jp, _, _ = model
    svc = jserve.GenerateService(jp, jcfg, max_batch=3, max_seq=MAX_SEQ,
                                 page_size=4)
    assert svc.decode_path == "gather"
    hs = [svc.submit(p, n) for p, n in zip(_prompts(jcfg.vocab, PLENS),
                                           BUDGETS)]
    svc.run_until_complete()
    return [h.generated for h in hs], svc.stats


def _service(tp, tcfg, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("page_size", 4)
    return tserve.GenerateService(tp, tcfg, device="cpu", **kw)


def _sequential(tp, tcfg, prompt, n):
    """One request alone: ``prefill`` then ``decode_step``, greedy."""
    with torch.no_grad():
        logits, cache, pos = tserving.prefill(tp, tcfg,
                                              torch.tensor(prompt)[None])
        toks = [int(torch.argmax(logits[0]))]
        for _ in range(n - 1):
            logits, cache = tserving.decode_step(
                tp, tcfg, cache, torch.tensor([[toks[-1]]]), pos)
            toks.append(int(torch.argmax(logits[0])))
            pos = pos + 1
    return toks


def test_service_matches_reference_token_for_token(model, reference_streams):
    """Twin of ``tests/test_paged_decode.py::test_ssm_forces_gather_and_
    still_conforms``: forcing the kernel path resolves to gather, the
    streams equal the reference service's, and neither K10 nor K11 (nor
    their plain versions) is called."""
    _, _, tcfg, tp = model
    want, jstats = reference_streams
    calls = (dict(pa_ops.PLAIN_CALLS), dict(pa_ops.LAUNCHES))
    for path in ("kernel", "auto"):
        svc = _service(tp, tcfg, decode_path=path)
        assert svc.decode_path == svc.decode_path_active == "gather"
        assert not svc.paged and svc.max_pages == 1
        assert svc.hooks is svc._hooks_by_path["gather"]
        hs = [svc.submit(p, n) for p, n in zip(_prompts(tcfg.vocab, PLENS),
                                               BUDGETS)]
        svc.run_until_complete()
        assert [h.generated for h in hs] == want
        for k in ("steps", "admitted", "retired", "decode_items",
                  "generated_tokens", "pages_attended"):
            assert svc.stats[k] == jstats[k], k
        assert svc.pool.allocated == 0
        svc.pool.check_invariants()
    assert (dict(pa_ops.PLAIN_CALLS), dict(pa_ops.LAUNCHES)) == calls


def test_request_longer_than_max_seq_is_served(model):
    _, _, tcfg, tp = model
    prompt = _prompts(tcfg.vocab, (13,), seed=5)[0]
    svc = _service(tp, tcfg, max_seq=8)
    h = svc.submit(prompt, 6)               # 18 positions > max_seq 8
    svc.run_until_complete()
    assert h.status == "done"
    assert h.generated == _sequential(tp, tcfg, prompt, 6)


def _sampled(tp, tcfg, max_batch, sampling):
    svc = _service(tp, tcfg, max_batch=max_batch, sampling=sampling)
    hs = [svc.submit(p, n) for p, n in zip(_prompts(tcfg.vocab, PLENS, 2),
                                           BUDGETS)]
    svc.run_until_complete()
    return [h.generated for h in hs]


def test_sampling_deterministic_and_independent_of_batching(model):
    _, _, tcfg, tp = model
    sp = tserve.SamplingParams(temperature=0.8, top_k=8, seed=7)
    a = _sampled(tp, tcfg, 3, sp)
    assert a == _sampled(tp, tcfg, 3, sp)
    assert a == _sampled(tp, tcfg, 1, sp)       # one request at a time
    assert a != _sampled(tp, tcfg, 3, None)


@pytest.mark.parametrize("sticky", [1, 3])
def test_nan_fault_retry_restores_the_state(model, sticky):
    """An injected NaN trips the guard after the round overwrote the
    slot's state: the retry starts from the pre-round state (sticky 1),
    or the request is preempted and re-admitted (sticky 3); either way
    the stream is the sequential one."""
    _, _, tcfg, tp = model
    prompt = _prompts(tcfg.vocab, (5,), seed=9)[0]
    plan = tserve.FaultPlan([tserve.FaultEvent(2, "nan_decode",
                                               sticky=sticky)])
    svc = _service(tp, tcfg, faults=plan)
    h = svc.submit(prompt, 6)
    svc.run_until_complete()
    assert h.status == "done"
    assert h.generated == _sequential(tp, tcfg, prompt, 6)
    assert svc.stats["retries"] >= 1
    assert svc.stats["preemptions"] == (0 if sticky == 1 else 1)


# --- training --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grads(model):
    """The reference's loss, metrics and gradients at S 32 (the stepwise
    scan) and S 128 (the chunked scan), with a loss mask, remat on."""
    jcfg, jp, _, _ = model
    assert jcfg.remat
    vg = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, jcfg, b),
                                    has_aux=True))
    out = {}
    for s in (32, 128):
        tok = _tokens(jcfg.vocab, (2, s), 30 + s)
        mask = (np.random.default_rng(s).random((2, s)) < 0.7).astype(
            np.float32)
        (loss, metrics), g = vg(jp, {"tokens": jnp.asarray(tok),
                                     "loss_mask": jnp.asarray(mask)})
        out[s] = (tok, mask, float(loss),
                  {k: float(v) for k, v in metrics.items()}, _flat_ref(g))
    return out


@pytest.mark.parametrize("s", [32, 128])
def test_loss_and_every_gradient_leaf_match_reference(model, grads, s):
    _, _, tcfg, tp = model
    tok, mask, want_loss, want_metrics, want_g = grads[s]
    loss, metrics, g = tsteps.loss_and_grads(
        tp, tcfg, {"tokens": torch.tensor(tok),
                   "loss_mask": torch.tensor(mask)})
    assert_allclose(float(loss), want_loss, **TOL)
    for k in want_metrics:
        assert_allclose(float(metrics[k]), want_metrics[k], **TOL)
    got = {tuple(str(k) for k in path): v for path, v in flatten_with_path(g)}
    assert set(got) == set(want_g)
    for path, v in got.items():
        assert_allclose(v.numpy(), want_g[path], err_msg=str(path), **TOL)


def test_remat_on_and_off_bitwise_equal(model):
    import dataclasses
    _, _, tcfg, tp = model
    batch = {"tokens": torch.tensor(_tokens(tcfg.vocab, (2, 32), 3))}
    on = tsteps.loss_and_grads(tp, tcfg, batch)
    off = tsteps.loss_and_grads(tp, dataclasses.replace(tcfg, remat=False),
                                batch)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(on[2]),
                                                 leaves(off[2])))


def test_one_train_step(model):
    _, _, tcfg, tp = model
    params = tree_map(torch.clone, tp)
    step, opt_init = tsteps.make_train_step(tcfg, optimizer="adamw", lr=1e-3)
    batch = {"tokens": torch.tensor(_tokens(tcfg.vocab, (2, 32), 4))}
    want, _, _ = tsteps.loss_and_grads(tp, tcfg, batch)
    p2, _, m = step(params, opt_init(params), batch)
    assert float(m["loss"]) == float(want)
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p2), leaves(tp))) > 0


def test_run_training_two_steps_on_the_cpu(model, tmp_path):
    _, _, tcfg, _ = model
    p, o, hist = tloop.run_training(tcfg, str(tmp_path), 2, seq_len=32,
                                    global_batch=2, ckpt_every=1,
                                    device="cpu", log_fn=lambda s: None)
    assert [s for s, _ in hist] == [0, 1]
    assert all(np.isfinite(v) for _, v in hist)
    assert int(o.step) == 2


def test_launchers_run_falcon_on_the_cpu(tmp_path, capsys):
    base = ["--arch", ARCH, "--reduced", "--device", "cpu"]
    launch_serve.main(base + ["--continuous", "--batch", "2",
                              "--new-tokens", "8"])
    out = capsys.readouterr().out
    assert "decode path: gather" in out and "continuous: 6 requests" in out
    launch_serve.main(base + ["--batch", "2", "--new-tokens", "4"])
    assert "decode 4 tokens" in capsys.readouterr().out
    launch_train.main(base + ["--steps", "2", "--seq-len", "32",
                              "--global-batch", "2",
                              "--workdir", str(tmp_path)])
    assert "done: 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_params_and_moments_convert_and_round_trip(model, tmp_path, opt):
    """The reference's parameters and its moments after one update (from
    constant gradients) convert into the port's layout; a port checkpoint
    restores bitwise in both packages."""
    jcfg, jp, tcfg, _ = model
    init, update = {"adamw": (joptim.adamw_init, joptim.adamw_update),
                    "adafactor": (joptim.adafactor_init,
                                  joptim.adafactor_update)}[opt]
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), jp)
    jp1, js1 = update(g, init(jp), jp, 1e-3)
    ref = _np({"params": jp1, "opt": js1})
    port = {"params": convert.params_from_reference(ref["params"], tcfg),
            "opt": convert.opt_state_from_reference(ref["opt"], tcfg)}
    assert int(port["opt"].step) == 1
    assert len(leaves(port)) == len(jax.tree.leaves(ref))
    for a, b in zip(leaves(port), jax.tree.leaves(ref)):
        assert np.array_equal(a.numpy(), b)
    tckpt.save_checkpoint(str(tmp_path), 1, port)
    back = tckpt.restore_checkpoint(str(tmp_path), 1,
                                    tree_map(torch.zeros_like, port))
    assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(port)))
    jback = jckpt.restore_checkpoint(str(tmp_path), 1,
                                     jax.tree.map(jnp.zeros_like,
                                                  {"params": jp1,
                                                   "opt": js1}))
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(ref)):
        assert np.array_equal(np.asarray(a), b)
