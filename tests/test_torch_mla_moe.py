"""The port's MoE + MLA serving slice on the CPU against the reference, at
``deepseek-v3-671b --reduced`` (MoE with MLA: fp32, 1 dense + 3 MoE layers
of 8 experts top-2, H 4, kv_lora 32, rope 16) and ``kimi-k2-1t-a32b
--reduced`` (MoE with GQA), with the reference's parameters
(``repro.models.lm.init_params(PRNGKey(0))``) passed through
``repro_torch.models.convert.params_from_reference``.

* ``moe_apply`` against the reference's, at the default capacity factor
  1.25 with a batch that drops tokens (the same tokens must be dropped, or
  the outputs part) and at 8.0, where nothing drops, also against the
  capacity-free oracle ``moe_apply_dense_ref``;
* prefill, contiguous decode and paged decode logits and cache leaves
  within atol 1e-5, rtol 1e-4 of the reference (two float32
  implementations of the same math);
* ``GenerateService`` greedy streams equal to the reference service's
  ``gather`` path token for token on the port's ``kernel`` (plain K11 on
  the CPU), ``bounded`` and ``gather`` paths, on the workload of
  ``tests/test_paged_decode.py`` (page 4 and 8, capacity factor 8.0).

The reference's Pallas paths fail on the installed jax (ROADMAP Queue 3),
so only its oracles and its ``gather`` service are compared against.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.models import convert, layers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import serving as tserving  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
PATHS = ("kernel", "bounded", "gather")
MLA, GQA = "deepseek-v3-671b", "kimi-k2-1t-a32b"
# tests/test_paged_decode.py's workload: 2 slots, max_seq 16, 4 requests
# with ragged prompts and budgets (mid-stream joins and leaves)
PLENS, BUDGETS, MAX_SEQ = (3, 5, 3, 6), (3, 6, 2, 4), 16


def _models(arch, **over):
    jcfg = jconfigs.get_config(arch).reduced(**over)
    tcfg = tconfigs.get_config(arch).reduced(**over)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def deepseek():
    return _models(MLA, capacity_factor=8.0)


def _tensors(tree):
    return {k: (_tensors(v) if isinstance(v, dict)
                else torch.tensor(np.asarray(v))) for k, v in tree.items()}


# --- MoE ---------------------------------------------------------------------

def _moe_case(factor, shape):
    jcfg = jconfigs.get_config(MLA).reduced(capacity_factor=factor)
    tcfg = tconfigs.get_config(MLA).reduced(capacity_factor=factor)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(5).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    return jcfg, jp, tcfg, _tensors(jp), x


def _dropped(jcfg, jp, x):
    """Entries past their expert's capacity under the reference's routing."""
    xt = x.reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.experts_per_tok)
    c = jmoe._capacity(xt.shape[0], jcfg.experts_per_tok, jcfg.n_experts,
                       jcfg.capacity_factor)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=jcfg.n_experts)
    return int(np.maximum(counts - c, 0).sum())


@pytest.mark.parametrize("factor,shape", [(1.25, (4, 16)), (1.25, (2, 4)),
                                          (8.0, (4, 16))])
def test_moe_apply_matches_reference(factor, shape):
    """At 1.25 and (4, 16) two entries are dropped (C = 21 for an expert
    that 23 entries chose); the port must drop the same ones."""
    jcfg, jp, tcfg, tp, x = _moe_case(factor, shape)
    want, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    got, taux = tmoe.moe_apply(tp, tcfg, torch.tensor(x))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_allclose(float(taux), float(jaux), **TOL)
    dropped = _dropped(jcfg, jp, x)
    assert dropped == (2 if (factor, shape) == (1.25, (4, 16)) else 0)
    if factor == 8.0:        # nothing dropped: the capacity-free semantics
        dense = tmoe.moe_apply_dense_ref(tp, tcfg, torch.tensor(x))
        assert_allclose(got.numpy(), dense.numpy(), **TOL)
        assert_allclose(
            dense.numpy(),
            np.asarray(jmoe.moe_apply_dense_ref(jp, jcfg, jnp.asarray(x))),
            **TOL)


def test_moe_dropped_tokens_change_the_output():
    """The drop at 1.25 is visible: without it (8.0) the output of the
    tokens whose entries were dropped differs."""
    _, _, tcfg, tp, x = _moe_case(1.25, (4, 16))
    capped, _ = tmoe.moe_apply(tp, tcfg, torch.tensor(x))
    free, _ = tmoe.moe_apply(tp, dataclasses.replace(tcfg,
                                                     capacity_factor=8.0),
                             torch.tensor(x))
    moved = (capped - free).abs().amax(dim=-1).flatten()
    hit = moved > 1e-3
    assert 1 <= int(hit.sum()) <= 2           # the 2 entries' tokens
    assert float(moved[~hit].max()) < 1e-5


@pytest.mark.parametrize("factor", [1.0, 1.25, 8.0])
@pytest.mark.parametrize("t,k,e", [(8, 8, 256), (2048, 8, 256), (64, 2, 8),
                                   (300, 8, 16)])
def test_capacity_equals_reference(t, k, e, factor):
    """C = 4 at decode with 8 slots, 81 at a prefill of 2,048 tokens, and the
    round-up above 256."""
    assert tmoe._capacity(t, k, e, factor) == jmoe._capacity(t, k, e, factor)


def test_moe_init_layout_and_sliced_draw(monkeypatch):
    """The expert stacks come in the reference's layout and dtypes; a stack
    above ``DRAW_CHUNK`` values is drawn a slice of matrices at a time and
    keeps its shape, dtype and scale."""
    cfg = dataclasses.replace(tconfigs.get_config(MLA).reduced(),
                              dtype="bfloat16")
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, (2,))
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    assert p["router"].shape == (2, d, e)
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == p["w_up"].shape == (2, e, d, f)
    assert p["w_down"].shape == (2, e, f, d)
    assert p["w_gate"].dtype == torch.bfloat16
    assert p["shared"]["w_gate"].shape == (2, d, f)
    monkeypatch.setattr(layers, "DRAW_CHUNK", 3 * 256 * 64)
    gen = torch.Generator().manual_seed(1)
    w = layers.dense_init(gen, (2, 8, 256, 64), torch.bfloat16)
    assert w.shape == (2, 8, 256, 64) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) * 256 ** 0.5 - 1.0) < 0.02
    mats = w.float().reshape(16, -1)
    assert (mats.std(dim=1) * 256 ** 0.5 - 1.0).abs().max() < 0.05
    assert not torch.equal(mats[0], mats[3])      # slices draw anew


# --- MLA ---------------------------------------------------------------------

def test_mla_attention_chunked_matches_reference():
    """The prefill attention with v_head_dim apart from nope + rope, through
    the online-softmax path (attn_chunk 4 of 8 positions) and in full."""
    rng = np.random.default_rng(7)
    for chunk in (4, 0):
        jcfg = jconfigs.get_config(MLA).reduced(attn_chunk=chunk)
        tcfg = tconfigs.get_config(MLA).reduced(attn_chunk=chunk)
        jp = jmla.mla_init(jax.random.PRNGKey(1), jcfg)
        x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(8), (2, 8))
        want, (jc, jr) = jmla.mla_attention(jp, jcfg, jnp.asarray(x),
                                            jnp.asarray(pos),
                                            return_latent=True)
        got, (tc, tr) = tmla.mla_attention(_tensors(jp), tcfg,
                                           torch.tensor(x),
                                           torch.tensor(pos.copy()),
                                           return_latent=True)
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        assert_allclose(tr.numpy(), np.asarray(jr), **TOL)


def test_mla_cache_init_and_prefill_latents_match_reference():
    jcfg = jconfigs.get_config(MLA).reduced()
    tcfg = tconfigs.get_config(MLA).reduced()
    want = jmla.mla_init_cache(jcfg, 3, 12)
    got = tmla.mla_init_cache(tcfg, 3, 12, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(not v.any() for v in got.values())
    jp = jmla.mla_init(jax.random.PRNGKey(4), jcfg)
    x = np.random.default_rng(9).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5)).copy()
    for w, g in zip(jmla.mla_prefill_cache(jp, jcfg, jnp.asarray(x),
                                           jnp.asarray(pos)),
                    tmla.mla_prefill_cache(_tensors(jp), tcfg,
                                           torch.tensor(x),
                                           torch.tensor(pos))):
        assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mla_decode_matches_reference_and_writes_in_place():
    jcfg = jconfigs.get_config(MLA).reduced()
    tcfg = tconfigs.get_config(MLA).reduced()
    jp = jmla.mla_init(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    cache = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
             for k, v in jmla.mla_init_cache(jcfg, 3, 12).items()}
    pos = np.array([0, 5, 11], np.int32)
    want, wcache = jmla.mla_decode(jp, jcfg, jnp.asarray(x),
                                   {k: jnp.asarray(v) for k, v in
                                    cache.items()}, jnp.asarray(pos))
    tcache = {k: torch.tensor(v) for k, v in cache.items()}
    got, gcache = tmla.mla_decode(_tensors(jp), tcfg, torch.tensor(x),
                                  tcache, torch.tensor(pos))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in cache:
        assert gcache[k] is tcache[k]                  # in place
        assert_allclose(tcache[k].numpy(), np.asarray(wcache[k]), **TOL)


# --- the model: logits and caches --------------------------------------------

@pytest.mark.parametrize("arch", [MLA, GQA])
@pytest.mark.parametrize("decode", ["contiguous", "paged"])
def test_prefill_and_decode_logits_match_reference(arch, decode):
    jcfg, jp, tcfg, tp = _models(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (3, 6)).astype(np.int32)
    jl, jcache, jpos = jserving.prefill(jp, jcfg, jnp.asarray(tokens))
    tl, tcache, tpos = tserving.prefill(tp, tcfg, torch.tensor(tokens))
    assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert sorted(tcache) == sorted(jcache)
    for k in jcache:
        assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **TOL)
    assert tpos.tolist() == np.asarray(jpos).tolist()
    s, ps = MAX_SEQ, 4
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, s - 6)]
                         + [(0, 0)] * (v.ndim - 3)) for k, v in jcache.items()}
    tcache = tserving.pad_seq(tcache, s - 6)
    if decode == "paged":    # slot b owning pages b*n .. b*n + n - 1
        n = s // ps
        leaves = {k: v.reshape(v.shape[0], 3 * n, ps, *v.shape[3:])
                  for k, v in tcache.items()}
        rows = torch.arange(3 * n, dtype=torch.int32).reshape(3, n)
    pos = np.asarray(jpos)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for _ in range(5):
        jl, jcache = jserving.decode_step(jp, jcfg, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos))
        if decode == "contiguous":
            tl, tcache = tserving.decode_step(tp, tcfg, tcache,
                                              torch.tensor(tok),
                                              torch.tensor(pos))
            got = tcache
        else:
            tl, leaves = tserving.decode_step_paged(
                tp, tcfg, leaves, rows, torch.tensor(tok), torch.tensor(pos),
                page_size=ps)
            got = {k: v.reshape(v.shape[0], 3, s, *v.shape[3:])
                   for k, v in leaves.items()}
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for k in jcache:
            assert_allclose(got[k].numpy(), np.asarray(jcache[k]), **TOL)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        pos = pos + 1


def test_forward_and_layer_order_match_reference(deepseek):
    jcfg, jp, tcfg, tp = deepseek
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 5))
    jh, jaux = jlm.forward(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    th, taux = tlm.forward(tp, tcfg, torch.tensor(tokens))
    assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert_allclose(float(taux), float(jaux), **TOL)
    kinds = [is_moe for _, is_moe in tlm.layers_of(tp)]
    assert kinds == [False] * tcfg.first_dense_layers + [True] * (
        tcfg.n_layers - tcfg.first_dense_layers)


def test_params_from_reference_checks_the_moe_tree(deepseek):
    jcfg, jp, tcfg, _ = deepseek
    tree = jax.tree.map(np.asarray, jp)
    del tree["moe_layers"]["moe"]["shared"]
    with pytest.raises(ValueError, match="moe_layers/moe/shared/w_gate"):
        convert.params_from_reference(tree, tcfg)
    tree = jax.tree.map(np.asarray, jp)
    tree["dense_layers"]["attn"]["wkv_b"] = tree["dense_layers"]["attn"][
        "wkv_b"][..., :-1]
    with pytest.raises(ValueError, match="wkv_b"):
        convert.params_from_reference(tree, tcfg)


def test_init_params_has_the_reference_layout(deepseek):
    _, _, tcfg, tp = deepseek
    mine = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    flat = convert._flat
    assert {k: tuple(v.shape) for k, v in flat(mine).items()} == {
        k: tuple(v.shape) for k, v in flat(tp).items()}
    assert {k: v.dtype for k, v in flat(mine).items()} == {
        k: v.dtype for k, v in flat(tp).items()}


# --- the service -------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in PLENS]


def _run(svc, prompts):
    hs = [svc.submit(p, n) for p, n in zip(prompts, BUDGETS)]
    svc.run_until_complete()
    assert all(h.status == "done" for h in hs)
    assert not svc._active and not svc._queue and svc.pool.allocated == 0
    svc.pool.check_invariants()
    return [h.generated for h in hs]


@pytest.fixture(scope="module")
def reference_streams(deepseek):
    """The reference service's greedy streams on its gather path, by page
    size (run once for the module)."""
    jcfg, jp, _, _ = deepseek
    out = {}
    for ps in (4, 8):
        svc = jserve.GenerateService(jp, jcfg, max_batch=2, max_seq=MAX_SEQ,
                                     page_size=ps, decode_path="gather")
        out[ps] = (_run(svc, _prompts(jcfg.vocab)), svc.stats)
    return out


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("page_size", [4, 8])
def test_service_greedy_equals_reference_gather(deepseek, reference_streams,
                                                path, page_size):
    _, _, tcfg, tp = deepseek
    want, jstats = reference_streams[page_size]
    pa_ops.reset_counts()
    svc = tserve.GenerateService(tp, tcfg, max_batch=2, max_seq=MAX_SEQ,
                                 page_size=page_size, decode_path=path,
                                 device="cpu")
    assert _run(svc, _prompts(tcfg.vocab)) == want
    for k in ("steps", "admitted", "retired", "decode_items",
              "generated_tokens", "pages_attended"):
        assert svc.stats[k] == jstats[k], k
    # the kernel path ran K11's plain version once per layer per tick
    ticks = svc.metrics.get("serve.decode_round_s").count
    want_calls = tcfg.n_layers * ticks if path == "kernel" else 0
    assert pa_ops.PLAIN_CALLS == {"paged_gqa": 0, "paged_mla": want_calls}
    assert not any(pa_ops.LAUNCHES.values())


def test_kimi_service_runs_k10_under_the_moe_stack():
    """MoE with GQA: the kernel path is K10's plain version, and its
    streams equal the reference's gather service's."""
    jcfg, jp, tcfg, tp = _models(GQA, capacity_factor=8.0)
    ref = jserve.GenerateService(jp, jcfg, max_batch=2, max_seq=MAX_SEQ,
                                 page_size=4, decode_path="gather")
    want = _run(ref, _prompts(jcfg.vocab))
    pa_ops.reset_counts()
    svc = tserve.GenerateService(tp, tcfg, max_batch=2, max_seq=MAX_SEQ,
                                 page_size=4, decode_path="kernel",
                                 device="cpu")
    assert _run(svc, _prompts(tcfg.vocab)) == want
    ticks = svc.metrics.get("serve.decode_round_s").count
    assert pa_ops.PLAIN_CALLS == {"paged_gqa": tcfg.n_layers * ticks,
                                  "paged_mla": 0}


def test_prefill_writes_the_prompt_latents_into_its_pages(deepseek):
    """The prefill entry point lays each prompt's latent and RoPE-key rows
    into the request's pages (the leaves are (L, P, ps, width), one axis
    fewer than GQA's), padding the last page with zeros."""
    _, _, tcfg, tp = deepseek
    svc = tserve.GenerateService(tp, tcfg, max_batch=2, max_seq=MAX_SEQ,
                                 page_size=4, decode_path="kernel",
                                 device="cpu")
    prompts = _prompts(tcfg.vocab)[:2]          # 3 and 5 tokens
    for p in prompts:
        svc.submit(p, 4)
    svc._admit()
    for p, req in zip(prompts, sorted(svc._active.values(),
                                      key=lambda r: r.rid)):
        _, cache, _ = tserving.prefill(tp, tcfg, torch.tensor(p[None]))
        n = len(p)
        for k, leaf in svc.pool.leaves.items():
            got = leaf[:, req.pages].reshape(leaf.shape[0], -1,
                                             leaf.shape[-1])
            assert torch.equal(got[:, :n], cache[k][:, 0])
            assert not got[:, n:-(-n // 4) * 4].any()


@pytest.mark.parametrize("path", ["kernel", "gather"])
def test_sampling_stream_independent_of_batch_composition(deepseek, path):
    """The dense family's property holds for MoE only where nothing is
    dropped: at the default capacity factor, which tokens an expert drops
    depends on the other tokens of the batch (in the reference too), so a
    request's stream may change with its neighbours.  At 8.0 (the fixture's
    config) no expert reaches its capacity, and the property holds."""
    _, _, tcfg, tp = deepseek
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab, size=4,
                                               dtype=np.int32)
    sp = tserve.SamplingParams(temperature=0.7, top_k=0, seed=11)

    def service(batch):
        return tserve.GenerateService(tp, tcfg, max_batch=batch,
                                      max_seq=MAX_SEQ, page_size=4,
                                      decode_path=path, sampling=sp,
                                      device="cpu")

    solo = service(1)
    h_solo = solo.submit(prompt, 5)
    solo.run_until_complete()
    batched = service(3)
    h0 = batched.submit(prompt, 5)
    batched.submit(prompt[:3], 4)
    batched.submit(prompt, 6)
    batched.run_until_complete()
    assert h0.generated == h_solo.generated


@pytest.mark.parametrize("mode", [["--continuous"], []])
def test_launcher_serves_deepseek_on_the_cpu(mode, capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", MLA, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4",
                       "--new-tokens", "8"] + mode)
    out = capsys.readouterr().out
    assert "greedy continuations" in out
    if mode:
        assert "terminal states: {'done': 6}" in out
