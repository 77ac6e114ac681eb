"""The port's serving slice on the CPU against the reference, at
``qwen3-1.7b --reduced`` (fp32, 4 layers) with the reference's parameters
(``repro.models.lm.init_params(PRNGKey(0))``) passed through
``repro_torch.models.convert.params_from_reference``.

* prefill and per-step decode logits (contiguous cache and paged) within
  atol 1e-5, rtol 1e-4 of the reference (two float32 implementations of
  the same math);
* ``GenerateService`` on the launcher's workload: greedy tokens equal to
  the reference service's ``gather`` path token for token, on the port's
  ``kernel`` (plain K10 on the CPU), ``bounded`` and ``gather`` paths;
* the block pool, the fault plan and the config copies equal the
  reference's; the transient and sticky NaN cases of
  ``tests/test_faults.py``; the sampling properties of
  ``tests/test_paged_decode.py``; in-place updates that leave every other
  slot's pages and state untouched.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import serving as tserving  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.serve.service import ENG_DECODE  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
PATHS = ("kernel", "bounded", "gather")
# the launcher's workload (launch/serve.py --continuous defaults): 4 slots,
# prompt 8, budgets from {4, 16, 32}, 3 x batch requests, seed 0
BATCH, PLEN, NEW, PAGE = 4, 8, 32, 8
LAUNCH_MAX_SEQ = -(-(PLEN + NEW - 1) // PAGE) * PAGE
MAX_SEQ = 24


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config("qwen3-1.7b").reduced()
    tcfg = tconfigs.get_config("qwen3-1.7b").reduced()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _launcher_workload(vocab):
    rng = np.random.default_rng(0)
    work = []
    for _ in range(3 * BATCH):
        prompt = rng.integers(0, vocab, PLEN, dtype=np.int32)
        work.append((prompt, int(rng.choice([NEW // 8, NEW // 2, NEW]))))
    return work


@pytest.fixture(scope="module")
def launcher_reference(model):
    """The reference service's greedy streams on the launcher workload,
    on its ``gather`` path (run once for the module)."""
    jcfg, jp, _, _ = model
    work = _launcher_workload(jcfg.vocab)
    svc = jserve.GenerateService(jp, jcfg, max_batch=BATCH,
                                 max_seq=LAUNCH_MAX_SEQ, page_size=PAGE,
                                 decode_path="gather")
    hs = [svc.submit(p, n) for p, n in work]
    svc.run_until_complete()
    return work, [h.generated for h in hs], svc.stats


def _service(tp, tcfg, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("page_size", 4)
    return tserve.GenerateService(tp, tcfg, device="cpu", **kw)


def _drained(svc):
    assert not svc._active and not svc._queue
    assert svc.pool.allocated == 0
    svc.pool.check_invariants()


# --- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_copies_equal_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.param_count() == j.param_count()
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS


# --- logits ----------------------------------------------------------------------

@pytest.mark.parametrize("decode", ["contiguous", "paged"])
def test_prefill_and_decode_logits_match_reference(model, decode):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (3, 6)).astype(np.int32)
    jl, jcache, jpos = jserving.prefill(jp, jcfg, jnp.asarray(tokens))
    tl, tcache, tpos = tserving.prefill(tp, tcfg, torch.tensor(tokens))
    assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **TOL)
    assert tpos.tolist() == np.asarray(jpos).tolist()
    s, ps = MAX_SEQ, 4
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, s - 6), (0, 0), (0, 0)])
              for k, v in jcache.items()}
    if decode == "contiguous":
        tcache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, s - 6))
                  for k, v in tcache.items()}
    else:   # the same cache laid out in pages, slot b owning pages b*6..
        n = s // ps
        leaves = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, s - 6))
                  .reshape(v.shape[0], 3 * n, ps, *v.shape[3:])
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
        else:
            tl, leaves = tserving.decode_step_paged(
                tp, tcfg, leaves, rows, torch.tensor(tok), torch.tensor(pos),
                page_size=ps)
        assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        pos = pos + 1


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("serve", [c[:2] for c in _chip_smoke()
                                   .CONFIG_SERVES],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_card_configs_draw_what_chip_smoke_expects(serve):
    """chip_smoke.py's phase 36 models on ``meta`` (``lm.param_shapes``:
    init_params, nothing allocated): their weights are the reference
    config's ``param_count()`` plus the norm scales (2 a layer and the
    final one, which param_count leaves out), at the published widths,
    and the weights and bytes are exactly those phase 36 checks on the
    card."""
    from repro_torch.models import lm as tlm
    arch, layers = serve
    want = {c[0]: c[2:] for c in _chip_smoke().CONFIG_SERVES}[arch]
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
        tcfg = dataclasses.replace(tcfg, n_layers=layers)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    leaves = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)

    walk(tlm.param_shapes(tcfg))
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    assert n == jcfg.param_count() + tcfg.d_model * (2 * tcfg.n_layers + 1)
    assert (n, nbytes) == tuple(want)
    # bf16 matrices; float32 norm scales and MoE router
    f32 = sum(t.numel() for t in leaves if t.dtype == torch.float32)
    assert nbytes == 2 * (n - f32) + 4 * f32


# the dense configs without qk_norm: the port's model matched the reference
# on them at --reduced (the largest gap 4.3e-6), held here at TOL
DENSE_NO_QK_NORM = ("starcoder2-7b", "granite-8b", "phi4-mini-3.8b")


@pytest.mark.parametrize("arch", DENSE_NO_QK_NORM)
def test_dense_configs_without_qk_norm_match_reference(arch):
    """Prefill and one paged decode step at ``--reduced``, the reference's
    parameters through ``convert.params_from_reference``: logits and the
    prefill cache within TOL of the reference's."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    assert not tcfg.qk_norm and tcfg.family == "dense"
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, (3, 6)).astype(np.int32)
    jl, jcache, jpos = jserving.prefill(jp, jcfg, jnp.asarray(tokens))
    tl, tcache, tpos = tserving.prefill(tp, tcfg, torch.tensor(tokens))
    assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **TOL)
    s, ps = 8, 4
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, s - 6), (0, 0), (0, 0)])
              for k, v in jcache.items()}
    leaves = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, s - 6))
              .reshape(v.shape[0], 3 * (s // ps), ps, *v.shape[3:])
              for k, v in tcache.items()}
    rows = torch.arange(3 * (s // ps), dtype=torch.int32).reshape(3, -1)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    jl, _ = jserving.decode_step(jp, jcfg, jcache, jnp.asarray(tok), jpos)
    tl, _ = tserving.decode_step_paged(tp, tcfg, leaves, rows,
                                       torch.tensor(tok), tpos, page_size=ps)
    assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# --- the service on the launcher's workload ---------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_service_greedy_equals_reference_gather(model, launcher_reference,
                                                path):
    _, _, tcfg, tp = model
    work, want, jstats = launcher_reference
    pa_ops.reset_counts()
    svc = tserve.GenerateService(tp, tcfg, max_batch=BATCH,
                                 max_seq=LAUNCH_MAX_SEQ, page_size=PAGE,
                                 decode_path=path, device="cpu")
    hs = [svc.submit(p, n) for p, n in work]
    svc.run_until_complete()
    assert [h.generated for h in hs] == want
    assert all(h.status == "done" for h in hs)
    _drained(svc)
    for k in ("steps", "admitted", "retired", "decode_items",
              "generated_tokens", "pages_attended"):
        assert svc.stats[k] == jstats[k], k
    assert svc.stats["retries"] == 0 and svc.stats["preemptions"] == 0
    # the kernel path ran K10's plain version once per layer per tick
    ticks = svc.stats["steps"] if path == "kernel" else 0
    assert pa_ops.PLAIN_CALLS["paged_gqa"] == tcfg.n_layers * ticks
    assert pa_ops.LAUNCHES["paged_gqa"] == 0


def test_auto_path_and_unsupported_family(model):
    _, _, tcfg, tp = model
    assert _service(tp, tcfg).decode_path == "bounded"   # no card here
    with pytest.raises(ValueError, match="decode_path"):
        _service(tp, tcfg, decode_path="warp")
    # as the reference's service, whatever families lm runs
    for arch in ("zamba2-7b", "whisper-tiny", "internvl2-76b"):
        with pytest.raises(ValueError, match="not wired up"):
            tserve.GenerateService(tp, tconfigs.get_config(arch).reduced(),
                                   device="cpu")


def test_round_timings_in_the_service_metrics(model):
    """Each decode tick records its plan lowering and the host time of
    issuing its round; the round's device span (CUDA events) is recorded
    only on the card."""
    _, _, tcfg, tp = model
    svc = _service(tp, tcfg, decode_path="kernel")
    svc.submit(np.arange(8, dtype=np.int32), 5)
    svc.run_until_complete()
    ticks = svc.metrics.get("serve.decode_plan_s").count
    assert ticks == 4        # prefill yields the first token, 4 ticks the rest
    assert svc.metrics.get("serve.decode_round_s").count == ticks
    assert svc.metrics.get("serve.decode_device_s").count == 0


@pytest.mark.parametrize("path", PATHS)
def test_dropped_service_frees_its_model_at_once(model, path):
    """A service keeps no reference cycle (its registry, engine hooks and
    prefill entry points refer back to it only weakly), so dropping it
    frees the model and pool it holds at once, with the cycle collector
    off: a second model can then take the memory on the card."""
    import gc
    import weakref
    _, _, tcfg, tp = model
    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}

    params = clone(tp)
    svc = _service(params, tcfg, decode_path=path)
    for i in range(2):
        svc.submit(np.arange(8, dtype=np.int32) + i, 4)
    svc.run_until_complete()
    weights = weakref.ref(params["embed"]["tok"])
    pool = weakref.ref(next(iter(svc.pool.leaves.values())))
    dropped = weakref.ref(svc)
    del params
    was_on = gc.isenabled()
    gc.disable()
    try:
        del svc
        assert dropped() is None and weights() is None and pool() is None
    finally:
        if was_on:
            gc.enable()


# --- block pool and fault plan ------------------------------------------------------

def test_blockpool_assignments_equal_reference():
    """A seeded run of allocations and frees hands out the same pages,
    and admission lowers to the same single conflict-free round."""
    rng = np.random.default_rng(4)
    jp, tp = jserve.BlockPool(37, 4), tserve.BlockPool(37, 4)
    live = []
    for i in range(200):
        if live and (rng.random() < 0.45 or jp.free_count < 6):
            owner = live.pop(int(rng.integers(0, len(live))))
            jp.free(owner[1])
            tp.free(owner[1])
            continue
        need = int(rng.integers(1, 6))
        pages = jp.alloc(need, owner=i)
        assert tp.alloc(need, owner=i) == pages
        live.append((i, pages))
        assert tp._free == jp._free
    tp.check_invariants()
    assignments = [p for _, p in live]
    _, jplan = jp.plan_admission(assignments)
    _, tplan = tp.plan_admission(assignments)
    assert tplan.nr_rounds == jplan.nr_rounds == 1
    with pytest.raises(tserve.AdmissionConflict):
        tp.plan_admission([assignments[0], assignments[0][:1]])


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_fault_plan_fires_as_reference(model, seed):
    """The same seeded plan has the same events and, replayed against the
    same trace on both services, fires the same events at the same ticks
    with the same recovery counts and tokens."""
    jcfg, jp, tcfg, tp = model
    jplan = jserve.FaultPlan.seeded(seed, 24, p_nan=0.3, p_admission=0.1,
                                    p_drop=0.1)
    tplan = tserve.FaultPlan.seeded(seed, 24, p_nan=0.3, p_admission=0.1,
                                    p_drop=0.1)
    assert [dataclasses.asdict(e) for e in tplan.events] == [
        dataclasses.asdict(e) for e in jplan.events]
    trace = jserve.open_loop_trace(4, mean_interarrival=1.0,
                                   prompt_lens=(3, 5), new_token_lens=(4, 6),
                                   vocab_size=jcfg.vocab, seed=seed)
    ref = jserve.GenerateService(jp, jcfg, max_batch=2, max_seq=MAX_SEQ,
                                 page_size=4, decode_path="bounded",
                                 faults=jplan)
    svc = _service(tp, tcfg, decode_path="bounded", faults=tplan)
    from repro.serve.traffic import replay as jreplay
    from repro_torch.serve.traffic import replay as treplay
    jh, th = jreplay(ref, trace), treplay(svc, trace)
    fired = [(t, dataclasses.asdict(e), a) for t, e, a in svc.faults_fired]
    assert fired == [(t, dataclasses.asdict(e), a)
                     for t, e, a in ref.faults_fired]
    assert svc.stats == ref.stats
    assert [h.generated for h in th] == [h.generated for h in jh]
    _drained(svc)


def _reference_tokens(model, prompt, n_new):
    """Sequential single-request greedy stream of the reference (as in
    tests/test_faults.py)."""
    jcfg, jp, _, _ = model
    logits, cache, pos = jserving.prefill(jp, jcfg, jnp.asarray(prompt[None]))
    cache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, MAX_SEQ - v.shape[2])]
                        + [(0, 0)] * (v.ndim - 3)) for k, v in cache.items()}
    toks = [int(np.argmax(logits[0]))]
    for _ in range(n_new - 1):
        logits, cache = jserving.decode_step(
            jp, jcfg, cache, jnp.asarray([[toks[-1]]], jnp.int32), pos)
        toks.append(int(np.argmax(logits[0])))
        pos = pos + 1
    return toks


@pytest.mark.parametrize("sticky", [1, 3])
def test_nan_fault_recovers_bitwise(model, sticky):
    """tests/test_faults.py:70,90 on the port.  sticky=1: the guard trips,
    the gather retry recomputes the tick from the restored slot state and
    the stream is unharmed.  sticky=3 poisons the retry too: the request
    is preempted, its pages reclaimed, and re-admission continues the
    greedy stream.  Both need the retry to restore the pre-round values,
    which the in-place round has overwritten: the snapshot is a clone."""
    _, _, tcfg, tp = model
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab, size=5,
                                               dtype=np.int32)
    plan = tserve.FaultPlan([tserve.FaultEvent(2, "nan_decode",
                                               sticky=sticky)])
    svc = _service(tp, tcfg, decode_path="kernel", faults=plan)
    h = svc.submit(prompt, 6)
    svc.run_until_complete()
    assert h.status == "done"
    assert h.generated == _reference_tokens(model, prompt, 6)
    assert svc.stats["faults_injected"] == 1
    if sticky == 1:
        assert svc.stats["retries"] == 1 and svc.stats["preemptions"] == 0
        assert h.rid in svc.retried_rids and h.rid not in svc.faulted_rids
    else:
        assert svc.stats["preemptions"] == 1 and h.preemptions == 1
        assert svc.stats["retries"] >= 1 and h.rid in svc.faulted_rids
    assert svc.decode_path_active != "kernel"      # degraded one rung
    _drained(svc)


def test_hooks_follow_the_degrade_ladder(model):
    """``GenerateService.hooks`` is the active rung's ``EngineHooks``:
    the lower rung's after a fault degrades the ladder, the selected
    path's again after the clean ticks promote it back."""
    _, _, tcfg, tp = model
    plan = tserve.FaultPlan([tserve.FaultEvent(1, "nan_decode", sticky=1)])
    svc = _service(tp, tcfg, decode_path="kernel", faults=plan)
    assert svc.hooks is svc._hooks_by_path["kernel"]
    svc.submit(np.arange(5, dtype=np.int32), 12)
    seen = []
    while svc.step():
        seen.append(svc.decode_path_active)
        assert svc.hooks is svc._hooks_by_path[svc.decode_path_active]
    assert "bounded" in seen
    assert "kernel" in seen[seen.index("bounded"):]   # promoted back
    assert svc.hooks is svc._hooks_by_path["kernel"]


# --- sampling ------------------------------------------------------------------------

PLENS, BUDGETS = (3, 5, 3, 6), (3, 6, 2, 4)


def _streams(tp, tcfg, **kw):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab, size=n, dtype=np.int32)
               for n in PLENS]
    svc = _service(tp, tcfg, max_seq=16, **kw)
    hs = [svc.submit(p, n) for p, n in zip(prompts, BUDGETS)]
    svc.run_until_complete()
    _drained(svc)
    return [h.generated for h in hs]


@pytest.mark.parametrize("path", PATHS)
def test_sampling_deterministic_and_per_request(model, path):
    _, _, tcfg, tp = model
    sp = tserve.SamplingParams(temperature=0.8, top_k=8, seed=7)
    a = _streams(tp, tcfg, decode_path=path, sampling=sp)
    assert a == _streams(tp, tcfg, decode_path=path, sampling=sp)
    assert a != _streams(tp, tcfg, decode_path=path)
    if path != "kernel":
        assert a == _streams(tp, tcfg, decode_path="kernel", sampling=sp)


def test_sampling_stream_independent_of_batch_composition(model):
    _, _, tcfg, tp = model
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab, size=4,
                                               dtype=np.int32)
    sp = tserve.SamplingParams(temperature=0.7, top_k=0, seed=11)
    solo = _service(tp, tcfg, max_batch=1, sampling=sp)
    h_solo = solo.submit(prompt, 5)
    solo.run_until_complete()
    batched = _service(tp, tcfg, max_batch=3, sampling=sp)
    h0 = batched.submit(prompt, 5)      # rid 0 in both services
    batched.submit(prompt[:3], 4)
    batched.submit(prompt, 6)
    batched.run_until_complete()
    assert h0.generated == h_solo.generated


def test_top_k_sampling_stays_in_the_top_k():
    logits = torch.tensor(np.random.default_rng(5).standard_normal((6, 50)),
                          dtype=torch.float32)
    rids, pos = torch.arange(6), torch.full((6,), 9)
    for seed in range(20):
        tok = tserving.sample_tokens(logits, 1.0, 3, seed, rids, pos)
        top = torch.topk(logits, 3).indices
        assert (top == tok[:, None].long()).any(dim=1).all()
    greedy = tserving.sample_tokens(logits, 0.0, 0, 0, rids, pos)
    assert torch.equal(greedy.long(), torch.argmax(logits, -1))


# --- in-place updates touch only their own slot --------------------------------------

def _two_active(tp, tcfg, path):
    svc = _service(tp, tcfg, decode_path=path)
    rng = np.random.default_rng(6)
    for n in (5, 7):
        svc.submit(rng.integers(0, tcfg.vocab, size=n, dtype=np.int32), 8)
    svc._admit()
    assert sorted(svc._active) == [0, 1]
    return svc


def _page_cells(svc, req):
    ps = svc.pool.page_size
    return req.pages[req.pos // ps], req.pos % ps


@pytest.mark.parametrize("path", PATHS)
def test_decode_round_writes_only_its_slots_cell(model, path):
    """One round for slot 0 alone writes the one (page, offset) cell of
    slot 0 in every layer and advances slot 0's state; slot 1's pages and
    every other byte of the pool, and slot 1's state, stay bitwise."""
    _, _, tcfg, tp = model
    svc = _two_active(tp, tcfg, path)
    req = svc._active[0]
    leaves0 = {k: v.clone() for k, v in svc.pool.leaves.items()}
    state0 = [b.clone() for b in svc._buffers()[:5]]
    desc = torch.tensor([[ENG_DECODE, 0, req.pos]], dtype=torch.int32)
    hooks = svc._hooks_by_path[path]
    hooks.round_fn(desc, (0, 1), svc._statics_for(path), svc._buffers())
    page, off = _page_cells(svc, req)
    for k, leaf in svc.pool.leaves.items():
        assert not torch.equal(leaf[:, page, off], leaves0[k][:, page, off])
        leaf[:, page, off] = leaves0[k][:, page, off]
        assert torch.equal(leaf, leaves0[k]), k
    for now, before in zip(svc._buffers()[:5], state0):
        assert torch.equal(now[1], before[1])
    assert int(svc._pos[0]) == req.pos + 1


def test_preempt_scatters_only_its_slot(model):
    _, _, tcfg, tp = model
    svc = _two_active(tp, tcfg, "kernel")
    leaves0 = {k: v.clone() for k, v in svc.pool.leaves.items()}
    state0 = [b.clone() for b in svc._buffers()[:5]]
    svc._preempt(0, requeue=True, reason="test")
    for now, before in zip(svc._buffers()[:5], state0):
        assert torch.equal(now[1], before[1])
        assert not now[0].any()
    for k, leaf in svc.pool.leaves.items():
        assert torch.equal(leaf, leaves0[k])
    svc.run_until_complete()
    _drained(svc)


def test_traced_service_run_exports_a_valid_trace(model, tmp_path):
    """--trace: request lifecycles, decode spans and counter tracks of a
    service run render as Chrome trace JSON the exporter's check accepts
    (the port's copy of repro.obs.export)."""
    from repro_torch import obs
    from repro_torch.obs import export
    _, _, tcfg, tp = model
    obs.enable()
    try:
        svc = _service(tp, tcfg, decode_path="kernel")
        for n in (3, 5):
            svc.submit(np.arange(n, dtype=np.int32), 3)
        svc.run_until_complete()
        path = str(tmp_path / "serve.json")
        export.write_chrome_trace(path, registry=svc.metrics)
    finally:
        obs.disable()
    info = export.validate_chrome_trace(path)
    assert "serve.pages_in_use" in info["counter_tracks"]
    assert {"measured", "requests"} <= set(info["processes"])


def test_sdpa_chunked_matches_reference():
    """The online-softmax prefill attention that prompts longer than
    ``attn_chunk`` take (2048 at full width), at a small chunk."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
               for _ in range(3))
    want = jlayers.sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)), 4)
    got = tlayers.sdpa_chunked(*(torch.tensor(a) for a in (q, k, v)), 4)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = tlayers.sdpa_full(*(torch.tensor(a) for a in (q, k, v)))
    assert_allclose(got.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("mode", [["--continuous"], []])
def test_launcher_runs_on_the_cpu_when_asked(mode, capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "qwen3-1.7b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "4",
                       "--new-tokens", "8"] + mode)
    out = capsys.readouterr().out
    assert "greedy continuations" in out
    if mode:
        assert "terminal states: {'done': 6}" in out
    whisper = ["--arch", "whisper-tiny", "--reduced", "--device", "cpu",
               "--batch", "2", "--prompt-len", "4", "--new-tokens", "4"]
    if mode:        # the service refuses the family, as the reference's
        with pytest.raises(ValueError, match="not wired up"):
            launch_serve.main(whisper + mode)
    else:
        launch_serve.main(whisper)
        assert "decode 4 tokens × batch 2" in capsys.readouterr().out
