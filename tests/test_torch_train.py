"""The port's training stack on the CPU against the reference: optimizers,
loss, train step, restartable loop and launcher.

* twins of ``tests/test_traincore.py`` (the optimizers descend,
  Adafactor's memory is factored, clipping, the schedule, bit-identical
  failure recovery — bitwise here, on the CPU);
* ``adamw_update`` and ``adafactor_update`` against the reference's on the
  same gradients, 3 steps, over 1-D, 2-D and stacked 3-D leaves, within
  rtol 1e-6 (the parameters also within 1e-6 of the learning rate).  The optimizers are held on shared gradients because Adam's
  first step is about sign(g)·lr: in a whole-step comparison an update
  flips where |g| sits at the two packages' rounding level;
* ``loss_fn`` (loss, ce, aux, z, ntok) and every gradient leaf against
  ``jax.value_and_grad(repro.models.lm.loss_fn)``, within the reference's
  kernel-test tolerance (atol 2e-5, rtol 1e-4), at ``qwen3-1.7b
  --reduced``, ``deepseek-v3-671b --reduced`` (MoE + MLA, capacity factor
  8.0 so nothing drops) and a reduced dense config whose ``attn_chunk``
  (8) is below the sequence (32), so ``sdpa_chunked``'s backward is held
  too, each with and without a ``loss_mask``;
* one ``make_train_step`` step from the same ``(params, opt_state)`` (the
  reference's, after one reference step, through ``params_from_reference``
  and ``opt_state_from_reference``): loss and grad_norm within that
  tolerance, the moments everywhere and the parameters where |g| exceeds
  the gradient tolerance;
* per-layer remat on and off bitwise equal, remat running each block
  twice; a family the reference does not know raises naming the families
  (the SSM family's training is ``tests/test_torch_ssm.py``, the hybrid,
  enc-dec and VLM families' ``tests/test_torch_hybrid.py``,
  ``test_torch_encdec.py`` and ``test_torch_vlm.py``); the launcher runs
  on the CPU and, without ``--device cpu`` and without a card, raises.

Reference calls are jitted once per configuration (four compiles).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.trainer import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim.tree import flatten_with_path, leaves  # noqa: E402
from repro_torch.trainer import loop as tloop  # noqa: E402
from repro_torch.trainer import steps as tsteps  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-4)      # the reference's kernel-test tolerance
# optimizers on shared gradients: rtol 1e-6, and for the parameters also
# 1e-6 of the learning rate (the size of a step): a parameter that a step
# takes near zero keeps no relative precision in the difference
OPT_RTOL, OPT_LR = 1e-6, 1e-2
B, S = 2, 32
CASES = {
    "qwen3": ("qwen3-1.7b", {}),
    "deepseek": ("deepseek-v3-671b", {"capacity_factor": 8.0}),
    "chunked": ("qwen3-1.7b", {"attn_chunk": 8}),
}
TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
            vocab=256)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These models are tiny: one intra-op thread is as fast, and the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _by_path(tree):
    """{path of str: numpy leaf} of a reference tree."""
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _paths(tree):
    return {tuple(str(k) for k in path): leaf
            for path, leaf in flatten_with_path(tree)}


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return toks, mask


@pytest.fixture(scope="module")
def cases():
    """Per case: configs, both packages' parameters, a batch and the
    reference's loss, metrics and gradients with and without the mask
    (one jit; "without" is the reference's default mask of ones)."""
    out = {}
    for name, (arch, over) in CASES.items():
        jcfg = jconfigs.get_config(arch).reduced(**over)
        tcfg = tconfigs.get_config(arch).reduced(**over)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        tp = convert.params_from_reference(_np_tree(jp), tcfg)
        toks, mask = _batch(jcfg.vocab, 1)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))
        ref = {}
        for masked in (False, True):
            m = mask if masked else np.ones_like(mask)
            (loss, metrics), grads = vg(jp, {"tokens": jnp.asarray(toks),
                                             "loss_mask": jnp.asarray(m)})
            ref[masked] = (float(loss), {k: float(v) for k, v in
                                         metrics.items()}, _by_path(grads))
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, toks=toks,
                         mask=mask, ref=ref, vg=vg)
    return out


def _tbatch(case, masked):
    b = {"tokens": torch.tensor(case["toks"])}
    if masked:
        b["loss_mask"] = torch.tensor(case["mask"])
    return b


# --- loss and gradients against jax.value_and_grad -------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_every_gradient_leaf_match_reference(cases, name, masked):
    case = cases[name]
    want_loss, want_metrics, want_grads = case["ref"][masked]
    loss, metrics, grads = tsteps.loss_and_grads(case["tp"], case["tcfg"],
                                                 _tbatch(case, masked))
    assert_allclose(float(loss), want_loss, **TOL)
    assert set(metrics) == set(want_metrics) == {"ce", "aux", "z", "ntok"}
    for k in want_metrics:
        assert_allclose(float(metrics[k]), want_metrics[k], **TOL)
    got, params = _paths(grads), _paths(case["tp"])
    assert set(got) == set(want_grads)
    for path, g in got.items():
        assert g.dtype == params[path].dtype
        assert_allclose(g.numpy(), want_grads[path], err_msg=str(path), **TOL)
    if name == "deepseek":
        assert float(metrics["aux"]) > 0
    assert float(metrics["ntok"]) == (case["mask"][:, :-1].sum() if masked
                                      else B * (S - 1))
    assert not any(p.requires_grad for p in leaves(case["tp"]))


def test_chunked_case_takes_the_chunked_attention(cases, monkeypatch):
    from repro_torch.models import layers
    calls = []
    real = layers.sdpa_chunked
    monkeypatch.setattr(layers, "sdpa_chunked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    case = cases["chunked"]
    tsteps.loss_and_grads(case["tp"], case["tcfg"], _tbatch(case, False))
    # the forward and the remat's recompute, on each of 4 layers
    assert len(calls) == 2 * case["tcfg"].n_layers


@pytest.mark.parametrize("name", ["qwen3", "deepseek"])
def test_remat_on_and_off_bitwise_equal(cases, name, monkeypatch):
    case = cases[name]
    counted = []
    real = tlm._block
    monkeypatch.setattr(tlm, "_block",
                        lambda *a, **k: counted.append(1) or real(*a, **k))
    runs = {}
    for remat in (True, False):
        counted.clear()
        cfg = dataclasses.replace(case["tcfg"], remat=remat)
        runs[remat] = tsteps.loss_and_grads(case["tp"], cfg,
                                            _tbatch(case, True))
        assert len(counted) == cfg.n_layers * (2 if remat else 1)
    (l1, m1, g1), (l0, m0, g0) = runs[True], runs[False]
    assert torch.equal(l1, l0)
    assert all(torch.equal(m1[k], m0[k]) for k in m1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g0)))
    counted.clear()
    with torch.no_grad():                  # serving pays for no recompute
        tlm.forward(case["tp"], case["tcfg"], torch.tensor(case["toks"]))
    assert len(counted) == case["tcfg"].n_layers


# --- one train step from the same (params, opt_state) ----------------------

def test_train_step_matches_reference(cases):
    case = cases["qwen3"]
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    kw = dict(optimizer="adamw", lr=1e-2, warmup=1, total_steps=10)
    jstep, jinit = jsteps.make_train_step(jcfg, **kw)
    jstep = jax.jit(jstep)
    toks0, _ = _batch(jcfg.vocab, 2)
    jp1, js1, _ = jstep(case["jp"], jinit(case["jp"]),
                        {"tokens": jnp.asarray(toks0)})
    batch = {"tokens": jnp.asarray(case["toks"]),
             "loss_mask": jnp.asarray(case["mask"])}
    tp = convert.params_from_reference(_np_tree(jp1), tcfg)
    ts = convert.opt_state_from_reference(_np_tree(js1), tcfg)
    assert int(ts.step) == 1
    _, want_g = case["vg"](jp1, batch)
    jp2, js2, jm = jstep(jp1, js1, batch)

    tstep, _ = tsteps.make_train_step(tcfg, **kw)
    tp2, ts2, tm = tstep(tp, ts, {"tokens": torch.tensor(case["toks"]),
                                  "loss_mask": torch.tensor(case["mask"])})
    assert tp2 is tp and int(ts2.step) == 2
    for k in ("loss", "grad_norm", "ce", "z", "ntok"):
        assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    scale = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
    g = _by_path(want_g)
    want_p, got_p = _by_path(jp2), _paths(tp2)
    checked = 0
    for path, p in got_p.items():
        big = np.abs(g[path] * scale) > TOL["atol"]
        checked += int(big.sum())
        assert_allclose(p.numpy()[big], want_p[path][big], err_msg=str(path),
                        **TOL)
    assert checked > 1000
    want_s, got_s = _by_path(js2.inner), _paths(ts2.inner)
    assert set(want_s) == set(got_s)
    for path, m in got_s.items():
        assert_allclose(m.numpy(), want_s[path], err_msg=str(path), **TOL)


def test_opt_state_from_reference_checks_shapes(cases):
    case = cases["deepseek"]
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    for name, init in (("adamw", joptim.adamw_init),
                       ("adafactor", joptim.adafactor_init)):
        st = convert.opt_state_from_reference(_np_tree(init(case["jp"])),
                                              tcfg)
        want = toptim.make_optimizer(name, 1e-3)[0](case["tp"])
        assert [tuple(x.shape) for x in leaves(st)] == [
            tuple(x.shape) for x in leaves(want)]
        assert st.step.dtype == torch.int32
    bad = _np_tree(joptim.adamw_init(case["jp"]))
    bad.inner["m"]["final_norm"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        convert.opt_state_from_reference(bad, tcfg)


# --- the optimizers on shared gradients ------------------------------------

LEAF_SHAPES = {"b": (8,), "w": (16, 12), "stack": (3, 16, 12),
               "norms": (3, 16)}


def _opt_inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(dtype)
              for k, s in LEAF_SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1)
                  ).astype(np.float32) for k, s in LEAF_SHAPES.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_matches_reference_on_shared_gradients(kind):
    params, grads = _opt_inputs(3)
    sched_j = joptim.cosine_schedule(OPT_LR, 2, 10)
    sched_t = toptim.cosine_schedule(OPT_LR, 2, 10)
    jinit, jupd = joptim.make_optimizer(kind, sched_j)
    tinit, tupd = toptim.make_optimizer(kind, sched_t)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jinit(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = tinit(tp)
    for g in grads:
        jp, js = jupd({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp2, ts = tupd({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        assert tp2 is tp
        for k in LEAF_SHAPES:
            assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=OPT_RTOL,
                            atol=OPT_RTOL * OPT_LR, err_msg=k)
        want_s, got_s = _by_path(js.inner), _paths(ts.inner)
        assert set(want_s) == set(got_s)
        for path in want_s:
            assert_allclose(got_s[path].numpy(), want_s[path],
                            rtol=OPT_RTOL, atol=0, err_msg=str(path))
        assert int(ts.step) == int(js.step)
        assert ts.step.dtype == torch.int32


def test_bf16_parameters_update_in_float32_and_round_once():
    """bf16 leaves: the moments (float32) within rtol 1e-6 of the
    reference's, the leaves within one bf16 ulp (a float32 update one ulp
    apart may round to the neighbouring bf16)."""
    params, grads = _opt_inputs(4)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tp = {k: torch.tensor(v).to(torch.bfloat16) for k, v in params.items()}
    js, ts = joptim.adamw_init(jp), toptim.adamw_init(tp)
    for g in grads:
        jp, js = joptim.adamw_update({k: jnp.asarray(v, jnp.bfloat16)
                                      for k, v in g.items()}, js, jp, OPT_LR)
        _, ts = toptim.adamw_update({k: torch.tensor(v).to(torch.bfloat16)
                                     for k, v in g.items()}, ts, tp, OPT_LR)
        for k in LEAF_SHAPES:
            assert tp[k].dtype == torch.bfloat16
            want = np.asarray(jp[k], np.float32)
            assert_allclose(tp[k].float().numpy(), want, rtol=2 ** -7,
                            atol=OPT_RTOL * OPT_LR, err_msg=k)
            for m in ("m", "v"):
                assert_allclose(ts.inner[m][k].numpy(),
                                np.asarray(js.inner[m][k]), rtol=OPT_RTOL,
                                err_msg=f"{m}/{k}")


class TestOptimizers:
    """Twins of tests/test_traincore.py::TestOptimizers on the port."""

    @staticmethod
    def _quadratic(params):
        return sum(torch.sum(p * p) for p in params.values())

    @pytest.mark.parametrize("kind", ["adamw", "adafactor"])
    def test_optimizer_descends(self, kind):
        params = {"w": torch.ones((8, 4)), "b": torch.ones((4,))}
        if kind == "adamw":
            state = toptim.adamw_init(params)
            upd = lambda g, s, p: toptim.adamw_update(g, s, p, lr=0.05,
                                                      wd=0.0)
        else:
            state = toptim.adafactor_init(params)
            upd = lambda g, s, p: toptim.adafactor_update(g, s, p, lr=0.05)
        loss0 = float(self._quadratic(params))
        for _ in range(50):
            for p in params.values():
                p.requires_grad_(True)
            g = torch.autograd.grad(self._quadratic(params),
                                    list(params.values()))
            for p in params.values():
                p.requires_grad_(False)
            params, state = upd(dict(zip(params, g)), state, params)
        assert float(self._quadratic(params)) < 0.2 * loss0

    def test_adafactor_memory_is_factored(self):
        state = toptim.adafactor_init({"w": torch.ones((256, 512))})
        assert sum(x.numel() for x in leaves(state.inner)) == 256 + 512

    def test_clip_by_global_norm(self):
        g = {"a": torch.full((10,), 100.0),
             "h": torch.full((10,), 100.0, dtype=torch.bfloat16)}
        clipped, norm = toptim.clip_by_global_norm(g, 1.0)
        assert clipped is g and g["h"].dtype == torch.bfloat16
        assert float(toptim.global_norm(clipped)) == pytest.approx(
            1.0, rel=1e-2)
        assert float(norm) == pytest.approx(np.sqrt(20) * 100, rel=1e-5)

    def test_cosine_schedule(self):
        lr = toptim.cosine_schedule(1.0, warmup=10, total=110)
        assert float(lr(torch.tensor(0))) == 0.0
        assert float(lr(torch.tensor(10))) == pytest.approx(1.0, abs=1e-6)
        assert float(lr(torch.tensor(110))) == pytest.approx(0.0, abs=1e-6)
        want = joptim.cosine_schedule(1.0, 10, 110)
        for s in (0, 3, 10, 47, 109, 110, 200):
            assert float(lr(torch.tensor(s, dtype=torch.int32))) == float(
                want(jnp.asarray(s, jnp.int32)))


def test_default_optimizer_follows_the_reference():
    for arch in ("qwen3-1.7b", "deepseek-v3-671b", "kimi-k2-1t-a32b"):
        assert toptim.default_optimizer_for(tconfigs.get_config(arch)) == \
            joptim.default_optimizer_for(jconfigs.get_config(arch))


# --- the loop ----------------------------------------------------------------

def test_failure_recovery_bit_identical(tmp_path):
    """Train A: uninterrupted 20 steps.  Train B: killed at step 12,
    restarted, resumed from its checkpoint.  The losses, the parameters
    and the moments must match bit for bit."""
    cfg = tconfigs.get_config("qwen3-1.7b").reduced(**TINY)
    common = dict(steps=20, seq_len=32, global_batch=4, ckpt_every=5,
                  log_every=100, log_fn=lambda s: None, device="cpu")
    pa, oa, hist_a = tloop.run_training(cfg, str(tmp_path / "a"), **common)
    with pytest.raises(tloop.InjectedFailure):
        tloop.run_training(cfg, str(tmp_path / "b"), fail_at_step=12,
                           **common)
    logs = []
    pb, ob, hist_b = tloop.run_training(cfg, str(tmp_path / "b"),
                                        **dict(common, log_fn=logs.append))
    assert logs[0] == "[resume] restored step 10"
    assert [s for s, _ in hist_b] == list(range(10, 20))
    tail_a = dict(hist_a)
    for step, loss in hist_b:
        assert tail_a[step] == loss, f"divergence at step {step}"
    assert all(torch.equal(x, y)
               for x, y in zip(leaves((pa, oa)), leaves((pb, ob))))
    assert int(ob.step) == 20
    assert sorted(os.listdir(tmp_path / "b" / "ckpt")) == [
        "step_00000010", "step_00000015", "step_00000020"]


def test_loop_traces_steps_and_stops_on_nonfinite_loss(tmp_path, monkeypatch):
    from repro_torch import obs
    cfg = tconfigs.get_config("qwen3-1.7b").reduced(**TINY)
    tracer = obs.enable()
    try:
        for steps in (3, 4):           # the second run resumes from step 3
            tloop.run_training(cfg, str(tmp_path / "a"), steps, seq_len=16,
                               global_batch=2, ckpt_every=2, device="cpu",
                               log_fn=lambda s: None)
    finally:
        obs.disable()
    spans = [s for s in tracer.spans if s.name == "train.step"]
    assert [s.args["step"] for s in spans] == [0, 1, 2, 3]
    assert all(np.isfinite(s.args["loss"]) for s in spans)
    by_name = lambda n: [s.args["step"] for s in tracer.spans if s.name == n]
    assert by_name("train.ckpt_save") == [2, 3, 4, 4]
    assert by_name("train.ckpt_restore") == [3]
    real = tsteps.loss_and_grads

    def poisoned(params, cfg, batch):
        loss, metrics, grads = real(params, cfg, batch)
        return loss * float("nan"), metrics, grads

    monkeypatch.setattr(tsteps, "loss_and_grads", poisoned)
    with pytest.raises(FloatingPointError, match="step 0"):
        tloop.run_training(cfg, str(tmp_path / "b"), 2, seq_len=16,
                           global_batch=2, ckpt_every=0, device="cpu",
                           log_fn=lambda s: None)


def test_deterministic_mode_needs_cublas_config(monkeypatch):
    """On the card the loop turns deterministic algorithms on and restores
    the previous setting; without ``CUBLAS_WORKSPACE_CONFIG`` it raises
    rather than train without restart-exactness."""
    cuda = torch.device("cuda")
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        with tloop.deterministic(cuda):
            pass
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    with tloop.deterministic(cuda):
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.utils.deterministic.fill_uninitialized_memory is False
    assert torch.are_deterministic_algorithms_enabled() == before
    assert torch.utils.deterministic.fill_uninitialized_memory is fill
    with tloop.deterministic(torch.device("cpu")):
        assert torch.are_deterministic_algorithms_enabled() == before


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-tiny",
                                  "internvl2-76b"])
def test_other_families_raise_naming_their_slice(arch, tmp_path):
    """These families came with their slice (their tests are
    ``tests/test_torch_hybrid.py``, ``test_torch_encdec.py`` and
    ``test_torch_vlm.py``); a family the reference does not know still
    raises, naming the families there are."""
    cfg = tconfigs.get_config(arch).reduced()
    assert cfg.family in tlm.FAMILIES
    bad = dataclasses.replace(cfg, family=cfg.family + "2")
    with pytest.raises(ValueError, match="unknown family"):
        tlm.loss_fn({}, bad, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(ValueError, match="unknown family"):
        tloop.run_training(bad, str(tmp_path), 1, device="cpu")


def test_run_training_defaults_to_cuda_and_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = tconfigs.get_config("qwen3-1.7b").reduced(**TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.run_training(cfg, str(tmp_path), 1)
    assert launch_train.build_parser().parse_args(
        ["--arch", "qwen3-1.7b"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps",
                           "1", "--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_launcher_trains_on_the_cpu(tmp_path):
    trace = tmp_path / "t.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--reduced", "--steps", "5", "--device", "cpu",
         "--workdir", str(tmp_path / "w"), "--ckpt-every", "2",
         "--trace", str(trace)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "done: 5 steps" in out.stdout
    assert sorted(os.listdir(tmp_path / "w" / "ckpt")) == [
        "step_00000002", "step_00000004", "step_00000005"]
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(e.get("name") == "train.step" for e in events) == 5


def test_training_frees_its_tensors_without_the_cycle_collector(tmp_path):
    """Dropping what run_training and a train step return frees every
    tensor at once (no reference cycle holds a leaf), so a full-width
    model's memory goes back to the card before the next one is built."""
    import gc
    import weakref
    cfg = tconfigs.get_config("deepseek-v3-671b").reduced(**TINY)
    gc.collect()
    gc.disable()
    try:
        for opt in ("adamw", "adafactor"):
            p, o, _ = tloop.run_training(
                cfg, str(tmp_path / opt), 3, seq_len=16, global_batch=2,
                ckpt_every=2, optimizer=opt, device="cpu",
                log_fn=lambda s: None)
            step, _ = tsteps.make_train_step(cfg, optimizer=opt)
            p, o, m = step(p, o, {"tokens": torch.zeros((2, 16),
                                                        dtype=torch.int32)})
            refs = [weakref.ref(t) for t in leaves((p, o, m))]
            del p, o, m
            assert all(r() is None for r in refs), opt
    finally:
        gc.enable()
