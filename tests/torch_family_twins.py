"""Checks shared by the port's hybrid, enc-dec and VLM test files
(``test_torch_hybrid.py``, ``test_torch_encdec.py``, ``test_torch_vlm.py``):
the port against the reference at ``--reduced`` with the reference's
parameters (``repro.models.lm.init_params(PRNGKey(0))``, jitted)
converted by
``repro_torch.models.convert``, on the same inputs drawn with numpy from
a seed (the stub modality inputs x 0.02, as ``tests/test_archs_smoke.py``
draws them).

Tolerances are the repo's: the reference's kernel-test tolerance (atol
2e-5, rtol 1e-4) for the forward, the loss and every gradient leaf; the
serving tolerance of ``tests/test_torch_serve.py`` (atol 1e-5, rtol 1e-4)
for prefill and decode logits and caches; the reference's own
prefill→decode consistency bound (atol 2e-4, rtol 1e-3,
``tests/test_archs_smoke.py``).

Each test file shares one reference pass (forward, prefill, one decode
step) and one jitted ``value_and_grad`` through module fixtures.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import optim as joptim
from repro.models import lm as jlm
from repro.models import serving as jserving
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import lm as tlm
from repro_torch.models import serving as tserving
from repro_torch.optim.tree import flatten_with_path, leaves, tree_map
from repro_torch.trainer import loop as tloop
from repro_torch.trainer import steps as tsteps

TOL = dict(atol=2e-5, rtol=1e-4)         # the reference's kernel tests
SERVE_TOL = dict(atol=1e-5, rtol=1e-4)   # tests/test_torch_serve.py
CONSIST_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_archs_smoke.py
PAD = 4                                  # decode positions past the prompt
SEQ_LEAVES = ("k", "v")


class Model(NamedTuple):
    jcfg: object
    jp: dict
    tcfg: object
    tp: dict


def load(arch: str, **over) -> Model:
    """The reference's parameters at ``--reduced`` (with ``over``) and the
    port's conversion of them."""
    jcfg = jconfigs.get_config(arch).reduced(**over)
    tcfg = tconfigs.get_config(arch).reduced(**over)
    jp = jax.jit(jlm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    return Model(jcfg, jp, tcfg,
                 convert.params_from_reference(np_tree(jp), tcfg))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat_ref(tree) -> dict:
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_port(tree) -> dict:
    return {tuple(str(k) for k in path): v.detach().numpy()
            for path, v in flatten_with_path(tree)}


def assert_trees_close(got: dict, want: dict, tol: dict) -> None:
    got, want = flat_port(got), flat_ref(want)
    assert set(got) == set(want)
    for path, v in got.items():
        assert v.shape == want[path].shape, path
        assert_allclose(v, want[path], err_msg=str(path), **tol)


def make_batch(cfg, b: int, s: int, seed: int, mask: bool = False) -> dict:
    """Tokens (B, S) and the family's stub inputs, numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vis_embeds"] = (rng.standard_normal(
            (b, cfg.n_vis_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    if mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return batch


def as_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


def extras(batch: dict) -> dict:
    return {k: v for k, v in batch.items()
            if k not in ("tokens", "loss_mask")}


def ref_pad(cache, extra: int):
    """The reference's cache padded as ``serving.pad_seq`` pads the port's:
    the ``k``/``v`` leaves but those under ``cross``."""
    def pad(path, a):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[-1] in SEQ_LEAVES and "cross" not in keys:
            widths = [(0, 0)] * a.ndim
            widths[2] = (0, extra)
            return jnp.pad(a, widths)
        return a
    return jax.tree_util.tree_map_with_path(pad, cache)


def reference_run(m: Model, batch: dict) -> dict:
    """One reference pass on ``batch``: the forward's hidden states and
    logits; the prefill of all but the last token (logits, cache,
    next_pos); one decode step of the last token against the cache padded
    by ``PAD`` (logits, cache)."""
    jb = as_jax(batch)
    tok = jb["tokens"]
    cfg = m.jcfg

    @jax.jit
    def forward(p, b):
        h, aux = jlm.forward(p, cfg, b["tokens"], extra=b)
        return h, aux, jlm.logits_fn(p, cfg, h)

    h, aux, logits = forward(m.jp, jb)
    out = {"hidden": np.asarray(h), "aux": float(aux),
           "logits": np.asarray(logits)}
    pl, pc, pos = jax.jit(lambda p, t, e: jserving.prefill(p, cfg, t, e))(
        m.jp, tok[:, :-1], extras(jb))
    out.update(prefill_logits=np.asarray(pl), prefill_cache=np_tree(pc),
               pos=np.asarray(pos))
    dl, dc = jax.jit(lambda p, c, t, q: jserving.decode_step(p, cfg, c, t,
                                                             q))(
        m.jp, ref_pad(pc, PAD), tok[:, -1:], pos)
    out.update(decode_logits=np.asarray(dl), decode_cache=np_tree(dc))
    return out


def port_prefill(m: Model, batch: dict):
    tb = as_torch(batch)
    with torch.no_grad():
        return tserving.prefill(m.tp, m.tcfg, tb["tokens"][:, :-1],
                                extra=extras(tb))


def check_forward(m: Model, ref: dict, batch: dict) -> None:
    tb = as_torch(batch)
    with torch.no_grad():
        h, aux = tlm.forward(m.tp, m.tcfg, tb["tokens"], extra=extras(tb))
        logits = tlm.logits_fn(m.tp, m.tcfg, h)
    assert float(aux) == ref["aux"] == 0.0
    assert h.shape == ref["hidden"].shape
    assert_allclose(h.numpy(), ref["hidden"], **TOL)
    assert_allclose(logits.numpy(), ref["logits"], **TOL)


def check_prefill(m: Model, ref: dict, batch: dict) -> None:
    logits, cache, pos = port_prefill(m, batch)
    assert_allclose(logits.numpy(), ref["prefill_logits"], **SERVE_TOL)
    assert pos.dtype == torch.int32
    assert pos.tolist() == ref["pos"].tolist()
    assert_trees_close(cache, ref["prefill_cache"], SERVE_TOL)
    want = tserving.init_cache(m.tcfg, pos.shape[0], int(pos[0]),
                               torch.device("cpu"))
    assert ({p: (v.shape, v.dtype) for p, v in flatten_with_path(cache)}
            == {p: (v.shape, v.dtype) for p, v in flatten_with_path(want)})


def check_decode(m: Model, ref: dict, batch: dict) -> None:
    _, cache, pos = port_prefill(m, batch)
    cache = tserving.pad_seq(cache, PAD)
    tok = torch.tensor(batch["tokens"][:, -1:])
    with torch.no_grad():
        logits, cache2 = tserving.decode_step(m.tp, m.tcfg, cache, tok, pos)
    assert cache2 is cache                       # updated in place
    assert_allclose(logits.numpy(), ref["decode_logits"], **SERVE_TOL)
    assert_trees_close(cache, ref["decode_cache"], SERVE_TOL)


def check_consistency(m: Model, batch: dict) -> None:
    """Twin of ``tests/test_archs_smoke.py::test_prefill_decode_
    consistency``: prefill S-1 tokens, decode token S-1, against the full
    forward's last logits."""
    tb = as_torch(batch)
    with torch.no_grad():
        h, _ = tlm.forward(m.tp, m.tcfg, tb["tokens"], extra=extras(tb))
        full = tlm.logits_fn(m.tp, m.tcfg, h[:, -1])
    _, cache, pos = port_prefill(m, batch)
    with torch.no_grad():
        dec, _ = tserving.decode_step(m.tp, m.tcfg,
                                      tserving.pad_seq(cache, PAD),
                                      tb["tokens"][:, -1:], pos)
    assert_allclose(dec.numpy(), full.numpy(), **CONSIST_TOL)


def reference_grads(m: Model, batch: dict):
    """The reference's loss, metrics and every gradient leaf (remat on)."""
    assert m.jcfg.remat
    vg = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, m.jcfg, b),
                                    has_aux=True))
    (loss, metrics), g = vg(m.jp, as_jax(batch))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            np_tree(g))


def check_grads(m: Model, want, batch: dict) -> None:
    want_loss, want_metrics, want_g = want
    loss, metrics, g = tsteps.loss_and_grads(m.tp, m.tcfg, as_torch(batch))
    assert_allclose(float(loss), want_loss, **TOL)
    for k in want_metrics:
        assert_allclose(float(metrics[k]), want_metrics[k], **TOL)
    assert_trees_close(g, want_g, TOL)


def check_init_layout(arch: str) -> None:
    """``init_params`` draws every leaf of the reference's tree, in its
    shape and dtype, in fp32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        jcfg = jconfigs.get_config(arch).reduced(dtype=dtype)
        tcfg = tconfigs.get_config(arch).reduced(dtype=dtype)
        shapes = jax.eval_shape(lambda: jlm.init_params(
            jax.random.PRNGKey(0), jcfg))
        want = {tuple(str(getattr(k, "key", k)) for k in path):
                (tuple(leaf.shape), leaf.dtype.name)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    shapes)[0]}
        tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
        got = {tuple(str(k) for k in path):
               (tuple(v.shape), str(v.dtype).split(".")[-1])
               for path, v in flatten_with_path(tp)}
        assert got == want


def check_round_trip(m: Model, tmp_path, opt: str) -> None:
    """The reference's parameters and its moments after one update (from
    constant gradients) convert into the port's layout; a port checkpoint
    restores bitwise in both packages."""
    init, update = {"adamw": (joptim.adamw_init, joptim.adamw_update),
                    "adafactor": (joptim.adafactor_init,
                                  joptim.adafactor_update)}[opt]
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), m.jp)
    jp1, js1 = jax.jit(update)(g, init(m.jp), m.jp, 1e-3)
    ref = np_tree({"params": jp1, "opt": js1})
    port = {"params": convert.params_from_reference(ref["params"], m.tcfg),
            "opt": convert.opt_state_from_reference(ref["opt"], m.tcfg)}
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
    with pytest.raises(ValueError, match="does not match"):
        convert.params_from_reference(
            {k: v for k, v in ref["params"].items() if k != "final_norm"},
            m.tcfg)


def check_launchers(arch: str, tmp_path, capsys) -> None:
    """The static launcher and the training launcher run the family on the
    CPU; the continuous launcher raises, as the reference's service."""
    base = ["--arch", arch, "--reduced", "--device", "cpu"]
    launch_serve.main(base + ["--batch", "2", "--prompt-len", "4",
                              "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "decode 4 tokens × batch 2" in out
    assert "greedy continuations" in out
    with pytest.raises(ValueError, match="not wired up"):
        launch_serve.main(base + ["--continuous"])
    launch_train.main(base + ["--steps", "2", "--seq-len", "32",
                              "--global-batch", "2",
                              "--workdir", str(tmp_path)])
    assert "done: 2 steps" in capsys.readouterr().out


def check_run_training(m: Model, tmp_path) -> None:
    """``run_training`` with the family's zero stub inputs: two steps,
    finite losses, a checkpoint a step, and a resume from it."""
    kw = dict(seq_len=32, global_batch=2, ckpt_every=1, device="cpu",
              log_fn=lambda s: None)
    p, o, hist = tloop.run_training(m.tcfg, str(tmp_path), 2, **kw)
    assert [s for s, _ in hist] == [0, 1]
    assert all(np.isfinite(v) for _, v in hist)
    assert int(o.step) == 2
    _, o3, hist3 = tloop.run_training(m.tcfg, str(tmp_path), 3, **kw)
    assert [s for s, _ in hist3] == [2] and int(o3.step) == 3


def check_service_refuses(m: Model) -> None:
    """As the reference's ``GenerateService``, the port's refuses the
    family (its own family set, not ``lm.FAMILIES``)."""
    assert m.tcfg.family in tlm.FAMILIES
    assert m.tcfg.family not in tserve.service.SUPPORTED_FAMILIES
    with pytest.raises(ValueError, match="not wired up"):
        tserve.GenerateService(m.tp, m.tcfg, device="cpu")


def check_prefill_step_passes_extras(m: Model, batch: dict) -> None:
    """``make_prefill_step`` passes every batch entry but the tokens to
    ``serving.prefill`` as ``extra``, as the reference's."""
    tb = as_torch(batch)
    with torch.no_grad():
        got = tsteps.make_prefill_step(m.tcfg)(m.tp, tb)
        want = tserving.prefill(m.tp, m.tcfg, tb["tokens"], extra=tb)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(leaves(got[1]),
                                                 leaves(want[1])))
