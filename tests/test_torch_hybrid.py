"""The port's hybrid family on the CPU against the reference, at
``zamba2-7b --reduced`` (fp32, 4 Mamba2 layers of d 128, 8 heads of 32,
N 16; a shared block after every 2 layers, 2 shared blocks of width 256,
4 heads of 64) with the reference's parameters, through
``torch_family_twins``: the forward (at S 16, one ragged SSD chunk, and
S 256, two chunks with the carried state), the loss and every gradient
leaf (``shared``, ``site_proj`` and the trunk), prefill logits and every
cache leaf, one decode step, prefill→decode consistency, a trunk state of
constant size, ``pad_seq`` on the nested ``shared`` cache, a 7-layer
trunk (3 sites cycling the 2 shared blocks, a 1-layer tail), parameters
and moments through ``convert`` and a checkpoint, both launchers and
``run_training`` in-process, and the service's refusal.  Over a full SSD
chunk (S 128) the reference's gradient is NaN (it masks the decay after
``exp``); there the port's gradients are held to a float64 autograd of
the stepwise oracle instead (rtol 1e-4, atol 2e-5 of the largest).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_family_twins as twins  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.models import serving as jserving  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import serving as tserving  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim.tree import leaves, tree_map  # noqa: E402
from repro_torch.trainer import steps as tsteps  # noqa: E402

ARCH = "zamba2-7b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These models are tiny: one intra-op thread is as fast, and the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return twins.load(ARCH)


@pytest.fixture(scope="module")
def batch(model):
    return twins.make_batch(model.jcfg, 2, 16, seed=3)


@pytest.fixture(scope="module")
def ref(model, batch):
    return twins.reference_run(model, batch)


@pytest.fixture(scope="module")
def grad_batch(model):
    return twins.make_batch(model.jcfg, 2, 32, seed=5, mask=True)


@pytest.fixture(scope="module")
def grads(model, grad_batch):
    return twins.reference_grads(model, grad_batch)


def test_layout_sites_and_tail():
    cfg = twins.tconfigs.get_config(ARCH)
    assert tlm.n_sites(cfg) == 13 and cfg.n_layers - 13 * 6 == 3
    sites = [tlm.hybrid_site_after(cfg, i) for i in range(cfg.n_layers)]
    assert [i for i, s in enumerate(sites) if s is not None] == [
        6 * k + 5 for k in range(13)]
    assert [s for s in sites if s is not None] == list(range(13))
    scfg = tlm.shared_cfg(cfg)
    assert (scfg.d_model, scfg.hd, scfg.n_heads) == (7168, 224, 32)


def test_init_params_layout_matches_reference():
    twins.check_init_layout(ARCH)


def test_forward_hidden_and_logits_match_reference(model, ref, batch):
    twins.check_forward(model, ref, batch)


def test_forward_over_two_ssd_chunks_matches_reference(model):
    """S 256: two chunks of 128 with the state carried between them."""
    b = twins.make_batch(model.jcfg, 1, 256, seed=7)
    h, _ = twins.jlm.forward(model.jp, model.jcfg, twins.jnp.asarray(
        b["tokens"]))
    with torch.no_grad():
        got, _ = tlm.forward(model.tp, model.tcfg,
                             torch.tensor(b["tokens"]))
    assert_allclose(got.numpy(), np.asarray(h), **twins.TOL)


def test_loss_and_every_gradient_leaf_match_reference(model, grads,
                                                      grad_batch):
    twins.check_grads(model, grads, grad_batch)
    assert {"shared", "site_proj", "layers"} <= set(model.tp)


def test_remat_on_and_off_bitwise_equal(model, grad_batch):
    batch = twins.as_torch(grad_batch)
    on = tsteps.loss_and_grads(model.tp, model.tcfg, batch)
    off = tsteps.loss_and_grads(
        model.tp, dataclasses.replace(model.tcfg, remat=False), batch)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(on[2]),
                                                 leaves(off[2])))


def test_prefill_logits_and_every_cache_leaf_match_reference(model, ref,
                                                             batch):
    twins.check_prefill(model, ref, batch)


def test_decode_step_logits_and_cache_match_reference(model, ref, batch):
    twins.check_decode(model, ref, batch)


def test_prefill_decode_consistency(model, batch):
    twins.check_consistency(model, batch)


def test_tail_and_cycled_shared_blocks_match_reference():
    """7 layers at every 2: sites after layers 1, 3, 5 take shared blocks
    0, 1, 0, and layer 6 is a tail; forward, prefill caches and a decode
    step against the reference."""
    m = twins.load(ARCH, n_layers=7)
    assert tlm.n_sites(m.tcfg) == 3
    batch = twins.make_batch(m.jcfg, 2, 12, seed=11)
    ref = twins.reference_run(m, batch)
    twins.check_forward(m, ref, batch)
    twins.check_prefill(m, ref, batch)
    twins.check_decode(m, ref, batch)


def test_trunk_state_is_constant_size(model):
    """Twin of ``test_long_context_state_is_constant_size``: the trunk
    state does not grow with ``max_seq``; the shared KV does."""
    jcfg, _, tcfg, _ = model
    cpu = torch.device("cpu")
    c1 = tserving.init_cache(tcfg, 1, 64, cpu)
    c2 = tserving.init_cache(tcfg, 1, 4096, cpu)
    for k in tserving.TRUNK_LEAVES:
        assert c1[k].shape == c2[k].shape and c1[k].dtype == torch.float32
    assert c2["shared"]["k"].shape[2] == 4096
    want = jserving.init_cache(jcfg, batch=1, max_seq=64)
    got = {p: tuple(v.shape) for p, v in twins.flat_port(c1).items()}
    assert got == {p: v.shape for p, v in twins.flat_ref(want).items()}


def test_pad_seq_pads_the_shared_cache_not_the_trunk(model, batch):
    """The shared K/V sit in a nested dict: ``pad_seq`` pads them and
    passes the trunk state through."""
    _, cache, pos = twins.port_prefill(model, batch)
    padded = tserving.pad_seq(cache, 5)
    for k in ("k", "v"):
        assert padded["shared"][k].shape[2] == cache["shared"][k].shape[2] + 5
        assert torch.equal(padded["shared"][k][:, :, :int(pos[0])],
                           cache["shared"][k])
        assert not padded["shared"][k][:, :, int(pos[0]):].any()
    for k in tserving.TRUNK_LEAVES:
        assert padded[k] is cache[k]


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_params_and_moments_convert_and_round_trip(model, tmp_path, opt):
    twins.check_round_trip(model, tmp_path, opt)


def test_launchers_run_zamba2_on_the_cpu(tmp_path, capsys):
    twins.check_launchers(ARCH, tmp_path, capsys)


def test_run_training_steps_and_resumes_on_the_cpu(model, tmp_path):
    twins.check_run_training(model, tmp_path)


def test_service_refuses_the_hybrid_family(model):
    twins.check_service_refuses(model)


def test_ssd_gradient_is_finite_over_a_full_chunk(model):
    """Over a full chunk of 128 the causal log-decay differences reach
    e^88, past float32: the reference masks after ``exp`` and its
    gradient is NaN there (a limit of parity); the port exponentiates the
    causal differences only.  Its loss and gradients at S 128 are finite,
    and one Mamba2 layer's gradients (input and every weight) match a
    float64 autograd of the stepwise oracle ``mamba2_apply_ref``."""
    jcfg, jp, tcfg, tp = model
    tok = twins.make_batch(jcfg, 2, 128, seed=13)["tokens"]
    vg = twins.jax.jit(twins.jax.grad(
        lambda p, b: twins.jlm.loss_fn(p, jcfg, b)[0]))
    jg = vg(jp, {"tokens": twins.jnp.asarray(tok)})
    assert not all(bool(twins.jnp.isfinite(g).all())
                   for g in twins.jax.tree.leaves(jg))
    loss, _, g = tsteps.loss_and_grads(tp, tcfg,
                                       {"tokens": torch.tensor(tok)})
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(v).all()) for v in leaves(g))
    lp = tree_map(lambda v: v[0], tp["layers"]["mamba"])
    x = torch.tensor(twins.make_batch(jcfg, 1, 128, seed=17)["tokens"])
    x = tp["embed"]["tok"][x.long()] * tcfg.d_model ** 0.5
    w = torch.tensor(np.random.default_rng(19).standard_normal(
        (1, 128, tcfg.d_model)))

    def grads(cfg, params, inp):
        params = tree_map(lambda v: v.clone().requires_grad_(True), params)
        inp = inp.clone().requires_grad_(True)
        fn = (tssm.mamba2_apply_ref if inp.dtype == torch.float64
              else tssm.mamba2_apply)
        (fn(params, cfg, inp).double() * w).sum().backward()
        return [inp.grad] + [t.grad for t in leaves(params)]

    want = grads(dataclasses.replace(tcfg, dtype="float64"),
                 tree_map(torch.Tensor.double, lp), x.double())
    got = grads(tcfg, lp, x)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    for a, b in zip(got, want):
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                        atol=2e-5 * float(b.abs().max()))
