"""The port's enc-dec family on the CPU against the reference, at
``whisper-tiny --reduced`` (fp32, 2 encoder and 4 decoder layers of d
128, 4 heads of 32 over 2 KV heads, 32 stub encoder frames) with the
reference's parameters, through ``torch_family_twins``:
``sinusoidal_pos`` and ``cross_attention``, the forward, the encoder's
full attention whatever ``attn_chunk`` (causal, with RoPE, as the
reference has it), the loss and every gradient leaf (``enc_layers``, the
decoder's ``cross`` and ``cross_norm``), prefill logits and every cache
leaf, one decode step, prefill→decode consistency, ``pad_seq`` never
padding the ``cross`` cache, decode only reading it, ``make_prefill_step``
passing the frames, parameters and moments through ``convert`` and a
checkpoint, both launchers and ``run_training`` in-process, and the
service's refusal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_family_twins as twins  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import serving as tserving  # noqa: E402

ARCH = "whisper-tiny"


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


@pytest.mark.parametrize("seq,d,offset", [(32, 128, 0), (1500, 384, 0),
                                          (5, 384, 131)])
def test_sinusoidal_pos_matches_reference(seq, d, offset):
    """float32 throughout, sin on the even columns and cos on the odd.
    Each column's frequency is one float32 ``exp``, where XLA's and
    PyTorch's may differ by an ulp (6e-8 relative), so the angle at
    position p may differ by ~p·6e-8 rad: at whisper's 1,500 frames, ~1e-4.
    The limit is two such ulps at the last position, plus 2e-6."""
    want = np.asarray(jlayers.sinusoidal_pos(seq, d, offset))
    got = tlayers.sinusoidal_pos(seq, d, offset).numpy()
    assert got.dtype == np.float32
    assert_allclose(got, want, atol=2e-6 + 1.2e-7 * (offset + seq), rtol=0)
    pos = torch.arange(offset, offset + seq)
    assert torch.equal(tserving._sin_pos_at(pos, d)[:, 0],
                       tlayers.sinusoidal_pos(seq, d, offset))


def test_cross_attention_matches_reference(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    e = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    jl = twins.jax.tree.map(lambda a: a[0], jp["dec_layers"]["cross"])
    tl = {k: v[0] for k, v in tp["dec_layers"]["cross"].items()}
    want = jlayers.cross_attention(jl, jcfg, jnp.asarray(x), jnp.asarray(e))
    got = tlayers.cross_attention(tl, tcfg, torch.tensor(x), torch.tensor(e))
    assert_allclose(got.numpy(), np.asarray(want), **twins.TOL)


def test_init_params_layout_matches_reference():
    twins.check_init_layout(ARCH)


def test_forward_hidden_and_logits_match_reference(model, ref, batch):
    twins.check_forward(model, ref, batch)


def test_encoder_takes_full_attention_whatever_attn_chunk():
    """At ``attn_chunk`` 8 the decoder's 16 positions take the chunked
    attention and the encoder's 32 frames still the full one, in both
    packages."""
    m = twins.load(ARCH, attn_chunk=8)
    batch = twins.make_batch(m.jcfg, 2, 16, seed=9)
    h, _ = twins.jlm.forward(m.jp, m.jcfg, jnp.asarray(batch["tokens"]),
                             extra=twins.as_jax(batch))
    tb = twins.as_torch(batch)
    with torch.no_grad():
        got, _ = twins.tlm.forward(m.tp, m.tcfg, tb["tokens"], extra=tb)
    assert_allclose(got.numpy(), np.asarray(h), **twins.TOL)
    # the encoder's frames attend causally (the reference's choice)
    frames = tb["frames"].clone()
    with torch.no_grad():
        e0 = twins.tlm.encode(m.tp, m.tcfg, frames, torch.float32)
        frames[:, 20:] += 1.0
        e1 = twins.tlm.encode(m.tp, m.tcfg, frames, torch.float32)
    assert torch.equal(e0[:, :20], e1[:, :20])
    assert not torch.equal(e0[:, 20:], e1[:, 20:])


def test_loss_and_every_gradient_leaf_match_reference(model, grads,
                                                      grad_batch):
    twins.check_grads(model, grads, grad_batch)
    assert {"enc_layers", "dec_layers", "enc_norm"} <= set(model.tp)
    assert {"cross", "cross_norm"} <= set(model.tp["dec_layers"])
    assert "cross" not in model.tp["enc_layers"]


def test_prefill_logits_and_every_cache_leaf_match_reference(model, ref,
                                                             batch):
    twins.check_prefill(model, ref, batch)


def test_decode_step_logits_and_cache_match_reference(model, ref, batch):
    twins.check_decode(model, ref, batch)


def test_prefill_decode_consistency(model, batch):
    twins.check_consistency(model, batch)


def test_pad_seq_never_pads_the_cross_cache(model, batch):
    """``self`` K/V gain the decode positions; ``cross`` K/V, whose axis is
    the encoder's frames, are passed through — even where the prompt and
    the frames are equally long, so no rule by shape or by leaf name
    alone would do."""
    jcfg = model.jcfg
    b = twins.make_batch(jcfg, 2, jcfg.enc_seq + 1, seed=4)
    _, cache, pos = twins.port_prefill(model, b)
    assert int(pos[0]) == jcfg.enc_seq
    padded = tserving.pad_seq(cache, 6)
    for k in ("k", "v"):
        assert cache["cross"][k].shape[2] == cache["self"][k].shape[2]
        assert padded["cross"][k] is cache["cross"][k]
        assert padded["self"][k].shape[2] == jcfg.enc_seq + 6
        assert torch.equal(padded["self"][k][:, :, :jcfg.enc_seq],
                           cache["self"][k])


def test_decode_only_reads_the_cross_cache(model, batch):
    """The prefill's cross K/V are the encoder output's, and three decode
    steps leave them bitwise as they were."""
    _, cache, pos = twins.port_prefill(model, batch)
    tb = twins.as_torch(batch)
    with torch.no_grad():
        e = twins.tlm.encode(model.tp, model.tcfg, tb["frames"],
                             torch.float32)
        for i, lp in enumerate(twins.tlm._unbind(model.tp["dec_layers"])):
            k, v = tlayers.cross_kv(lp["cross"], model.tcfg, e)
            assert torch.equal(cache["cross"]["k"][i], k)
            assert torch.equal(cache["cross"]["v"][i], v)
    cache = tserving.pad_seq(cache, 3)
    before = {k: v.clone() for k, v in cache["cross"].items()}
    tok = tb["tokens"][:, -1:]
    with torch.no_grad():
        for _ in range(3):
            logits, cache = tserving.decode_step(model.tp, model.tcfg, cache,
                                                 tok, pos)
            tok, pos = torch.argmax(logits, -1)[:, None], pos + 1
    for k in before:
        assert torch.equal(cache["cross"][k], before[k])


def test_make_prefill_step_passes_the_frames(model, batch):
    twins.check_prefill_step_passes_extras(model, batch)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_params_and_moments_convert_and_round_trip(model, tmp_path, opt):
    twins.check_round_trip(model, tmp_path, opt)


def test_launchers_run_whisper_on_the_cpu(tmp_path, capsys):
    twins.check_launchers(ARCH, tmp_path, capsys)


def test_run_training_steps_and_resumes_on_the_cpu(model, tmp_path):
    twins.check_run_training(model, tmp_path)


def test_service_refuses_the_encdec_family(model):
    twins.check_service_refuses(model)
