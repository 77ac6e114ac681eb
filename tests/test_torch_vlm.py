"""The port's VLM family on the CPU against the reference, at
``internvl2-76b --reduced`` (fp32, 4 dense layers of d 128, 4 heads of 32
over 2 KV heads, 16 stub patch embeddings prepended to the text) with the
reference's parameters, through ``torch_family_twins``: the forward over
V + S positions, the loss (the visual positions dropped) and every
gradient leaf, prefill logits and every cache leaf (``next_pos`` V + S),
one decode step, prefill→decode consistency, the paged decode path (the
plain K10 here) against the contiguous one, ``make_prefill_step``
passing the patch embeddings, parameters and moments through ``convert``
and a checkpoint, both launchers and ``run_training`` in-process, and the
service's refusal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_family_twins as twins  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import serving as tserving  # noqa: E402

ARCH = "internvl2-76b"


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


def test_init_params_layout_matches_reference():
    twins.check_init_layout(ARCH)


def test_forward_hidden_and_logits_match_reference(model, ref, batch):
    twins.check_forward(model, ref, batch)
    assert ref["hidden"].shape[1] == model.tcfg.n_vis_tokens + 16


def test_loss_and_every_gradient_leaf_match_reference(model, grads,
                                                      grad_batch):
    twins.check_grads(model, grads, grad_batch)


def test_loss_drops_the_visual_positions(model, grad_batch):
    """The loss is the next-token cross entropy (+ z-loss) of the text
    positions alone; the patch embeddings reach it through attention."""
    _, _, tcfg, tp = model
    b = twins.as_torch(grad_batch)
    with torch.no_grad():
        loss, m = tlm.loss_fn(tp, tcfg, b)
        h, _ = tlm.forward(tp, tcfg, b["tokens"], extra=b)
        logits = tlm.logits_fn(tp, tcfg, h[:, tcfg.n_vis_tokens:]).float()
        tok = b["tokens"].long()
        mask = b["loss_mask"].clone()
        mask[:, -1] = 0
        nll = (torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, torch.roll(tok, -1, 1)[..., None])[..., 0]) * mask
        other = dict(b, vis_embeds=b["vis_embeds"] + 0.5)
        loss2, _ = tlm.loss_fn(tp, tcfg, other)
    assert float(m["ntok"]) == float(mask.sum())
    assert_allclose(float(m["ce"]), float(nll.sum() / mask.sum()),
                    **twins.TOL)
    assert float(loss2) != float(loss)


def test_prefill_logits_and_every_cache_leaf_match_reference(model, ref,
                                                             batch):
    twins.check_prefill(model, ref, batch)
    assert int(ref["pos"][0]) == model.tcfg.n_vis_tokens + 15


def test_decode_step_logits_and_cache_match_reference(model, ref, batch):
    twins.check_decode(model, ref, batch)


def test_prefill_decode_consistency(model, batch):
    twins.check_consistency(model, batch)


def test_paged_decode_matches_contiguous(model, batch):
    """The VLM family decodes on the attention path, paged too: the pool
    holding the prefill's V + S - 1 positions in pages of 8, one decode
    step (the plain K10 here) against ``decode_step``."""
    _, _, tcfg, tp = model
    ps = 8
    _, cache, pos = twins.port_prefill(model, batch)
    n = int(pos[0])
    n_pages = -(-(n + 1) // ps)
    padded = tserving.pad_seq(cache, n_pages * ps - n)
    b = pos.shape[0]
    # slot i's pages are i * n_pages .. (i + 1) * n_pages - 1
    leaves = {k: v.reshape(v.shape[0], b * n_pages, ps, *v.shape[3:]).clone()
              for k, v in padded.items()}
    rows = torch.arange(b * n_pages, dtype=torch.int32).reshape(b, n_pages)
    tok = torch.tensor(batch["tokens"][:, -1:])
    plain = pa_ops.PLAIN_CALLS["paged_gqa"]
    with torch.no_grad():
        want, _ = tserving.decode_step(tp, tcfg, padded, tok, pos)
        got, _ = tserving.decode_step_paged(tp, tcfg, leaves, rows, tok, pos,
                                            page_size=ps)
    assert pa_ops.PLAIN_CALLS["paged_gqa"] == plain + tcfg.n_layers
    assert_allclose(got.numpy(), want.numpy(), **twins.SERVE_TOL)


def test_make_prefill_step_passes_the_patch_embeddings(model, batch):
    twins.check_prefill_step_passes_extras(model, batch)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_params_and_moments_convert_and_round_trip(model, tmp_path, opt):
    twins.check_round_trip(model, tmp_path, opt)


def test_launchers_run_internvl2_on_the_cpu(tmp_path, capsys):
    twins.check_launchers(ARCH, tmp_path, capsys)


def test_run_training_steps_and_resumes_on_the_cpu(model, tmp_path):
    twins.check_run_training(model, tmp_path)


def test_service_refuses_the_vlm_family(model):
    twins.check_service_refuses(model)
