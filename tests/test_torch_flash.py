"""Port of the flash-attention op (``repro_torch.kernels.flash_attention``)
against the reference, on the CPU, where the op runs its plain version.

The same numpy inputs go through the reference's Pallas kernel in
interpret mode, its oracle ``ref.attention_ref``, its model-layout op
``ops.flash_attention_bshd`` (ragged S = 100) and the model's chunked
attention ``models.layers.sdpa_chunked``, at tests/test_kernels_flash.py's
shapes and tolerances: atol 2e-5 / rtol 1e-4 in float32, 2e-2 in bf16;
also at the shapes the reference takes beyond those (hd 48 and 112,
blocks 32 and 96, Sq != Sk), which ``kernel.check_shape`` (the card
kernel's limits, checked without a card) accepts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels.flash_attention import kernel as jkernel  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-4)


def qkv_np(bh, sq, sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(s) * 0.5).astype(np.float32)
                 for s in ((bh, sq, hd), (bh, sk, hd), (bh, sk, hd)))


def as_torch(arrays, dtype=torch.float32):
    return tuple(torch.tensor(a).to(dtype) for a in arrays)


def as_jax(arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a, dtype) for a in arrays)


@pytest.mark.parametrize("sq,sk,blocks", [(128, 128, (64, 64)),
                                          (256, 256, (128, 64)),
                                          (256, 256, (64, 128)),
                                          (512, 512, (128, 128))])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference_kernel_and_oracle(sq, sk, blocks, causal):
    arrays = qkv_np(4, sq, sk, 64, seed=sq + sk)
    kernel.reset_counts()
    got = kernel.flash_attention(*as_torch(arrays), causal=causal,
                                 block_q=blocks[0], block_k=blocks[1])
    assert kernel.PLAIN_CALLS["flash_attention"] == 1
    assert kernel.LAUNCHES["flash_attention"] == 0
    want = jkernel.flash_attention(*as_jax(arrays), causal=causal,
                                   block_q=blocks[0], block_k=blocks[1],
                                   interpret=True)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = jref.attention_ref(*as_jax(arrays), causal=causal)
    assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes_match_reference_kernel(dtype):
    arrays = qkv_np(2, 128, 128, 32, seed=1)
    got = kernel.flash_attention(*as_torch(arrays, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    want = jkernel.flash_attention(*as_jax(arrays, getattr(jnp, dtype)),
                                   interpret=True)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                    atol=tol, rtol=tol)


@pytest.mark.parametrize("sq,sk,hd,blocks", [(192, 192, 48, (32, 96)),
                                             (192, 192, 112, (96, 32)),
                                             (96, 192, 64, (32, 64)),
                                             (192, 96, 32, (64, 32)),
                                             (128, 256, 112, (128, 128))])
@pytest.mark.parametrize("causal", [True, False])
def test_wider_shapes_match_reference_kernel_and_oracle(sq, sk, hd, blocks,
                                                        causal):
    """hd 48 and 112 (zamba2-7b's), blocks 32 and 96, Sq != Sk (causal
    aligned at the top left): the reference's kernel takes them all, and
    so does the port's card kernel (check_shape)."""
    arrays = qkv_np(2, sq, sk, hd, seed=sq + 3 * sk + hd)
    kernel.check_shape(torch.bfloat16, sq, sk, hd, *blocks)
    kernel.check_shape(torch.float32, sq, sk, hd, *blocks)
    got = kernel.flash_attention(*as_torch(arrays), causal=causal,
                                 block_q=blocks[0], block_k=blocks[1])
    assert got.shape == (2, sq, hd)
    want = jkernel.flash_attention(*as_jax(arrays), causal=causal,
                                   block_q=blocks[0], block_k=blocks[1],
                                   interpret=True)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = jref.attention_ref(*as_jax(arrays), causal=causal)
    assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


def test_check_shape_limits():
    """The card kernel's limits, device-free: any hd (above 256 the
    chunked path) and any blocks that divide Sq and Sk pass; fp16 and
    blocks that do not divide raise."""
    for hd in (1, 16, 20, 48, 50, 112, 192, 256, 257, 320, 512):
        kernel.check_shape(torch.bfloat16, 192, 96, hd, 32, 96)
        kernel.check_shape(torch.float32, 4096, 4096, hd, 128, 128)
    kernel.check_shape(torch.bfloat16, 100, 100, 64, 100, 50)
    with pytest.raises(ValueError, match="hd >= 1"):
        kernel.check_shape(torch.bfloat16, 64, 64, 0, 64, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel.check_shape(torch.float16, 64, 64, 64, 64, 64)
    with pytest.raises(ValueError, match="multiples"):
        kernel.check_shape(torch.bfloat16, 96, 64, 64, 64, 64)


def bshd(seed, b=2, s=100, h=3, hd=32):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((b, s, h, hd)) * 0.5).astype(np.float32)
                 for _ in range(3))


def test_bshd_pads_ragged_seq_like_the_reference():
    arrays = bshd(3)                      # S = 100, not a block multiple
    got = ops.flash_attention_bshd(*as_torch(arrays), block_q=64, block_k=64)
    assert got.shape == (2, 100, 3, 32)
    want = jops.flash_attention_bshd(*as_jax(arrays), block_q=64,
                                     block_k=64)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_allclose(ops.attention_ref_bshd(*as_torch(arrays)).numpy(),
                    np.asarray(jops.attention_ref_bshd(*as_jax(arrays))),
                    **TOL)
    assert_allclose(got.numpy(),
                    ops.attention_ref_bshd(*as_torch(arrays)).numpy(), **TOL)


def test_non_causal_ragged_keys_raise():
    arrays = as_torch(bshd(4))
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention_bshd(*arrays, causal=False, block_q=64,
                                 block_k=64)
    q, k, v = as_torch(qkv_np(1, 64, 100, 16))
    with pytest.raises(ValueError, match="multiples"):
        kernel.flash_attention(q, k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="one dtype"):
        kernel.flash_attention(q, k[:, :64].double(), v[:, :64], block_q=64,
                               block_k=64)


def test_matches_model_chunked_path():
    """Same math as the model's pure-jnp online-softmax attention."""
    from repro.models.layers import sdpa_chunked
    arrays = bshd(5, s=256, h=4)
    got = ops.flash_attention_bshd(*as_torch(arrays), block_q=64, block_k=64)
    want = sdpa_chunked(*as_jax(arrays), chunk=64)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_softmax_rows_sum_to_one():
    """With v = ones the output is ones, whatever the blocking."""
    q, k, _ = as_torch(qkv_np(2, 128, 128, 32, seed=9))
    for causal in (True, False):
        got = kernel.flash_attention(q, k, torch.ones(2, 128, 32),
                                     causal=causal, block_q=64, block_k=64)
        assert_allclose(got.numpy(), np.ones((2, 128, 32)), atol=1e-5)


def test_causal_rows_ignore_later_keys():
    """Row r depends on keys 0..r only: changing the keys after row r
    leaves it bitwise as it was."""
    q, k, v = as_torch(qkv_np(1, 128, 128, 16, seed=11))
    base = ref.attention_ref(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 64:] += 1.0
    v2[:, 64:] -= 1.0
    moved = ref.attention_ref(q, k2, v2)
    assert torch.equal(moved[:, :64], base[:, :64])
    assert not torch.equal(moved[:, 64:], base[:, 64:])
