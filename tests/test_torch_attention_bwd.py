"""reftr_torch attention backward and dropout against reftr_tpu (CPU).

The plain versions of the backward kernels (``attention_bwd_plain``) and
the autograd Function's CPU path against ``jax.vjp`` of the XLA attention
(with a batch row whose keys are all masked) and of the Pallas kernel in
interpret mode (rows with a valid key: the Pallas kernel pads keys, see
ROADMAP.md queue 3, "Differences that are not port faults"). The dropout
mask: Philox4x32-10 against the published Random123 known answers, its
keep rate against a binomial bound, and the port's mask injected into a
JAX computation whose output and gradients must match the port's.

Tolerances: 1e-5 in float32 (sums in another order); gradcheck in float64
at its defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reftr_tpu.kernels.attention import _xla_attention, fused_attention
from reftr_torch.kernels.attention import (FlashAttentionFn,
                                           attention_bwd_plain,
                                           attention_plain, flash_attention,
                                           philox4x32, philox_keep_plain)
from reftr_torch.nn.attention import MultiHeadAttention, attention_rng
from torch_parity_utils import t

torch.set_num_threads(1)
ATOL = 1e-5

# (batch, Sq, Sk, heads, head_dim): the encoder's square shape, the
# decoder's single query, its 1x1 self-attention, BERT's head dim, and more
# short query sides (the decode backward's, below 16 queries) at key counts
# that are not a multiple of 4
CASES = [
    (2, 13, 13, 4, 32),
    (2, 1, 23, 4, 32),
    (3, 1, 1, 2, 16),
    (2, 9, 17, 2, 64),
    (2, 2, 23, 2, 16),
    (2, 5, 19, 4, 32),
    (2, 15, 30, 2, 64),
]


def make_inputs(seed, b, sq, sk, h, d, all_masked_row=False):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, sq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, sk, h, d)).astype(np.float32)
            for _ in range(2))
    valid = np.arange(sk)[None, :] < rng.integers(1, sk + 1, size=b)[:, None]
    valid[0, :] = True
    if all_masked_row:
        valid[-1] = False
    return q, k, v, valid, do


def jax_grads(fn, q, k, v, do):
    """Output and (dq, dk, dv) of fn(q, k, v) [B, S, H, D] under
    cotangent do."""
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def xla_fn(valid):
    bias = jnp.asarray(np.where(valid, 0.0, -1e9).astype(np.float32))

    def fn(q, k, v):
        out = _xla_attention(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                             v.transpose(0, 2, 1, 3), bias)
        return out.transpose(0, 2, 1, 3)

    return fn


def port_grads(q, k, v, valid, do, rate=0.0, seed=None):
    """Output and gradients through FlashAttentionFn on the CPU."""
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    out = FlashAttentionFn.apply(qt, kt, vt, t(valid), rate, seed)
    out.backward(t(do))
    return out.detach(), [x.grad for x in (qt, kt, vt)]


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("all_masked_row", [False, True])
def test_backward_matches_xla_vjp(case, all_masked_row):
    q, k, v, valid, do = make_inputs(1, *case, all_masked_row=all_masked_row)
    want_out, want = jax_grads(xla_fn(valid), q, k, v, do)
    out, grads = port_grads(q, k, v, valid, do)
    close(out, want_out)
    for g, w in zip(grads, want):
        close(g, w)
    o, lse = attention_plain(t(q), t(k), t(v), t(valid), return_lse=True)
    for g, w in zip(attention_bwd_plain(t(q), t(k), t(v), t(valid), o, lse,
                                        t(do)), want):
        close(g, w)


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_pallas_interpret(case):
    q, k, v, valid, do = make_inputs(2, *case)
    _, want = jax_grads(
        lambda q, k, v: fused_attention(q, k, v, jnp.asarray(valid),
                                        interpret=True), q, k, v, do)
    _, grads = port_grads(q, k, v, valid, do)
    for g, w in zip(grads, want):
        close(g, w)


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.3, 12345)])
def test_gradcheck_float64(rate, seed):
    q, k, v, valid, _ = make_inputs(3, 2, 5, 7, 2, 16)
    args = [t(x).double().requires_grad_() for x in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttentionFn.apply(q, k, v, t(valid), rate, seed),
        args)


# Random123's kat_vectors for philox4x32 with 10 rounds:
# (counter words, key words) -> output words
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    got = philox4x32(torch.tensor([counter], dtype=torch.int64), key)
    assert tuple(got[0].tolist()) == want


def test_philox_mask_words_follow_the_element_offset():
    # element n takes word n % 4 of the block at counter n // 4
    seed, rate = (7 << 32) | 3, 0.5
    keep = philox_keep_plain(seed, 1, 1, 1, 10, rate).reshape(-1)
    ctr = torch.tensor([[c, 0, 0, 0] for c in range(3)], dtype=torch.int64)
    words = philox4x32(ctr, (3, 7)).reshape(-1)[:10]
    assert torch.equal(keep, (words >> 8) >= (1 << 23))


@pytest.mark.parametrize("shape", [(3, 2, 5, 7, 1), (4, 3, 1, 3, 3)])
def test_philox_mask_from_a_batch_row_is_the_mask_slice(shape):
    """first_row gives the batch rows from it on, counted from their own
    offsets (also where a row starts inside a block of 4 words)."""
    b, h, sq, sk, first = shape
    want = philox_keep_plain(11, b, h, sq, sk, 0.3)[first:]
    got = philox_keep_plain(11, b, h, sq, sk, 0.3, first_row=first)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_within_binomial_bound(rate):
    keep = philox_keep_plain(2024, 4, 8, 40, 40, rate)
    n = keep.numel()
    sd = np.sqrt(n * rate * (1 - rate))
    assert abs(keep.sum().item() - n * (1 - rate)) < 5 * sd
    other = philox_keep_plain(2025, 4, 8, 40, 40, rate)
    assert not torch.equal(keep, other)


@pytest.mark.parametrize("case", [(2, 13, 13, 4, 32), (2, 1, 23, 4, 16)])
def test_dropout_mask_injected_into_jax(case):
    """The port's mask, exported to numpy and applied by a JAX computation
    softmax(.) * keep / (1 - rate) . v: the same output and gradients."""
    rate, seed = 0.2, 987654321
    q, k, v, valid, do = make_inputs(4, *case)
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    keep = philox_keep_plain(seed, b, h, sq, sk, rate).numpy()
    scale_mask = jnp.asarray(keep.astype(np.float32) / (1 - rate))
    bias = jnp.asarray(np.where(valid, 0.0, -1e9).astype(np.float32))

    def ref(q, k, v):
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
        w = jax.nn.softmax(logits + bias[:, None, None, :], axis=-1)
        return jnp.einsum("bhqk,bkhd->bqhd", w * scale_mask, v)

    want_out, want = jax_grads(ref, q, k, v, do)
    out, grads = port_grads(q, k, v, valid, do, rate, seed)
    close(out, want_out)
    for g, w in zip(grads, want):
        close(g, w)
    # the flash wrapper and the plain forward draw the same mask
    close(attention_plain(t(q), t(k), t(v), t(valid), dropout_rate=rate,
                          seed=seed), want_out)


def test_flash_attention_goes_through_the_function_when_grad_is_on():
    q, k, v, valid, _ = make_inputs(5, 2, 4, 6, 2, 16)
    qt = t(q).requires_grad_()
    out = flash_attention(qt, t(k), t(v), t(valid))
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        assert flash_attention(qt, t(k), t(v), t(valid)).grad_fn is None
    assert flash_attention(t(q), t(k), t(v), t(valid)).grad_fn is None
    with pytest.raises(ValueError, match="return_lse"):
        flash_attention(qt, t(k), t(v), t(valid), return_lse=True)


def test_dropout_arguments_are_checked():
    q, k, v, valid, _ = (t(x) for x in make_inputs(6, 2, 4, 6, 2, 16))
    with pytest.raises(ValueError, match="seed"):
        flash_attention(q, k, v, valid, dropout_rate=0.1)
    with pytest.raises(ValueError, match="rate"):
        flash_attention(q, k, v, valid, dropout_rate=1.0, seed=1)


def test_mha_dropout_draws_its_seeds_from_the_bound_generator():
    torch.manual_seed(0)
    mha = MultiHeadAttention(32, 4, dropout=0.3).train()
    x = torch.randn(2, 9, 32)

    def run(seed, plain=False):
        mha.plain = plain
        gen = torch.Generator()
        gen.manual_seed(seed)
        with attention_rng(gen):
            return mha(x, x, x)

    a, b, c = run(1), run(1), run(2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    torch.testing.assert_close(run(1, plain=True), a, rtol=0, atol=ATOL)
    with pytest.raises(RuntimeError, match="attention_rng"):
        mha.plain = False
        mha(x, x, x)
    mha.eval()
    with torch.no_grad():  # eval mode: no dropout, no generator needed
        mha(x, x, x)
