"""reftr_torch attention: the kernel wrapper's plain version and the port's
MultiHeadAttention against reftr_tpu (float32, CPU).

Tolerance: atol 1e-5 (f32; the einsum and softmax sum in another order).
"""

import numpy as np
import pytest
import torch

from reftr_tpu.kernels.attention import _xla_attention, fused_attention
from reftr_tpu.nn.attention import MultiHeadAttention as JaxMHA
from reftr_torch.kernels.attention import attention_plain, flash_attention
from reftr_torch.nn.attention import MultiHeadAttention, set_plain_attention
from torch_parity_utils import close, load_port, random_flax_params, t

ATOL = 1e-5

# (batch, Sq, Sk, heads, head_dim): Sq != Sk, a single query, the decoder's
# 1x1, every head_dim the kernel takes, ragged key counts
CASES = [
    (2, 50, 70, 4, 32),
    (2, 1, 70, 4, 16),
    (3, 1, 1, 2, 64),
    (2, 40, 40, 4, 64),
    (2, 33, 130, 2, 16),
]


def make_qkv(seed, b, sq, sk, h, d, all_masked_row=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    lens = rng.integers(1, sk + 1, size=b)
    lens[0] = max(1, (sk * 3) // 5)  # at least one ragged row
    valid = np.arange(sk)[None, :] < lens[:, None]
    if all_masked_row:
        valid[-1] = False
    return q, k, v, valid


def xla_reference(q, k, v, valid):
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    out = _xla_attention(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                         v.transpose(0, 2, 1, 3), bias)
    return np.asarray(out).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("all_masked_row", [False, True])
def test_plain_matches_xla_attention(case, all_masked_row):
    q, k, v, valid = make_qkv(1, *case, all_masked_row=all_masked_row)
    got = attention_plain(t(q), t(k), t(v), t(valid))
    close(got, xla_reference(q, k, v, valid), ATOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(case):
    # no fully masked row here: the Pallas kernel pads keys with -1e9, so
    # such a row averages over the padding too (the port leaves it out)
    q, k, v, valid = make_qkv(2, *case)
    want = np.asarray(fused_attention(q, k, v, valid, interpret=True))
    close(flash_attention(t(q), t(k), t(v), t(valid)), want, ATOL)


def test_plain_without_mask_and_lse():
    q, k, v, _ = make_qkv(3, 2, 9, 13, 2, 32)
    out, lse = flash_attention(t(q), t(k), t(v), None, return_lse=True)
    close(out, xla_reference(q, k, v, np.ones((2, 13), bool)), ATOL)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(32.0)
    m = logits.max(-1)
    want = m + np.log(np.exp(logits - m[..., None]).sum(-1))
    close(lse, want, ATOL)
    assert lse.shape == (2, 2, 9) and lse.dtype == torch.float32


def test_fully_masked_row_is_uniform_average():
    q, k, v, valid = make_qkv(4, 2, 5, 7, 2, 16, all_masked_row=True)
    got = attention_plain(t(q), t(k), t(v), t(valid)).numpy()
    want = np.broadcast_to(v[-1].mean(0, keepdims=True), got[-1].shape)
    np.testing.assert_allclose(got[-1], want, atol=ATOL)


@pytest.mark.parametrize("sq,sk,all_masked_row", [
    (11, 11, False), (1, 17, False), (6, 9, True)])
def test_mha_matches_jax(sq, sk, all_masked_row):
    d, h, b = 64, 4, 3
    rng = np.random.default_rng(5)
    query = rng.normal(size=(b, sq, d)).astype(np.float32)
    key = rng.normal(size=(b, sk, d)).astype(np.float32)
    value = rng.normal(size=(b, sk, d)).astype(np.float32)
    valid = np.arange(sk)[None, :] < rng.integers(1, sk + 1, b)[:, None]
    if all_masked_row:
        valid[1] = False
    jmha = JaxMHA(d, h, use_pallas=False)
    params = random_flax_params(jmha, query, key, value, valid)
    want = jmha.apply({"params": params}, query, key, value, valid)
    port = load_port(MultiHeadAttention(d, h), params)
    with torch.no_grad():
        got = port(t(query), t(key), t(value), t(valid))
        set_plain_attention(port, True)
        got_plain = port(t(query), t(key), t(value), t(valid))
    close(got, want, ATOL)
    close(got_plain, want, ATOL)


def test_launch_counter_stays_zero_on_cpu():
    flash_attention.launches = 0
    q, k, v, valid = make_qkv(6, 2, 8, 8, 4, 16)
    flash_attention(t(q), t(k), t(v), t(valid))
    mha = MultiHeadAttention(64, 4).eval()
    with torch.no_grad():
        mha(t(q.reshape(2, 8, 64)), t(k.reshape(2, 8, 64)),
            t(v.reshape(2, 8, 64)), t(valid))
    assert flash_attention.launches == 0


def test_wrapper_rejects_bad_inputs():
    q, k, v, valid = (t(a) for a in make_qkv(7, 2, 4, 6, 2, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1], v, valid)  # head mismatch
    with pytest.raises(ValueError):
        flash_attention(q[0], k, v, valid)  # rank
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), valid)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, valid.float())  # mask must be bool
    with pytest.raises(ValueError):
        flash_attention(q, k, v, valid[:, :3])
    with pytest.raises(ValueError):  # neither cpu nor cuda
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), None)


def test_mha_rejects_indivisible_width():
    with pytest.raises(ValueError):
        MultiHeadAttention(30, 4)
