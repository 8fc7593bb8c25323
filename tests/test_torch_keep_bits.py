"""The keep bits that K2-wg hands K3-wg, on the CPU.

With dropout K2-wg (csrc/flash_attn_bwd_dq_wg.cu) writes the mask it drew
as keep bits, uint32 [B, H, Sq, 4 * ceil(Sk / 128)], and K3-wg
(csrc/flash_attn_bwd_dkv_wg.cu) reads them instead of drawing the mask
again. Here: ``keep_bits_plain`` packs ``philox_keep_plain``'s mask exactly
(zeros past Sk); ``attention_bwd_plain`` on those bits gives its gradients
from the seed bit for bit; at rate 0 the backward
matches the JAX package's Pallas backward (``_bwd``, interpret mode, as
the JAX package's own tests run it on the CPU) to 1e-5; the rule never
sends K3 to "wg" without K2; and the launchers refuse CPU tensors and
keep bits of the wrong type or shape before any counter moves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from reftr_tpu.kernels.attention import BWD_BLOCK_K, BWD_BLOCK_Q, _bwd, _fwd
from reftr_torch.kernels.attention import (HEAD_DIMS, _launch_dkv,
                                           _launch_dq, attention_bwd_plain,
                                           attention_plain,
                                           dkv_variant, dq_variant,
                                           flash_attn_bwd_dkv,
                                           flash_attn_bwd_dq, flash_attention,
                                           keep_bits_plain, keep_words,
                                           new_keep_bits, philox_keep_plain,
                                           unpack_keep_bits)

torch.set_num_threads(1)
ATOL = 1e-5


def unpack(bits: torch.Tensor) -> torch.Tensor:
    """Every bit of keep bits [B, H, Sq, W] as bool [B, H, Sq, 32 W],
    written out apart from the module's unpack_keep_bits."""
    words = bits.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b, h, sq, w = words.shape
    out = torch.zeros(b, h, sq, 32 * w, dtype=torch.bool)
    for j in range(32 * w):
        out[..., j] = (words[..., j // 32] >> (j % 32)) & 1 == 1
    return out


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("sk", [17, 22, 90, 131, 490])
def test_keep_bits_plain_packs_the_philox_mask(sk, rate):
    """Bit j % 32 of word j / 32 of row (b, h, i) is the keep decision of
    element ((b * H + h) * Sq + i) * Sk + j: philox_keep_plain's mask, at
    key counts off and on a multiple of 4 and of 32, odd Sq, three batch
    rows; every bit past Sk (and every padded word) 0; W = 4 ceil(Sk /
    128), a whole number of 16-byte pieces a row."""
    b, h, sq = 3, 2, 7
    seed = 0x1234_5678_9ABC + sk
    bits = keep_bits_plain(seed, b, h, sq, sk, rate)
    w = 4 * -(-sk // 128)
    assert keep_words(sk) == w and w * 4 % 16 == 0
    assert bits.dtype == torch.uint32 and bits.shape == (b, h, sq, w)
    got = unpack(bits)
    assert torch.equal(got[..., :sk],
                       philox_keep_plain(seed, b, h, sq, sk, rate))
    assert not got[..., sk:].any()
    assert torch.equal(unpack_keep_bits(bits, sk), got[..., :sk])


def test_keep_bits_plain_of_the_last_rows_is_their_slice():
    """With first_row, the batch rows from it on alone: the same words as
    the whole call's rows there."""
    whole = keep_bits_plain(7, 4, 3, 5, 131, 0.1)
    part = keep_bits_plain(7, 4, 3, 5, 131, 0.1, first_row=2)
    assert torch.equal(part.view(torch.int32), whole.view(torch.int32)[2:])


def make_inputs(seed, b, sq, sk, h, d, dtype):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.normal(size=(b, sq, h, d))).to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, sk, h, d))).to(dtype)
            for _ in range(2))
    valid = torch.from_numpy(
        np.arange(sk)[None] < rng.integers(1, sk + 1, size=b)[:, None])
    valid[-1] = False  # a row whose keys are all masked
    return q, k, v, valid, do


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 9, 37, 3, 16), (3, 13, 131, 2, 32)])
def test_k3_on_keep_bits_is_the_seeded_backward(shape, dtype, rate):
    """The plain backward on keep_bits_plain's bits, as K3-wg reads the
    mask, gives attention_bwd_plain's dq, dk and dv from the seed bit for
    bit: the bits carry the whole mask, and nothing else differs."""
    b, sq, sk, h, d = shape
    q, k, v, valid, do = make_inputs(sk, b, sq, sk, h, d, dtype)
    seed = 0xFACE + sk
    o, lse = attention_plain(q, k, v, valid, True, dropout_rate=rate,
                             seed=seed)
    want = attention_bwd_plain(q, k, v, valid, o, lse, do, rate, seed)
    bits = keep_bits_plain(seed, b, h, sq, sk, rate)
    got = attention_bwd_plain(q, k, v, valid, o, lse, do, rate,
                              keep_bits=bits)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k3_plain_takes_bits_with_dropout_only():
    q, k, v, valid, do = make_inputs(0, 2, 5, 9, 2, 16, torch.float32)
    lse = torch.zeros(2, 2, 5)
    bits = keep_bits_plain(1, 2, 2, 5, 9, 0.1)
    with pytest.raises(ValueError, match="keep_bits"):
        attention_bwd_plain(q, k, v, valid, q, lse, do, 0.0, keep_bits=bits)
    with pytest.raises(ValueError, match="seed"):
        attention_bwd_plain(q, k, v, valid, q, lse, do, 0.1)


def jax_backward(q, k, v, valid, do):
    """dq, dk, dv of the JAX package's Pallas backward (``_bwd`` after
    ``_fwd`` with return_lse), in interpret mode at its backward blocks,
    on [B, S, H, D] numpy inputs."""
    qj, kj, vj, doj = (jnp.asarray(x).transpose(0, 2, 1, 3)
                       for x in (q, k, v, do))
    bias = jnp.asarray(np.where(valid, 0.0, -1e9).astype(np.float32))
    blocks = dict(block_q=BWD_BLOCK_Q, block_k=BWD_BLOCK_K, interpret=True)
    o, lse = _fwd(qj, kj, vj, bias, return_lse=True, **blocks)
    grads = _bwd(qj, kj, vj, bias, o, lse, doj, **blocks)
    return [np.asarray(g).transpose(0, 2, 1, 3) for g in grads]


@pytest.mark.parametrize("shape", [(2, 13, 13, 4, 32), (2, 20, 131, 2, 32),
                                   (1, 7, 300, 2, 16)])
def test_backward_at_rate_0_matches_the_pallas_backward(shape):
    """At rate 0, the port's plain backward (the function of K2-wg and
    K3-wg) against the JAX package's _bwd, to 1e-5; every row keeps a
    valid key (the Pallas kernel pads keys)."""
    b, sq, sk, h, d = shape
    q, k, v, valid, do = make_inputs(sq, b, sq, sk, h, d, torch.float32)
    valid[:, 0] = True
    want = jax_backward(*(x.numpy() for x in (q, k, v, valid, do)))
    o, lse = attention_plain(q, k, v, valid, True)
    grads = attention_bwd_plain(q, k, v, valid, o, lse, do)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


@settings(max_examples=300, deadline=None, database=None)
@given(sq=st.integers(1, 10000), sk=st.integers(1, 10000),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]),
       d=st.sampled_from(sorted({*HEAD_DIMS, 8, 24, 48, 96, 160})))
def test_k3_takes_wg_only_where_k2_does(sq, sk, dtype, d):
    """K3-wg reads the keep bits that only K2-wg writes: wherever the rule
    sends K3 to "wg", it sends K2 there too."""
    if dkv_variant(sq, sk, dtype, d) == "wg":
        assert dq_variant(sq, sk, dtype, d) == "wg"


def counts():
    return [(c.launches, c.launches_wg) for c in
            (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)] + [
        flash_attn_bwd_dkv.bits_plain]


def bwd_args(rate):
    q, k, v, valid, do = make_inputs(3, 2, 20, 40, 2, 32, torch.bfloat16)
    o, lse = attention_plain(q, k, v, valid, True, dropout_rate=rate,
                             seed=5 if rate else None)
    return (q, k, v, valid, o, lse, do, rate, 5 if rate else None)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_warpgroup_launchers_refuse_cpu_tensors(kernel, rate):
    """K2-wg with di_out and bits_out, K3-wg with di and keep bits, on CPU
    tensors: both raise before they launch, and no counter moves."""
    args = bwd_args(rate)
    q, k = args[:2]
    bits = new_keep_bits(q, k) if rate else None
    di = torch.empty_like(args[5])
    before = counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        if kernel == "K2":
            _launch_dq("wg", *args, di_out=di, bits_out=bits)
        else:
            _launch_dkv("wg", *args, di, bits)
    assert counts() == before


def bad_bits(q, k, what):
    b, sq, h, _ = q.shape
    w = keep_words(k.shape[1])
    if what == "int32":
        return torch.zeros(b, h, sq, w, dtype=torch.int32)
    if what == "float32":
        return torch.zeros(b, h, sq, w)
    if what == "short_row":
        return torch.zeros(b, h, sq, w - 4, dtype=torch.uint32)
    if what == "one_query_less":
        return torch.zeros(b, h, sq - 1, w, dtype=torch.uint32)
    if what == "heads_first":
        return torch.zeros(b, sq, h, w, dtype=torch.uint32)
    # strided: the right shape, not contiguous
    return torch.zeros(b, h, w, sq, dtype=torch.uint32).transpose(-1, -2)


@pytest.mark.parametrize("what,error", [
    ("int32", TypeError), ("float32", TypeError), ("short_row", ValueError),
    ("one_query_less", ValueError), ("heads_first", ValueError),
    ("strided", ValueError)])
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_warpgroup_launchers_refuse_bad_keep_bits(kernel, what, error):
    """Keep bits that are not uint32 [B, H, Sq, 4 ceil(Sk / 128)] and
    contiguous are refused by K2-wg (bits_out) and K3-wg (keep_bits), and
    through K3's wrapper, before anything else and with no counter
    moving."""
    args = bwd_args(0.1)
    bits = bad_bits(args[0], args[1], what)
    before = counts()
    with pytest.raises(error, match="keep_bits|bits_out|uint32"):
        if kernel == "K2":
            _launch_dq("wg", *args, bits_out=bits)
        else:
            _launch_dkv("wg", *args, keep_bits=bits)
    assert counts() == before


@pytest.mark.parametrize("variant", ["tc", "tf32x3", "dec", "plain"])
def test_only_k2_wg_writes_keep_bits(variant):
    """bits_out and di_out go to K2-wg alone: another variant refuses them
    before it launches or runs the plain version."""
    args = bwd_args(0.1)
    before = counts()
    with pytest.raises(ValueError, match="K2-wg"):
        _launch_dq(variant, *args, bits_out=new_keep_bits(*args[:2]))
    assert counts() == before


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_keep_bits_need_dropout(kernel):
    """At rate 0 there is no mask: keep bits are refused."""
    args = bwd_args(0.0)
    bits = new_keep_bits(*args[:2])
    before = counts()
    with pytest.raises(ValueError, match="rate 0"):
        if kernel == "K2":
            _launch_dq("wg", *args, bits_out=bits)
        else:
            _launch_dkv("wg", *args, keep_bits=bits)
    assert counts() == before


def test_k3_wrapper_on_cpu_tensors_runs_the_seeded_plain_backward():
    """flash_attn_bwd_dkv on CPU tensors, given keep bits or not, runs
    attention_bwd_plain from the seed: nothing launches and no plain bits
    are counted."""
    args = bwd_args(0.1)
    bits = keep_bits_plain(5, 2, 2, 20, 40, 0.1)
    want = attention_bwd_plain(*args)[1:]
    before = counts()
    for got in (flash_attn_bwd_dkv(*args),
                flash_attn_bwd_dkv(*args, keep_bits=bits)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert counts() == before
