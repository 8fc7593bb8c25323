"""reftr_torch's CUDA flash-attention kernels against their plain versions.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip
without one. They import neither JAX nor the shared parity helpers, so on
a machine without JAX they run with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, against the plain version in float32 on the same inputs:
1e-5 max abs in float32 (sums in another order), 2e-2 in bfloat16 (the
kernel's output is rounded to bf16). Gradients (K2, K3 and the autograd
Function), as a share of the largest magnitude among the call's plain
dq, dk and dv (a gradient can be zero in exact arithmetic, as dq and dk
are with a single key): 1e-4 in float32 (sums of up to 440 terms in
another order), 1e-2 in bfloat16 (rounding of the output to bf16, 2^-9).
At the multi-phrase and four-level sites the same, but for K1 at phrase
BERT in bf16: one bf16 ulp of the largest output where that is more
(``chip_smoke.kernel_tol``).

The wrappers pick each kernel's variant by shape, dtype and head dim
(16 or more rows: the tensor-core kernels, in bf16 and in float32 by
3xTF32; fewer than 16 queries: the decode kernels, K1's and
the one backward for K2 and K3; a head dim above 128: the plain versions),
so the tests through the wrappers cover every variant; the tests of the
tensor-core kernels alone launch them at the edges of their 64-row and
64-key tiles, those of the decode kernels at the edges of their key
steps, and every route runs at head dims that pad to an instance.
"""

import pytest
import torch

import chip_smoke
from reftr_torch.kernels.attention import (FlashAttentionFn,
                                           _launch_bwd_dec, _launch_dkv,
                                           _launch_dq, _launch_fwd,
                                           attention_bwd_plain,
                                           attention_plain, di_plain,
                                           dkv_variant,
                                           dq_variant, flash_attention,
                                           flash_attn_bwd_dkv,
                                           flash_attn_bwd_dq, fwd_variant,
                                           keep_bits_plain, new_keep_bits,
                                           philox_keep_plain)
from reftr_torch.nn.attention import (MultiHeadAttention, attention_rng,
                                      set_plain_attention)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SHAPES = [(8, 440, 440, 8, 32), (8, 1, 1, 8, 32), (8, 1, 440, 8, 32),
          (8, 40, 40, 12, 64), (3, 70, 130, 4, 16), (2, 129, 65, 2, 64),
          (2, 5, 3, 2, 16),
          # the edges of the tensor-core kernels' 64-row and 64-key tiles
          (2, 16, 1, 2, 16), (2, 63, 15, 2, 32), (2, 64, 17, 2, 64),
          (2, 65, 63, 2, 16), (2, 16, 65, 2, 32), (2, 63, 440, 2, 64),
          (2, 64, 64, 2, 32), (2, 65, 17, 2, 64), (2, 15, 440, 2, 32)]
TC_SQ = (16, 63, 64, 65)
TC_SK = (1, 15, 17, 63, 65, 440)
HEAD_DIMS = (16, 32, 64, 128)
DEC_SQ = (1, 2, 5, 15)
# the edges of K1-dec's 4-key steps and of the decode backward's block
# steps (64, 128 or 256 keys by dtype and head dim)
DEC_SK = (1, 3, 4, 5, 63, 64, 65, 129, 257, 440)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def inputs(gen, b, sq, sk, h, d, dtype):
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
               .to(dtype) for s in (sq, sk, sk))
    lens = torch.randint(1, sk + 1, (b,), device="cuda", generator=gen)
    valid = torch.arange(sk, device="cuda")[None] < lens[:, None]
    valid[0] = False  # every key masked: a uniform average
    return q, k, v, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(gen, shape, dtype):
    q, k, v, valid = inputs(gen, *shape, dtype)
    out, lse = flash_attention(q, k, v, valid, return_lse=True)
    want, want_lse = attention_plain(q.float(), k.float(), v.float(), valid,
                                     return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


def test_kernel_without_mask(gen):
    q, k, v, _ = inputs(gen, 2, 33, 47, 4, 32, torch.float32)
    torch.testing.assert_close(flash_attention(q, k, v),
                               attention_plain(q, k, v), atol=1e-5, rtol=0)


def test_launch_counter_counts_kernel_launches(gen):
    q, k, v, valid = inputs(gen, 2, 8, 8, 2, 16, torch.float32)
    before = flash_attention.launches
    flash_attention(q, k, v, valid)
    attention_plain(q, k, v, valid)
    assert flash_attention.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q, k, v, valid = inputs(gen, 2, 8, 8, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                        valid)
    with pytest.raises(ValueError, match="head_dim"):
        w = torch.zeros(2, 8, 2, 160, device="cuda")
        _launch_fwd("tc", w, w, w, valid, 0.0, None)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k, v, valid.cpu())


def test_mha_on_the_card_matches_the_plain_path(gen):
    torch.manual_seed(0)
    mha = MultiHeadAttention(256, 8).cuda().eval()
    x = torch.randn(4, 440, 256, device="cuda", generator=gen)
    valid = torch.arange(440, device="cuda")[None] < torch.tensor(
        [[440], [300], [41], [1]], device="cuda")
    with torch.no_grad():
        got = mha(x, x, x, valid)
        set_plain_attention(mha, True)
        want = mha(x, x, x, valid)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def rel_close(got, want, tol, floor=0.0):
    """Max abs error within tol of the reference's largest magnitude (or of
    ``floor``, for a gradient that is zero in exact arithmetic)."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(want.float().abs().max().item(), floor), err


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_with_dropout_and_backward_kernels_match_plain(
        gen, shape, dtype, rate):
    q, k, v, valid = inputs(gen, *shape, dtype)
    seed = 0x1234_5678_9ABC if rate else None
    out, lse = flash_attention(q, k, v, valid, return_lse=True,
                               dropout_rate=rate, seed=seed)
    want = attention_plain(q, k, v, valid, dropout_rate=rate, seed=seed)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    do = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
    want_dq, want_dk, want_dv = attention_bwd_plain(q, k, v, valid, out, lse,
                                                    do, rate, seed)
    dq = flash_attn_bwd_dq(q, k, v, valid, out, lse, do, rate, seed)
    dk, dv = flash_attn_bwd_dkv(q, k, v, valid, out, lse, do, rate, seed)
    torch.cuda.synchronize()
    scale = max(w.float().abs().max().item()
                for w in (want_dq, want_dk, want_dv))
    for got, w in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == w.shape
        rel_close(got, w, GRAD_TOL[dtype], floor=scale)


@pytest.mark.parametrize("shape", [(8, 440, 440, 8, 32), (2, 40, 40, 4, 64)])
def test_dropout_mask_is_exact(gen, shape):
    """v one-hot over the head dim recovers p * keep for D keys at a time:
    the kernel's kept set equals the plain Philox mask exactly."""
    b, sq, sk, h, d = shape
    q, k, _, valid = inputs(gen, b, sq, sk, h, d, torch.float32)
    rate, seed = 0.1, 42
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda")
    for k0 in range(0, sk, d):
        v = torch.zeros(b, sk, h, d, device="cuda")
        n = min(d, sk - k0)
        v[:, k0:k0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        out = flash_attention(q, k, v, valid, dropout_rate=rate, seed=seed)
        got = out[..., :n].permute(0, 2, 1, 3) != 0  # [B, H, Sq, n]
        live = torch.where(valid.any(-1, keepdim=True), valid,
                           True)[:, None, None, k0:k0 + n]
        want = keep[..., k0:k0 + n]
        assert torch.equal(got & live, want & live)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_gradients_match_the_plain_path(gen, dtype, rate):
    q, k, v, valid = inputs(gen, 4, 97, 97, 8, 32, dtype)
    seed = 77 if rate else None
    do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
    grads = {}
    for name, fn in (("kernel", FlashAttentionFn.apply),
                     ("plain", lambda *a: attention_plain(
                         *a[:4], dropout_rate=a[4], seed=a[5]))):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves, valid, rate, seed).backward(do)
        grads[name] = [x.grad for x in leaves]
    scale = max(w.float().abs().max().item() for w in grads["plain"])
    for got, want in zip(grads["kernel"], grads["plain"]):
        rel_close(got, want, GRAD_TOL[dtype], floor=scale)


def test_backward_launch_counters_count_kernel_launches(gen):
    q, k, v, valid = inputs(gen, 2, 8, 8, 2, 16, torch.float32)
    q.requires_grad_()
    before = (flash_attention.launches, flash_attn_bwd_dq.launches,
              flash_attn_bwd_dkv.launches)
    flash_attention(q, k, v, valid).sum().backward()
    after = (flash_attention.launches, flash_attn_bwd_dq.launches,
             flash_attn_bwd_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_mha_projection_gradients_through_the_kernels(gen, dropout):
    """The attention's output carries its graph on the card: the q/k/v
    projections get the plain path's gradients (a graph-detached output
    would leave them without any)."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(256, 8, dropout).cuda().train()
    x = torch.randn(4, 440, 256, device="cuda", generator=gen)
    valid = torch.arange(440, device="cuda")[None] < torch.tensor(
        [[440], [300], [41], [1]], device="cuda")
    grads = {}
    for plain in (False, True):
        set_plain_attention(mha, plain)
        mha.zero_grad()
        rng = torch.Generator()
        rng.manual_seed(5)
        with attention_rng(rng):
            mha(x, x, x, valid).square().sum().backward()
        grads[plain] = {n: p.grad.clone() for n, p in mha.named_parameters()}
    # k_proj.bias shifts every logit of a row alike: its gradient is zero
    # in exact arithmetic and is held to the module's gradient scale
    scale = max(g.abs().max().item() for g in grads[True].values())
    for name, want in grads[True].items():
        got = grads[False][name]
        if name != "k_proj.bias":
            assert got.abs().max() > 0, name
        rel_close(got, want, GRAD_TOL[torch.float32], floor=0.1 * scale)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sk", TC_SK)
@pytest.mark.parametrize("sq", TC_SQ)
def test_tensor_core_kernels_match_plain(gen, sq, sk, d, rate):
    """K1-TC and K3-TC launched directly at every tile edge, batch row 0
    with every key masked, against the plain versions in float32 on the
    same bf16 inputs."""
    q, k, v, valid = inputs(gen, 2, sq, sk, 3, d, torch.bfloat16)
    seed = 0xABCD_EF01_2345 if rate else None
    out, lse = _launch_fwd("tc", q, k, v, valid, rate, seed)
    want, want_lse = attention_plain(q.float(), k.float(), v.float(), valid,
                                     True, dropout_rate=rate, seed=seed)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), want, atol=TOL[torch.bfloat16],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)
    do = torch.randn(out.shape, device="cuda", generator=gen).to(q.dtype)
    wants = attention_bwd_plain(q, k, v, valid, out, lse, do, rate, seed)
    dk, dv = _launch_dkv("tc", q, k, v, valid, out, lse, do, rate, seed)
    torch.cuda.synchronize()
    scale = max(w.float().abs().max().item() for w in wants)
    for got, w in ((dk, wants[1]), (dv, wants[2])):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape
        rel_close(got, w, GRAD_TOL[torch.bfloat16], floor=scale)


@pytest.mark.parametrize("shape", [(8, 440, 440, 8, 32), (2, 40, 40, 4, 64)])
def test_dropout_mask_is_exact_through_the_tensor_core_kernel(gen, shape):
    """As test_dropout_mask_is_exact, in bf16, where K1-TC runs: the p of a
    live key (logits of unit spread) stays far above bf16's smallest
    normal, so the kept set is read off exactly."""
    b, sq, sk, h, d = shape
    q, k, _, valid = inputs(gen, b, sq, sk, h, d, torch.bfloat16)
    rate, seed = 0.1, 42
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda")
    before = flash_attention.launches_tc
    for k0 in range(0, sk, d):
        v = torch.zeros(b, sk, h, d, device="cuda", dtype=torch.bfloat16)
        n = min(d, sk - k0)
        v[:, k0:k0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        out = flash_attention(q, k, v, valid, dropout_rate=rate, seed=seed)
        got = out[..., :n].permute(0, 2, 1, 3) != 0  # [B, H, Sq, n]
        live = torch.where(valid.any(-1, keepdim=True), valid,
                           True)[:, None, None, k0:k0 + n]
        want = keep[..., k0:k0 + n]
        assert torch.equal(got & live, want & live)
    assert flash_attention.launches_tc - before == -(-sk // d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_counters_count_only_bf16_calls(gen, dtype):
    """An encoder-shaped bf16 call goes through K1-TC and the warpgroup
    K2 and K3 (K2-wg writes K3-wg its di), a float32 one through the
    3xTF32 K1, K2 and K3; the totals count both."""
    q, k, v, valid = inputs(gen, 2, 440, 440, 8, 32, dtype)
    q.requires_grad_()
    counters = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)

    def counts():
        return [(c.launches, c.launches_tc, c.launches_wg,
                 c.launches_tf32x3) for c in counters]

    before = counts()
    flash_attention(q, k, v, valid).float().sum().backward()
    torch.cuda.synchronize()
    bf16 = int(dtype == torch.bfloat16)
    assert [tuple(a - b for a, b in zip(x, y))
            for x, y in zip(counts(), before)] == [
        (1, bf16, 0, 1 - bf16), (1, 0, bf16, 1 - bf16),
        (1, 0, bf16, 1 - bf16)]


def test_tensor_core_kernels_refuse_what_they_do_not_take(gen):
    q, k, v, valid = inputs(gen, 2, 64, 64, 2, 32, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        _launch_fwd("tc", q, k, v, valid, 0.0, None)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    shifted = torch.empty(qb.numel() + 1, device="cuda",
                          dtype=torch.bfloat16)[1:].view(qb.shape)
    shifted.copy_(qb)
    with pytest.raises(ValueError, match="aligned"):
        _launch_fwd("tc", shifted, kb, vb, valid, 0.0, None)
    with pytest.raises(ValueError, match="variant"):
        _launch_fwd("wgmma", qb, kb, vb, valid, 0.0, None)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sk", TC_SK)
@pytest.mark.parametrize("sq", TC_SQ)
def test_dq_tensor_core_kernel_matches_plain(gen, sq, sk, d, rate):
    """K2-TC launched directly at every tile edge, batch row 0 with every
    key masked, against attention_bwd_plain's dq on the same bf16 inputs,
    O and lse."""
    q, k, v, valid = inputs(gen, 2, sq, sk, 3, d, torch.bfloat16)
    seed = 0x1357_9BDF_2468 if rate else None
    out, lse = (x.contiguous() for x in attention_plain(
        q, k, v, valid, True, dropout_rate=rate, seed=seed))
    do = torch.randn(out.shape, device="cuda", generator=gen).to(q.dtype)
    wants = attention_bwd_plain(q, k, v, valid, out, lse, do, rate, seed)
    before = flash_attn_bwd_dq.launches_tc
    dq = _launch_dq("tc", q, k, v, valid, out, lse, do, rate, seed)
    torch.cuda.synchronize()
    assert flash_attn_bwd_dq.launches_tc == before + 1
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    scale = max(w.float().abs().max().item() for w in wants)
    rel_close(dq, wants[0], GRAD_TOL[torch.bfloat16], floor=scale)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sk", DEC_SK)
@pytest.mark.parametrize("sq", DEC_SQ)
def test_decode_kernel_matches_plain(gen, sq, sk, d, dtype, rate):
    """K1-dec launched directly: out and lse against the plain version in
    float32 on the same inputs, batch row 0 with every key masked."""
    q, k, v, valid = inputs(gen, 2, sq, sk, 3, d, dtype)
    seed = 0x2468_ACE0_1357 if rate else None
    before = flash_attention.launches_dec
    out, lse = _launch_fwd("dec", q, k, v, valid, rate, seed)
    want, want_lse = attention_plain(q.float(), k.float(), v.float(), valid,
                                     True, dropout_rate=rate, seed=seed)
    torch.cuda.synchronize()
    assert flash_attention.launches_dec == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 440, 8, 32), (2, 5, 65, 4, 64)])
def test_dropout_mask_is_exact_through_the_decode_kernel(gen, shape, dtype):
    """As test_dropout_mask_is_exact, with fewer than 16 queries, where
    K1-dec runs; Sk = 65 takes its one-Philox-call-per-element path."""
    b, sq, sk, h, d = shape
    q, k, _, valid = inputs(gen, b, sq, sk, h, d, dtype)
    rate, seed = 0.1, 4242
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda")
    before = flash_attention.launches_dec
    for k0 in range(0, sk, d):
        v = torch.zeros(b, sk, h, d, device="cuda", dtype=dtype)
        n = min(d, sk - k0)
        v[:, k0:k0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        out = flash_attention(q, k, v, valid, dropout_rate=rate, seed=seed)
        got = out[..., :n].permute(0, 2, 1, 3) != 0  # [B, H, Sq, n]
        live = torch.where(valid.any(-1, keepdim=True), valid,
                           True)[:, None, None, k0:k0 + n]
        want = keep[..., k0:k0 + n]
        assert torch.equal(got & live, want & live)
    assert flash_attention.launches_dec - before == -(-sk // d)


@pytest.mark.parametrize("shape,dtype,want", [
    ((2, 1, 440, 8, 32), torch.bfloat16, [(1, 0, 1)] * 3),
    ((2, 1, 1, 8, 32), torch.float32, [(1, 0, 1)] * 3),
    ((2, 40, 40, 12, 64), torch.bfloat16, [(1, 1, 0)] * 3),
    ((2, 40, 40, 12, 64), torch.float32, [(1, 0, 0)] * 3)])
def test_decode_and_dq_counters_count_only_their_own_calls(gen, shape, dtype,
                                                          want):
    """One forward and backward per shape: K1's, K2's and K3's (launches,
    launches_tc, launches_dec) each move by their own variant's launch
    only; the decode backward's one launch counts on K2 and on K3."""
    q, k, v, valid = inputs(gen, *shape, dtype)
    q.requires_grad_()

    def counts():
        return [(c.launches, c.launches_tc, c.launches_dec)
                for c in (flash_attention, flash_attn_bwd_dq,
                          flash_attn_bwd_dkv)]

    before = counts()
    flash_attention(q, k, v, valid).float().sum().backward()
    torch.cuda.synchronize()
    assert [tuple(a - b for a, b in zip(x, y))
            for x, y in zip(counts(), before)] == want


def test_decode_and_dq_kernels_refuse_what_they_do_not_take(gen):
    q, k, v, valid = inputs(gen, 2, 64, 64, 2, 32, torch.float32)
    out, lse = (x.contiguous() for x in attention_plain(q, k, v, valid,
                                                        True))
    with pytest.raises(TypeError, match="bfloat16"):
        _launch_dq("tc", q, k, v, valid, out, lse, out, 0.0, None)
    qb, kb, vb, ob = (x.to(torch.bfloat16) for x in (q, k, v, out))
    shifted = torch.empty(qb.numel() + 1, device="cuda",
                          dtype=torch.bfloat16)[1:].view(qb.shape)
    shifted.copy_(qb)
    with pytest.raises(ValueError, match="aligned"):
        _launch_dq("tc", shifted, kb, vb, valid, ob, lse, ob, 0.0, None)
    with pytest.raises(ValueError, match="variant"):
        _launch_dq("wgmma", qb, kb, vb, valid, ob, lse, ob, 0.0, None)
    with pytest.raises(TypeError, match="float32"):
        _launch_dq("tc", qb, kb, vb, valid, ob, lse.double(), ob, 0.0, None)
    # the decode backward: fewer than 16 queries, float32 or bf16, aligned
    with pytest.raises(ValueError, match="fewer than 16"):
        _launch_dq("dec", qb, kb, vb, valid, ob, lse, ob, 0.0, None)
    q1, o1 = (x[:, :1].contiguous() for x in (qb, ob))
    lse1 = lse[..., :1].contiguous()
    shifted1 = torch.empty(q1.numel() + 1, device="cuda",
                           dtype=torch.bfloat16)[1:].view(q1.shape)
    shifted1.copy_(q1)
    with pytest.raises(ValueError, match="aligned"):
        _launch_dkv("dec", shifted1, kb, vb, valid, o1, lse1, o1, 0.0, None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _launch_bwd_dec(*(x.double() for x in (q1, kb, vb)), valid,
                        o1.double(), lse1, o1.double(), 0.0, None)
    q1 = torch.empty(2 * 2 * 32 + 1, device="cuda")[1:].view(2, 1, 2, 32)
    with pytest.raises(ValueError, match="aligned"):
        _launch_fwd("dec", q1, k, v, None, 0.0, None)
    with pytest.raises(ValueError, match="head_dim"):
        w = torch.zeros(2, 1, 2, 160, device="cuda")
        _launch_fwd("dec", w, w, w, None, 0.0, None)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sk", DEC_SK)
@pytest.mark.parametrize("sq", DEC_SQ)
def test_decode_backward_matches_plain(gen, sq, sk, d, dtype, rate):
    """The decode backward launched directly: dq, dk and dv against
    attention_bwd_plain on the same inputs, O and lse, batch row 0 with
    every key masked; its one launch counts on K2 and on K3."""
    q, k, v, valid = inputs(gen, 2, sq, sk, 3, d, dtype)
    seed = 0x3579_BDF1_2468 if rate else None
    out, lse = (x.contiguous() for x in attention_plain(
        q, k, v, valid, True, dropout_rate=rate, seed=seed))
    do = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
    wants = attention_bwd_plain(q, k, v, valid, out, lse, do, rate, seed)
    counters = (flash_attn_bwd_dq, flash_attn_bwd_dkv)
    before = [(c.launches, c.launches_dec) for c in counters]
    grads = _launch_bwd_dec(q, k, v, valid, out, lse, do, rate, seed)
    torch.cuda.synchronize()
    assert [(c.launches - a, c.launches_dec - b)
            for c, (a, b) in zip(counters, before)] == [(1, 1), (1, 1)]
    scale = max(w.float().abs().max().item() for w in wants)
    for got, w in zip(grads, wants):
        assert got.dtype == dtype and got.shape == w.shape
        rel_close(got, w, GRAD_TOL[dtype], floor=scale)


def keep_live(valid):
    """[B, 1, 1, Sk]: the keys with p > 0 (every key of a row that has no
    valid key)."""
    return torch.where(valid.any(-1, keepdim=True), valid,
                       True)[:, None, None, :]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 440, 8, 32), (2, 5, 65, 4, 64),
                                   (2, 15, 17, 2, 16)])
def test_dropout_mask_is_exact_through_the_decode_backward(gen, shape,
                                                           dtype):
    """The decode backward's kept set equals the plain Philox mask, read
    off dv and off dq. dv: q = 0 makes p uniform over a row's live keys and
    dO one-hot over the head dim for D queries at a time gives dv_j[d] =
    p * keep(i0 + d, j). dq: q = 0, lse = 0 and O = 0 with dO and v one-hot
    on head dim 0 make ds the keep multiplier, and k one-hot over the head
    dim for D keys at a time gives dq_i[d] = scale * ds(i, k0 + d). Sk = 65
    and 17 take the one-Philox-call-per-element path."""
    b, sq, sk, h, d = shape
    _, k, v, valid = inputs(gen, b, sq, sk, h, d, dtype)
    rate, seed = 0.1, 0xDEC0DE
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda")
    live = keep_live(valid)
    q = torch.zeros(b, sq, h, d, device="cuda", dtype=dtype)
    o = torch.zeros_like(q)
    lse = attention_plain(q, k, v, valid, True)[1].contiguous()
    for i0 in range(0, sq, d):
        n = min(d, sq - i0)
        do = torch.zeros_like(q)
        do[:, i0:i0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        dv = _launch_bwd_dec(q, k, v, valid, o, lse, do, rate, seed)[2]
        got = dv[..., :n].permute(0, 2, 3, 1) != 0  # [B, H, n, Sk]
        m = live.expand_as(got)
        assert torch.equal(got[m], keep[:, :, i0:i0 + n][m])
    do = torch.zeros_like(q)
    do[..., 0] = 1
    v1 = torch.zeros_like(v)
    v1[..., 0] = 1
    lse0 = torch.zeros_like(lse)
    for k0 in range(0, sk, d):
        n = min(d, sk - k0)
        k1 = torch.zeros_like(k)
        k1[:, k0:k0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        dq = _launch_bwd_dec(q, k1, v1, valid, o, lse0, do, rate, seed)[0]
        got = dq[..., :n].permute(0, 2, 1, 3) != 0  # [B, H, Sq, n]
        m = live[..., k0:k0 + n].expand_as(got)
        assert torch.equal(got[m], keep[..., k0:k0 + n][m])


def same_bits(a, b):
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 440, 8, 32), (2, 15, 300, 4, 64)])
def test_decode_backward_is_bitwise_repeatable(gen, shape, dtype, rate):
    """dq is summed inside one block in a fixed order (no atomics): two
    calls on the same inputs give the same bits in dq, dk and dv."""
    q, k, v, valid = inputs(gen, *shape, dtype)
    seed = 0x1111_3333_5555 if rate else None
    out, lse = (x.contiguous() for x in attention_plain(
        q, k, v, valid, True, dropout_rate=rate, seed=seed))
    do = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
    first = _launch_bwd_dec(q, k, v, valid, out, lse, do, rate, seed)
    second = _launch_bwd_dec(q, k, v, valid, out, lse, do, rate, seed)
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(first, second))


F32TC_S = (16, 17, 63, 64, 65, 129, 440)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sk", F32TC_S)
@pytest.mark.parametrize("sq", F32TC_S)
def test_f32_tensor_core_kernels_match_plain(gen, sq, sk, d, rate):
    """K2-f32tc and K3-f32tc (3xTF32) launched directly at the edges of
    their 64-row and 64-key tiles, batch row 0 with every key masked,
    against attention_bwd_plain on the same float32 inputs, O and lse, at
    float32's tolerance; each launch counts in launches_tf32x3."""
    q, k, v, valid = inputs(gen, 2, sq, sk, 3, d, torch.float32)
    seed = 0x7F32_0C0D_E5ED if rate else None
    out, lse = (x.contiguous() for x in attention_plain(
        q, k, v, valid, True, dropout_rate=rate, seed=seed))
    do = torch.randn(out.shape, device="cuda", generator=gen)
    wants = attention_bwd_plain(q, k, v, valid, out, lse, do, rate, seed)
    before = (flash_attn_bwd_dq.launches_tf32x3,
              flash_attn_bwd_dkv.launches_tf32x3)
    dq = _launch_dq("tf32x3", q, k, v, valid, out, lse, do, rate, seed)
    dk, dv = _launch_dkv("tf32x3", q, k, v, valid, out, lse, do, rate, seed)
    torch.cuda.synchronize()
    assert (flash_attn_bwd_dq.launches_tf32x3,
            flash_attn_bwd_dkv.launches_tf32x3) == (before[0] + 1,
                                                    before[1] + 1)
    scale = max(w.abs().max().item() for w in wants)
    for got, w in zip((dq, dk, dv), wants):
        assert got.dtype == torch.float32 and got.shape == w.shape
        rel_close(got, w, GRAD_TOL[torch.float32], floor=scale)


@pytest.mark.parametrize("shape", [(8, 440, 440, 8, 32), (2, 40, 40, 4, 64),
                                   (2, 33, 65, 2, 16), (2, 70, 130, 2, 128)])
def test_dropout_mask_is_exact_through_the_f32_tensor_core_kernels(gen,
                                                                   shape):
    """The 3xTF32 kernels' kept set equals the plain Philox mask, read off
    dq (K2) and dv (K3) as in test_dropout_mask_is_exact_through_the_decode
    _backward; Sk = 65 and 130 take the one-Philox-call-per-element
    path."""
    b, sq, sk, h, d = shape
    _, k, v, valid = inputs(gen, b, sq, sk, h, d, torch.float32)
    rate, seed = 0.1, 0xF32C
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda")
    live = keep_live(valid)
    q = torch.zeros(b, sq, h, d, device="cuda")
    o = torch.zeros_like(q)
    lse = attention_plain(q, k, v, valid, True)[1].contiguous()
    for i0 in range(0, sq, d):
        n = min(d, sq - i0)
        do = torch.zeros_like(q)
        do[:, i0:i0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        dv = _launch_dkv("tf32x3", q, k, v, valid, o, lse, do, rate, seed)[1]
        got = dv[..., :n].permute(0, 2, 3, 1) != 0  # [B, H, n, Sk]
        m = live.expand_as(got)
        assert torch.equal(got[m], keep[:, :, i0:i0 + n][m])
    do = torch.zeros_like(q)
    do[..., 0] = 1
    v1 = torch.zeros_like(v)
    v1[..., 0] = 1
    lse0 = torch.zeros_like(lse)
    for k0 in range(0, sk, d):
        n = min(d, sk - k0)
        k1 = torch.zeros_like(k)
        k1[:, k0:k0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        dq = _launch_dq("tf32x3", q, k1, v1, valid, o, lse0, do, rate, seed)
        got = dq[..., :n].permute(0, 2, 1, 3) != 0  # [B, H, Sq, n]
        m = live[..., k0:k0 + n].expand_as(got)
        assert torch.equal(got[m], keep[..., k0:k0 + n][m])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(8, 440, 440, 8, 32), (2, 40, 40, 12, 64),
                                   (2, 70, 130, 2, 128)])
def test_f32_tensor_core_kernels_are_bitwise_repeatable(gen, shape, rate):
    """dq sums over keys inside K2's block and dk, dv over queries inside
    K3's (no atomics): two calls on the same inputs give the same bits."""
    q, k, v, valid = inputs(gen, *shape, torch.float32)
    seed = 0x2222_4444_6666 if rate else None
    out, lse = (x.contiguous() for x in attention_plain(
        q, k, v, valid, True, dropout_rate=rate, seed=seed))
    do = torch.randn(out.shape, device="cuda", generator=gen)
    args = (q, k, v, valid, out, lse, do, rate, seed)
    first = (_launch_dq("tf32x3", *args), *_launch_dkv("tf32x3", *args))
    second = (_launch_dq("tf32x3", *args), *_launch_dkv("tf32x3", *args))
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(first, second))


def test_f32_tensor_core_kernels_refuse_what_they_do_not_take(gen):
    q, k, v, valid = inputs(gen, 2, 64, 64, 2, 32, torch.float32)
    out, lse = (x.contiguous() for x in attention_plain(q, k, v, valid,
                                                        True))
    qb, kb, vb, ob = (x.to(torch.bfloat16) for x in (q, k, v, out))
    with pytest.raises(TypeError, match="float32"):
        _launch_dq("tf32x3", qb, kb, vb, valid, ob, lse, ob, 0.0, None)
    with pytest.raises(TypeError, match="float32"):
        _launch_dkv("tf32x3", qb, kb, vb, valid, ob, lse, ob, 0.0, None)
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        _launch_dq("tf32x3", shifted, k, v, valid, out, lse, out, 0.0, None)
    with pytest.raises(ValueError, match="aligned"):
        _launch_dkv("tf32x3", shifted, k, v, valid, out, lse, out, 0.0,
                    None)


F32FWD_S = (16, 17, 40, 63, 64, 65, 130, 440)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sk", F32FWD_S)
@pytest.mark.parametrize("sq", F32FWD_S)
def test_f32_forward_kernel_matches_plain(gen, sq, sk, d, rate):
    """K1-f32tc (3xTF32) launched directly at the edges of its 64-row and
    64-key tiles and 16-key parts (BERT's 40, the encoder's 440), batch row
    0 with every key masked, against attention_plain on the same float32
    inputs: out within 1e-5 max abs and lse within 1e-5 + 1e-6 relative,
    float32's tolerances; each launch counts in launches_tf32x3."""
    q, k, v, valid = inputs(gen, 2, sq, sk, 3, d, torch.float32)
    seed = 0x7F32_F0D0_0001 if rate else None
    before = flash_attention.launches_tf32x3
    out, lse = _launch_fwd("tf32x3", q, k, v, valid, rate, seed)
    want, want_lse = attention_plain(q, k, v, valid, True, dropout_rate=rate,
                                     seed=seed)
    torch.cuda.synchronize()
    assert flash_attention.launches_tf32x3 == before + 1
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(out, want, atol=TOL[torch.float32], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("shape", [(8, 440, 440, 8, 32), (2, 40, 40, 4, 64),
                                   (2, 33, 65, 2, 16), (2, 70, 130, 2, 128)])
def test_dropout_mask_is_exact_through_the_f32_forward_kernel(gen, shape):
    """As test_dropout_mask_is_exact, through K1-f32tc launched directly:
    v one-hot over the head dim reads p * keep off the output for D keys at
    a time; Sk = 65 and 130 take the one-Philox-call-per-element path."""
    b, sq, sk, h, d = shape
    q, k, _, valid = inputs(gen, b, sq, sk, h, d, torch.float32)
    rate, seed = 0.1, 0xF32F
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda")
    live = keep_live(valid)
    for k0 in range(0, sk, d):
        n = min(d, sk - k0)
        v = torch.zeros(b, sk, h, d, device="cuda")
        v[:, k0:k0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        out = _launch_fwd("tf32x3", q, k, v, valid, rate, seed, False)[0]
        got = out[..., :n].permute(0, 2, 1, 3) != 0  # [B, H, Sq, n]
        m = live[..., k0:k0 + n].expand_as(got)
        assert torch.equal(got[m], keep[..., k0:k0 + n][m])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(8, 440, 440, 8, 32), (2, 40, 40, 12, 64),
                                   (2, 70, 130, 2, 128)])
def test_f32_forward_kernel_is_bitwise_repeatable(gen, shape, rate):
    """Each output row is summed by one warp in a fixed order (no atomics):
    two calls on the same inputs give the same bits in out and lse."""
    q, k, v, valid = inputs(gen, *shape, torch.float32)
    seed = 0x3333_5555_7777 if rate else None
    first = _launch_fwd("tf32x3", q, k, v, valid, rate, seed)
    second = _launch_fwd("tf32x3", q, k, v, valid, rate, seed)
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("sq,d,dtype,want", [
    (1, 32, torch.float32, 0), (15, 32, torch.float32, 0),
    (16, 32, torch.float32, 1), (440, 32, torch.float32, 1),
    (40, 64, torch.float32, 1), (40, 160, torch.float32, 0),
    (16, 32, torch.bfloat16, 0), (440, 32, torch.bfloat16, 0)])
def test_f32_forward_counter_counts_only_its_calls(gen, sq, d, dtype, want):
    """Through the rule, K1's launches_tf32x3 moves for float32 calls with
    16 or more queries and a head dim up to 128, and for no other; the
    SIMT K1 is never launched (every launch of K1 is counted in one of
    its other variants, or the call is plain)."""
    q, k, v, valid = inputs(gen, 2, sq, 40, 2, d, dtype)
    c = flash_attention
    before = (c.launches, c.launches_tf32x3, c.launches_tc, c.launches_dec)
    flash_attention(q, k, v, valid)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(
        (c.launches, c.launches_tf32x3, c.launches_tc, c.launches_dec),
        before)]
    assert moved[1] == want
    assert moved[0] == sum(moved[1:])


def test_f32_forward_kernel_refuses_what_it_does_not_take(gen):
    q, k, v, valid = inputs(gen, 2, 64, 64, 2, 32, torch.float32)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    with pytest.raises(TypeError, match="float32"):
        _launch_fwd("tf32x3", qb, kb, vb, valid, 0.0, None)
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        _launch_fwd("tf32x3", shifted, k, v, valid, 0.0, None)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _launch_fwd("tf32x3", q.cpu(), k.cpu(), v.cpu(), valid.cpu(), 0.0,
                    None)


# (B, Sq, Sk, H): the decode kernels (fewer than 16 queries), the
# tensor-core kernels (both sides 16 or more), and K3's with fewer than
# 16 keys
ROUTE_SHAPES = [(2, 3, 130, 2), (2, 70, 130, 2), (2, 70, 9, 2)]
# K3 with 16 or more queries and fewer than 16 keys: phase 3c's site
# (B=8, Sq=440, H=8, D=32) at these key counts
SHORT_SK = (1, 8, 15)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", SHORT_SK)
def test_k3_below_16_keys_runs_on_the_tensor_cores(gen, sk, dtype, rate):
    """K3 with fewer than 16 keys takes the tensor cores through the rule
    ("tc" in bf16, "tf32x3" in float32; the warps of a 64-key block whose
    keys all lie past Sk skip their products): one launch on that counter
    a call, dk and dv against attention_bwd_plain at phase 3's tolerances,
    the same bits on a repeated call."""
    b, sq, h, d = 8, 440, 8, 32
    q, k, v, valid = inputs(gen, b, sq, sk, h, d, dtype)
    seed = 0x3C_0001 + sk if rate else None
    out, lse = attention_plain(q.float(), k.float(), v.float(), valid, True,
                               dropout_rate=rate, seed=seed)
    out, lse = out.to(dtype).contiguous(), lse.contiguous()
    do = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
    args = (q, k, v, valid, out, lse, do, rate, seed)
    variant = "tc" if dtype == torch.bfloat16 else "tf32x3"
    assert dkv_variant(sq, sk, dtype, d) == variant
    c = flash_attn_bwd_dkv
    before = (c.launches, getattr(c, f"launches_{variant}"))
    first = flash_attn_bwd_dkv(*args)
    second = flash_attn_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert (c.launches, getattr(c, f"launches_{variant}")) == (
        before[0] + 2, before[1] + 2)
    wants = attention_bwd_plain(*args)
    scale = max(w.float().abs().max().item() for w in wants)
    for got, w in zip(first, wants[1:]):
        assert got.dtype == dtype and got.shape == w.shape
        rel_close(got, w, GRAD_TOL[dtype], floor=scale)
    assert all(same_bits(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", SHORT_SK)
def test_k3_below_16_keys_mask_is_exact(gen, sk, dtype):
    """The kept set of K3 with fewer than 16 keys equals the plain Philox
    mask, read off dv as in test_dropout_mask_is_exact_through_the_f32_
    tensor_core_kernels: q = 0 makes p uniform over the valid keys, dO
    one-hot over the head dim for D queries at a time."""
    b, sq, h, d = 2, 70, 2, 32
    _, k, v, valid = inputs(gen, b, sq, sk, h, d, dtype)
    rate, seed = 0.1, 0x3C_0E1F
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda")
    live = keep_live(valid)
    q = torch.zeros(b, sq, h, d, device="cuda", dtype=dtype)
    o = torch.zeros_like(q)
    lse = attention_plain(q.float(), k.float(), v.float(), valid,
                          True)[1].contiguous()
    for i0 in range(0, sq, d):
        n = min(d, sq - i0)
        do = torch.zeros_like(q)
        do[:, i0:i0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        dv = flash_attn_bwd_dkv(q, k, v, valid, o, lse, do, rate, seed)[1]
        got = dv[..., :n].permute(0, 2, 3, 1) != 0  # [B, H, n, Sk]
        m = live.expand_as(got)
        assert torch.equal(got[m], keep[:, :, i0:i0 + n][m])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ROUTE_SHAPES)
@pytest.mark.parametrize("d", [8, 24, 48, 96, 128, 160])
def test_every_route_takes_odd_head_dims(gen, d, shape, dtype, rate):
    """K1, K2 and K3 through the rule at head dims that pad to the next
    instance (8, 24, 48, 96), the largest instance and one above it (160,
    the plain versions by the rule): out, lse and the gradients against
    the plain versions on the same inputs. A kernel route launches and
    counts nothing as plain; the plain route launches nothing."""
    b, sq, sk, h = shape
    q, k, v, valid = inputs(gen, b, sq, sk, h, d, dtype)
    seed = 0x0DD0_1234 if rate else None
    counters = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    before = [(c.launches, c.launches_plain) for c in counters]
    tf32x3 = flash_attention.launches_tf32x3
    out, lse = flash_attention(q, k, v, valid, return_lse=True,
                               dropout_rate=rate, seed=seed)
    want, want_lse = attention_plain(q.float(), k.float(), v.float(), valid,
                                     True, dropout_rate=rate, seed=seed)
    do = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
    args = (q, k, v, valid, out, lse, do, rate, seed)
    grads = (flash_attn_bwd_dq(*args),
             *flash_attn_bwd_dkv(*args))
    wants = attention_bwd_plain(*args)
    torch.cuda.synchronize()
    moved = [(c.launches - n, c.launches_plain - m)
             for c, (n, m) in zip(counters, before)]
    plain = d > 128
    assert all((n == 0) == plain and (m > 0) == plain for n, m in moved)
    assert flash_attention.launches_tf32x3 - tf32x3 == (
        fwd_variant(sq, sk, dtype, d) == "tf32x3")
    assert {fwd_variant(sq, sk, dtype, d), dq_variant(sq, sk, dtype, d),
            dkv_variant(sq, sk, dtype, d)} >= ({"plain"} if plain else set())
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)
    scale = max(w.float().abs().max().item() for w in wants)
    for got, w in zip(grads, wants):
        assert got.dtype == dtype and got.shape == w.shape
        rel_close(got, w, GRAD_TOL[dtype], floor=scale)


def test_plain_route_is_counted_and_launches_nothing(gen):
    """A head dim above 128 goes to the plain versions by the rule, through
    the autograd Function too: one count in launches_plain for the
    forward and one on each of K2 and K3 for the backward, and no kernel
    launch."""
    q, k, v, valid = inputs(gen, 2, 40, 40, 1, 256, torch.float32)
    q.requires_grad_()
    counters = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    before = [(c.launches, c.launches_plain) for c in counters]
    flash_attention(q, k, v, valid).sum().backward()
    torch.cuda.synchronize()
    assert [(c.launches - n, c.launches_plain - m)
            for c, (n, m) in zip(counters, before)] == [(0, 1)] * 3
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_run_training_launches_the_kernels_per_step_and_eval_batch(
        tmp_path):
    """One epoch of the training driver on the card at a small float32
    config: 2 train steps and 8 eval batches. A forward has 5 attentions:
    BERT tiny's 2 (40 queries) and the encoder's 1 (44) on the 3xTF32
    kernels, the decoder's 2 (one query) on the decode kernels; a train
    step launches each of K1, K2 and K3 once for each, an eval batch K1
    alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    import json

    from reftr_torch.core.config import (BertConfig, DataConfig,
                                         ModelConfig, RefTRConfig,
                                         TrainConfig)
    from reftr_torch.train.loop import run_training

    cfg = RefTRConfig(
        model=ModelConfig(bert=BertConfig.tiny(), enc_layers=1,
                          dec_layers=1, dim_feedforward=64, hidden_dim=64,
                          nheads=4, aux_loss=True, dtype="float32"),
        data=DataConfig(dataset="synthetic", train_split="train",
                        test_splits=("val",), img_size=64, max_img_size=64,
                        batch_size=8, num_workers=2, synthetic_n=16),
        train=TrainConfig(epochs=1, output_dir=str(tmp_path), seed=0))
    wrappers = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    variants = ("launches", "launches_tc", "launches_tf32x3",
                "launches_dec", "launches_plain")
    for w in wrappers:
        for v in variants:
            setattr(w, v, 0)
    result = run_training(cfg)
    torch.cuda.synchronize()
    steps, evals = 2, 8
    for w in wrappers:
        fwds = steps + evals if w is flash_attention else steps
        got = {v: getattr(w, v) for v in variants}
        assert got == {"launches": 5 * fwds, "launches_tc": 0,
                       "launches_tf32x3": 3 * fwds, "launches_dec": 2 * fwds,
                       "launches_plain": 0}, w.__name__
    (entry,) = result["history"]
    with open(tmp_path / "log.txt") as f:
        assert json.loads(f.readline()) == entry
    assert (tmp_path / "checkpoint").is_file()


def _res_config(**model):
    """A small float32 RES config: BERT tiny (two layers), one encoder and
    one decoder layer, d=128 and 8 heads (GroupNorm's 8 groups divide the
    mask head's 264 and 8 channels), 64 px canvases."""
    from reftr_torch.core.config import BertConfig, ModelConfig

    bert = BertConfig.tiny()
    bert.hidden_dropout = bert.attention_dropout = 0.0
    return ModelConfig(bert=bert, enc_layers=1, dec_layers=1,
                       dim_feedforward=64, hidden_dim=128, nheads=8,
                       aux_loss=True, masks=True, dropout=0.0,
                       dtype="float32", **model)


def _res_batch(b=4, hw=64, s=12):
    g = torch.Generator().manual_seed(0)
    valid = torch.zeros(b, hw, hw, dtype=torch.bool)
    sent_valid = torch.zeros(b, s, dtype=torch.int32)
    for i in range(b):
        valid[i, :hw - 8 * i, :hw - 4 * i] = True
        sent_valid[i, :s - 2 * i] = 1
    masks = torch.zeros(b, hw, hw)
    masks[:, 10:40, 12:50] = 1.0
    batch = {"image": torch.randint(0, 256, (b, hw, hw, 3), generator=g,
                                    dtype=torch.uint8),
             "image_valid": valid,
             "sentence": torch.randint(1, 512, (b, s), generator=g,
                                       dtype=torch.int32),
             "sentence_valid": sent_valid}
    targets = {"boxes": torch.tensor([[[0.5, 0.4, 0.4, 0.5]]] * b),
               "box_valid": torch.ones(b, 1, dtype=torch.bool),
               "masks": masks, "mask_valid": torch.ones(b, dtype=torch.bool)}
    return ({k: v.numpy() for k, v in batch.items()},
            {k: v.numpy() for k, v in targets.items()})


@pytest.mark.parametrize("freeze_reftr", [False, True])
def test_res_step_launches_the_kernels(gen, freeze_reftr):
    """One RES train step and one eval forward: BERT tiny's 2 attentions
    and the encoder's 1 on the 3xTF32 kernels, the decoder's 2 on the
    decode kernels. K1 runs 5 times in each; K2 and K3 5 times in the step,
    and not at all under freeze_reftr, whose trunk builds no graph."""
    from reftr_torch.core.config import LossConfig, TrainConfig
    from reftr_torch.models.criterion import weight_dict
    from reftr_torch.train.state import TrainState
    from reftr_torch.train.steps import make_eval_step, make_train_step

    mc = _res_config(freeze_reftr=freeze_reftr, ablation="cem_loss")
    state = TrainState.create(mc, TrainConfig(epochs=1), 1, seed=0)
    wd = weight_dict(LossConfig(), mc.dec_layers, mc.aux_loss,
                     with_masks=True)
    step = make_train_step(state.model, wd, LossConfig())
    batch, targets = _res_batch()
    wrappers = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    before = {w: w.launches for w in wrappers}
    state, metrics = step(state, batch, targets)
    torch.cuda.synchronize()
    got = {w: w.launches - before[w] for w in wrappers}
    bwd = 0 if freeze_reftr else 5
    assert got == {flash_attention: 5, flash_attn_bwd_dq: bwd,
                   flash_attn_bwd_dkv: bwd}
    m = metrics.get()
    assert all(torch.isfinite(torch.tensor(v)) for v in m.values())
    assert m["loss_mask"] > 0 and m["loss_dice"] > 0 and m["loss_cem"] > 0
    names = {n.split(".")[0] for n in state.param_names()}
    if freeze_reftr:
        assert names == {"bbox_attention", "mask_head", "cem_block"}
    before = {w: w.launches for w in wrappers}
    out, _, sums = make_eval_step(state.model, LossConfig())(batch, targets)
    torch.cuda.synchronize()
    assert {w: w.launches - before[w] for w in wrappers} == {
        flash_attention: 5, flash_attn_bwd_dq: 0, flash_attn_bwd_dkv: 0}
    assert out["pred_masks"].shape == (4, 1, 16, 16)
    assert 0.0 <= sums["sum_seg_iou"].item() <= sums["cnt_seg"].item() == 4


def test_res_kernel_path_matches_the_plain_path(gen, monkeypatch):
    """One float32 RES forward and backward (dropout 0) through the kernels
    and through the plain attention: the loss within 1e-5 relative, the
    mask logits within 1e-4 relative L2 and every gradient within 1e-3
    relative L2 of the plain path's (measured against the larger of its
    norm and 1e-4 of the global norm), the smoke's tolerances. The
    convolutions run in true float32, as in the smoke: with cuDNN's TF32
    the attention's 1e-6 differences flip the 10-bit rounding of the mask
    head's inputs, and the logits part by TF32's rounding (2e-4)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    from reftr_torch.convert import build_model
    from reftr_torch.core.config import LossConfig
    from reftr_torch.models.criterion import criterion, total_loss, weight_dict
    from reftr_torch.train.steps import to_device

    mc = _res_config(ablation="cem_loss")
    model = build_model(mc, seed=1).train()
    with torch.no_grad():
        torch.nn.init.xavier_uniform_(model.bbox_embed.layers[-1].weight,
                                      generator=gen)
    wd = weight_dict(LossConfig(), mc.dec_layers, mc.aux_loss,
                     with_masks=True)
    batch, targets = (to_device(x, torch.device("cuda"))
                      for x in _res_batch())
    runs = {}
    for plain in (False, True):
        set_plain_attention(model, plain)
        model.zero_grad(set_to_none=True)
        out = model(batch)
        loss = total_loss(criterion(out, targets, LossConfig(), True), wd)
        loss.backward()
        runs[plain] = (loss.item(), out["pred_masks"].detach(),
                       {n: p.grad.clone() for n, p in
                        model.named_parameters() if p.grad is not None})
    (lk, mk, gk), (lp, mp, gp) = runs[False], runs[True]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    assert ((mk - mp).norm() / mp.norm()).item() <= 1e-4
    norm = sum(float(g.square().sum()) for g in gp.values()) ** 0.5
    assert set(gk) == set(gp)
    for name, g in gp.items():
        err = float((gk[name] - g).norm()) / max(float(g.norm()),
                                                 1e-4 * norm)
        assert err <= 1e-3, name


# ---------------------------------------------------------------------------
# the multi-phrase path's call sites and the four-level encoder
# ---------------------------------------------------------------------------

# the flickr preset's new call sites (batch 16, 16 phrase slots, 90
# sentence tokens, 640 px: BERT over the 256 phrases of 22 tokens, the
# decoder's self- and cross-attention at 16 queries, the encoder over 90 +
# 20 x 20 tokens) and the VL encoder at four feature levels (40 + 80^2 +
# 40^2 + 20^2 + 10^2 tokens) at B=1: their shapes, key masks and K1's
# tolerance are chip_smoke.py's (site_inputs, kernel_tol), so the smoke's
# phase 8 and these tests hold the kernels to one rule
NEW_SITES = (list(chip_smoke.MULTI_SITES) + ["vl_encoder_4_levels"]
             + list(chip_smoke.SCRATCH_KERNEL_SITES))
DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", NEW_SITES)
def test_multi_phrase_and_long_sites_match_plain(gen, site, dtype, rate):
    """K1 with its lse, K2 and K3 at the new sites, each through the
    tensor-core kernels (16 or more queries and keys; in bf16 K1, K2 and
    K3 where the rule says so on the warpgroup kernels), against the plain
    versions (K1's in float32, as test_kernel_matches_plain's: two
    roundings to bf16 of one value may part by an ulp), at
    chip_smoke.kernel_tol and GRAD_TOL; the four-level encoder at B=1,
    where the plain version's [B, H, S, S] scores fit."""
    b, sq, sk, h, d = chip_smoke.site_shape(site)
    tc = "tc" if dtype == torch.bfloat16 else "tf32x3"
    assert {fwd_variant(sq, sk, dtype, d), dq_variant(sq, sk, dtype, d),
            dkv_variant(sq, sk, dtype, d)} <= {tc, "wg"}
    q, k, v, valid = chip_smoke.site_inputs(gen, site, dtype)
    seed = 0xABCD_0123_4567 if rate else None
    out, lse = flash_attention(q, k, v, valid, return_lse=True,
                               dropout_rate=rate, seed=seed)
    want, want_lse = attention_plain(q.float(), k.float(), v.float(), valid,
                                     return_lse=True, dropout_rate=rate,
                                     seed=seed)
    tol = chip_smoke.kernel_tol(DTYPE_NAME[dtype], site, want)
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)
    do = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
    wants = attention_bwd_plain(q, k, v, valid, out, lse, do, rate, seed)
    dq = flash_attn_bwd_dq(q, k, v, valid, out, lse, do, rate, seed)
    dk, dv = flash_attn_bwd_dkv(q, k, v, valid, out, lse, do, rate, seed)
    torch.cuda.synchronize()
    scale = max(w.float().abs().max().item() for w in wants)
    for got, w in zip((dq, dk, dv), wants):
        rel_close(got, w, GRAD_TOL[dtype], floor=scale)


def k1_kept(q, k, valid, rate, seed, first_row=0):
    """K1's kept set [B - first_row, H, Sq, Sk] read off its output with v
    one-hot over the head dim (D keys at a time), and where it is
    readable (p > 0: the valid keys, or every key of a row with none)."""
    b, sk, h, d = k.shape
    kept, live = [], []
    live_keys = torch.where(valid.any(-1, keepdim=True), valid, True)
    for k0 in range(0, sk, d):
        n = min(d, sk - k0)
        v = torch.zeros(b, sk, h, d, device="cuda", dtype=q.dtype)
        v[:, k0:k0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        out = flash_attention(q, k, v, valid, dropout_rate=rate, seed=seed)
        kept.append((out[first_row:, ..., :n] != 0).permute(0, 2, 1, 3))
    kept = torch.cat(kept, -1)
    return kept, live_keys[first_row:, None, None, :].expand_as(kept)


@pytest.mark.parametrize("site", NEW_SITES)
def test_dropout_mask_is_exact_at_the_new_sites(gen, site):
    """Through the bf16 tensor-core K1 (the multi-phrase path's dtype):
    its kept set equals the plain Philox mask on every readable key."""
    b, sq, sk, h, d = chip_smoke.site_shape(site)
    q, k, _, valid = chip_smoke.site_inputs(gen, site, torch.bfloat16)
    rate, seed = 0.1, 0xFEED
    kept, live = k1_kept(q, k, valid, rate, seed)
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda")
    assert torch.equal(kept & live, keep & live)


def test_dropout_mask_is_exact_past_2_to_the_32(gen):
    """The four-level encoder at B=8: B * H * S^2 = 4.67e9 elements, so
    the last batch row's offsets run past 2^32 (from head 3 on). Its kept
    set equals the plain mask of that row, drawn from its own offsets."""
    site = "vl_encoder_4_levels_b8"
    b, s, _, h, d = chip_smoke.site_shape(site)
    q, k, _, valid = chip_smoke.site_inputs(gen, site, torch.bfloat16)
    rate, seed = 0.1, 0x2_0000_0001
    assert (b - 1) * h * s * s < 2 ** 32 < b * h * s * s
    kept, live = k1_kept(q, k, valid, rate, seed, first_row=b - 1)
    keep = philox_keep_plain(seed, b, h, s, s, rate, "cuda",
                             first_row=b - 1)
    assert torch.equal(kept & live, keep & live)
    assert live.sum().item() > 0.9 * live.numel()


def test_multi_phrase_step_launches_42_on_the_tensor_cores(gen, tmp_path):
    """One bf16 train step and one eval forward of the flickr preset's
    attention stacks at full depth (BERT-base over the sentence and over
    the 16 phrase slots, 6 + 6 VL layers) on two multi-phrase fixture
    items at 64 px: 12 + 12 + 6 + 6 + 6 = 42 launches of each of K1, K2
    and K3 in the step and of K1 in the forward, every one on the bf16
    tensor-core kernels (16 phrase queries fill a tile)."""
    from reftr_torch.cli.presets import preset_config
    from reftr_torch.data.datasets import (SyntheticMultiPhraseDataset,
                                           write_synthetic_vocab)
    from reftr_torch.data.loader import collate
    from reftr_torch.data.native import WordPieceTokenizer
    from reftr_torch.models.criterion import weight_dict
    from reftr_torch.train.state import TrainState
    from reftr_torch.train.steps import make_eval_step, make_train_step

    cfg = preset_config("flickr", dtype="bfloat16")
    mc, d = cfg.model, cfg.data
    tok = WordPieceTokenizer(write_synthetic_vocab(str(tmp_path / "v.txt")))
    ds = SyntheticMultiPhraseDataset(
        tok, n=2, img_size=64, max_sentence_len=d.max_sentence_len,
        phrase_seq_len=d.phrase_seq_len, max_num_phrases=d.max_num_phrases)
    batch, targets = collate([ds[0], ds[1]])
    assert batch["phrases"].shape == (2, 16, 22)
    state = TrainState.create(mc, cfg.train, 1, seed=0)
    wd = weight_dict(cfg.loss, mc.dec_layers, mc.aux_loss)
    wrappers = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    variants = ("launches", "launches_tc", "launches_tf32x3",
                "launches_dec", "launches_plain")

    def counts():
        return {(w.__name__, v): getattr(w, v) for w in wrappers
                for v in variants}

    before = counts()
    state, metrics = make_train_step(state.model, wd, cfg.loss)(
        state, batch, targets)
    assert all(torch.isfinite(torch.tensor(x))
               for x in metrics.get().values())
    after = counts()
    for (name, v), n in after.items():
        want = 42 if v in ("launches", "launches_tc") else 0
        assert n - before[(name, v)] == want, (name, v)
    out, _, _ = make_eval_step(state.model, cfg.loss)(batch, targets)
    assert out["pred_boxes"].shape == (2, 16, 1, 4)
    final = counts()
    for (name, v), n in final.items():
        want = (42 if name == "flash_attention"
                and v in ("launches", "launches_tc") else 0)
        assert n - after[(name, v)] == want, (name, v)


# the warpgroup kernels launched directly at the edges of their 128-row,
# 128-key and 64-query tiles, a head dim that pads to 32, and the
# encoder's shape
WG_SHAPES = [(2, 16, 17, 2, 32), (2, 127, 129, 2, 32), (2, 128, 128, 2, 32),
             (2, 129, 300, 3, 32), (2, 200, 1, 2, 32), (2, 65, 385, 2, 24),
             (8, 440, 440, 8, 32)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", WG_SHAPES)
def test_warpgroup_kernels_match_plain(gen, shape, rate):
    """K1-wg (out and lse) and K3-wg, its di and keep bits from K2-wg's
    di_out and bits_out, against the plain versions in float32 on the same
    bf16 inputs, batch row 0 with every key masked (the uniform average);
    the keep bits equal keep_bits_plain's; each launch counted on
    launches_wg, and a second call gives the same bits."""
    b, sq, sk, h, d = shape
    q, k, v, valid = inputs(gen, b, sq, sk, h, d, torch.bfloat16)
    seed = 0x6E0_0000_0001 if rate else None
    before = (flash_attention.launches_wg, flash_attn_bwd_dkv.launches_wg)
    out, lse = _launch_fwd("wg", q, k, v, valid, rate, seed)
    want, want_lse = attention_plain(q.float(), k.float(), v.float(), valid,
                                     True, dropout_rate=rate, seed=seed)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), want, atol=TOL[torch.bfloat16],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)
    do = torch.randn(out.shape, device="cuda", generator=gen).to(q.dtype)
    args = (q, k, v, valid, out, lse, do, rate, seed)
    di = torch.empty_like(lse)
    bits = new_keep_bits(q, k) if rate else None
    _launch_dq("wg", *args, di_out=di, bits_out=bits)
    torch.testing.assert_close(di, di_plain(out, do), atol=1e-5, rtol=1e-5)
    if rate:
        assert chip_smoke.check_bits("K2-wg", bits, seed, rate, shape) > 0
    dk, dv = _launch_dkv("wg", *args, di, bits)
    wants = attention_bwd_plain(*args)
    torch.cuda.synchronize()
    scale = max(w.float().abs().max().item() for w in wants)
    for got, w in ((dk, wants[1]), (dv, wants[2])):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape
        rel_close(got, w, GRAD_TOL[torch.bfloat16], floor=scale)
    again = (*_launch_fwd("wg", q, k, v, valid, rate, seed),
             *_launch_dkv("wg", *args, di, bits))
    for x, y in zip((out, lse, dk, dv), again):
        assert chip_smoke.same_bits(x, y)
    assert (flash_attention.launches_wg - before[0],
            flash_attn_bwd_dkv.launches_wg - before[1]) == (2, 2)


WG_SITES = ["vl_encoder_self", "multi_vl_encoder_self", "vl_encoder_4_levels"]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("site", WG_SITES)
def test_warpgroup_kernels_match_plain_at_their_sites(gen, site, rate):
    """At the sites where the rule sends K2 and K3 (and at four levels K1)
    to the warpgroup kernels, with the smoke's inputs and tolerances:
    K1-wg, and K2-wg then K3-wg on its di and keep bits, against the plain
    versions, whatever the rule picks there for K1."""
    b, sq, sk, h, d = chip_smoke.site_shape(site)
    assert dkv_variant(sq, sk, torch.bfloat16, d) == "wg"
    assert dq_variant(sq, sk, torch.bfloat16, d) == "wg"
    q, k, v, valid = chip_smoke.site_inputs(gen, site, torch.bfloat16)
    seed = 0x517E if rate else None
    out, lse = _launch_fwd("wg", q, k, v, valid, rate, seed)
    want, want_lse = attention_plain(q.float(), k.float(), v.float(), valid,
                                     True, dropout_rate=rate, seed=seed)
    tol = chip_smoke.kernel_tol("bfloat16", site, want)
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)
    do = torch.randn(out.shape, device="cuda", generator=gen).to(q.dtype)
    args = (q, k, v, valid, out, lse, do, rate, seed)
    dq, dk, dv, bits = chip_smoke.wg_pair(args)
    if rate:
        chip_smoke.check_bits(site, bits, seed, rate, (b, sq, sk, h, d))
    wants = attention_bwd_plain(*args)
    torch.cuda.synchronize()
    scale = max(w.float().abs().max().item() for w in wants)
    for got, w in ((dq, wants[0]), (dk, wants[1]), (dv, wants[2])):
        rel_close(got, w, GRAD_TOL[torch.bfloat16], floor=scale)


@pytest.mark.parametrize("shape", [(8, 440, 440, 8, 32), (2, 70, 130, 2, 32),
                                   (2, 65, 17, 2, 32)])
def test_dropout_mask_is_exact_through_the_warpgroup_kernels(gen, shape):
    """K1-wg's kept set read off its output with v one-hot over the head
    dim (D keys at a time), and K3-wg's off dv with q = 0 (p uniform over
    the live keys, lse the log of their count, O = 0, so K2-wg's di = 0)
    and dO one-hot for D queries at a time, K3-wg reading the keep bits
    K2-wg wrote on the same inputs: each equals the plain Philox mask on
    every live key, where Sk % 4 == 0 and where not."""
    b, sq, sk, h, d = shape
    q, k, v, valid = inputs(gen, b, sq, sk, h, d, torch.bfloat16)
    rate, seed = 0.1, 0x6E6E
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda")
    live_keys = torch.where(valid.any(-1, keepdim=True), valid, True)
    for k0 in range(0, sk, d):
        n = min(d, sk - k0)
        onehot = torch.zeros_like(v)
        onehot[:, k0:k0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        out, _ = _launch_fwd("wg", q, k, onehot, valid, rate, seed, False)
        kept = out[..., :n].permute(0, 2, 1, 3) != 0
        live = live_keys[:, None, None, k0:k0 + n].expand_as(kept)
        assert torch.equal(kept[live], keep[..., k0:k0 + n][live])
    zero = torch.zeros_like(q)
    lse = live_keys.sum(-1).float().log()[:, None, None].expand(
        b, h, sq).contiguous()
    for i0 in range(0, sq, d):
        n = min(d, sq - i0)
        do = torch.zeros_like(q)
        do[:, i0:i0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        _, _, dv, _ = chip_smoke.wg_pair((zero, k, v, valid, zero, lse, do,
                                          rate, seed))
        kept = dv[..., :n].permute(0, 2, 3, 1) != 0
        live = live_keys[:, None, None, :].expand_as(kept)
        assert torch.equal(kept[live], keep[:, :, i0:i0 + n][live])


def test_k3_mask_is_exact_past_2_to_the_32(gen):
    """K3 through the rule (its warpgroup kernel) at the four-level encoder
    at B=8, in the last batch row, whose offsets run past 2^32: its kept
    set equals that row's plain mask (chip_smoke.check_dv_mask_exact, as
    phase 8d)."""
    site = "vl_encoder_4_levels_b8"
    b, sq, sk, h, d = chip_smoke.site_shape(site)
    assert dkv_variant(sq, sk, torch.bfloat16, d) == "wg"
    assert chip_smoke.check_dv_mask_exact(site, 0.1, 0x2_0000_0003,
                                          torch.bfloat16, b - 1) > 0


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_function_gradients_through_the_warpgroup_kernel(gen, rate):
    """FlashAttentionFn at a shape where the rule sends K2 and K3 to their
    warpgroup kernels: K2-wg hands K3-wg di and the keep bits, and the
    gradients match the plain path's; the backward counts one K2-wg and
    one K3-wg launch, and no keep bits from keep_bits_plain."""
    q, k, v, valid = inputs(gen, 2, 300, 300, 4, 32, torch.bfloat16)
    assert dkv_variant(300, 300, torch.bfloat16, 32) == "wg"
    seed = 91 if rate else None
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    grads = {}
    before = (flash_attn_bwd_dq.launches_wg, flash_attn_bwd_dkv.launches_wg,
              flash_attn_bwd_dkv.bits_plain)
    for name, fn in (("kernel", FlashAttentionFn.apply),
                     ("plain", lambda *a: attention_plain(
                         *a[:4], dropout_rate=a[4], seed=a[5]))):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves, valid, rate, seed).backward(do)
        grads[name] = [x.grad for x in leaves]
    assert (flash_attn_bwd_dq.launches_wg - before[0],
            flash_attn_bwd_dkv.launches_wg - before[1],
            flash_attn_bwd_dkv.bits_plain - before[2]) == (1, 1, 0)
    scale = max(w.float().abs().max().item() for w in grads["plain"])
    for got, want in zip(grads["kernel"], grads["plain"]):
        rel_close(got, want, GRAD_TOL[torch.bfloat16], floor=scale)


def test_warpgroup_kernels_refuse_what_they_do_not_take(gen):
    q, k, v, valid = inputs(gen, 2, 64, 64, 2, 32, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        _launch_fwd("wg", q, k, v, valid, 0.0, None)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    for d in (64, 128):
        wide = [torch.zeros(2, 64, 2, d, device="cuda", dtype=torch.bfloat16)
                for _ in range(3)]
        with pytest.raises(ValueError, match="head dims"):
            _launch_fwd("wg", *wide, valid, 0.0, None)
    shifted = torch.empty(qb.numel() + 1, device="cuda",
                          dtype=torch.bfloat16)[1:].view(qb.shape)
    shifted.copy_(qb)
    with pytest.raises(ValueError, match="aligned"):
        _launch_fwd("wg", shifted, kb, vb, valid, 0.0, None)
    out, lse = _launch_fwd("wg", qb, kb, vb, valid, 0.0, None)
    args = (qb, kb, vb, valid, out, lse, out, 0.0, None)
    with pytest.raises(ValueError, match="di"):
        _launch_dkv("wg", *args, lse.double())
    # without di, K3-wg computes it in its wrapper (di_plain), and without
    # keep bits it takes keep_bits_plain's (counted in bits_plain), also
    # through the wrapper where the rule sends K3 to "wg"
    q2, k2, v2, valid2 = inputs(gen, 2, 256, 256, 2, 32, torch.bfloat16)
    for rate, seed in ((0.0, None), (0.1, 0xB175)):
        out2, lse2 = _launch_fwd("wg", q2, k2, v2, valid2, rate, seed)
        args2 = (q2, k2, v2, valid2, out2, lse2, out2, rate, seed)
        bits = (keep_bits_plain(seed, 2, 2, 256, 256, rate, "cuda")
                if rate else None)
        want = _launch_dkv("wg", *args2, di_plain(out2, out2), bits)
        plain_before = flash_attn_bwd_dkv.bits_plain
        for got in (_launch_dkv("wg", *args2), flash_attn_bwd_dkv(*args2)):
            assert all(chip_smoke.same_bits(x, y) for x, y in zip(got, want))
        assert flash_attn_bwd_dkv.bits_plain - plain_before == (
            2 if rate else 0)
    with pytest.raises(ValueError, match="di_out"):
        _launch_dq("tf32x3", q, k, v, valid, q, lse, q, 0.0, None,
                   di_out=torch.empty_like(lse))
    # keep bits: uint32 [B, H, Sq, 4 ceil(Sk / 128)], with dropout only,
    # refused before any launch
    outd, lsed = _launch_fwd("wg", qb, kb, vb, valid, 0.1, 3)
    argsd = (qb, kb, vb, valid, outd, lsed, outd, 0.1, 3)
    counts = lambda: (flash_attn_bwd_dq.launches,  # noqa: E731
                      flash_attn_bwd_dkv.launches)
    before = counts()
    good = new_keep_bits(qb, kb)
    with pytest.raises(TypeError, match="uint32"):
        _launch_dkv("wg", *argsd, keep_bits=good.view(torch.int32))
    with pytest.raises(ValueError, match="bits_out"):
        _launch_dq("wg", *argsd, bits_out=good[:, :, :-1])
    with pytest.raises(ValueError, match="rate 0"):
        _launch_dq("wg", *args, bits_out=good)
    with pytest.raises(ValueError, match="K2-wg"):
        _launch_dq("tc", *argsd, bits_out=good)
    assert counts() == before


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", WG_SHAPES)
def test_dq_warpgroup_kernel_matches_plain(gen, shape, rate):
    """K2-wg launched directly at the edges of its 128-query and 64-key
    tiles: dq against attention_bwd_plain at GRAD_TOL of the largest plain
    gradient, batch row 0 with every key masked; its di_out equals
    di_plain, and with dropout its bits_out keep_bits_plain's; a second
    call gives the same bits, dq's and the keep bits; each launch counted
    on launches_wg."""
    b, sq, sk, h, d = shape
    q, k, v, valid = inputs(gen, b, sq, sk, h, d, torch.bfloat16)
    seed = 0x6E0_0000_0002 if rate else None
    out, lse = _launch_fwd("tc", q, k, v, valid, rate, seed)
    do = torch.randn(out.shape, device="cuda", generator=gen).to(q.dtype)
    args = (q, k, v, valid, out, lse, do, rate, seed)
    before = flash_attn_bwd_dq.launches_wg
    di = torch.full_like(lse, float("nan"))
    bits = new_keep_bits(q, k) if rate else None
    dq = _launch_dq("wg", *args, di_out=di, bits_out=bits)
    wants = attention_bwd_plain(*args)
    torch.cuda.synchronize()
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    torch.testing.assert_close(di, di_plain(out, do), atol=1e-5, rtol=1e-5)
    scale = max(w.float().abs().max().item() for w in wants)
    rel_close(dq, wants[0], GRAD_TOL[torch.bfloat16], floor=scale)
    bits2 = new_keep_bits(q, k) if rate else None
    assert chip_smoke.same_bits(dq, _launch_dq("wg", *args, bits_out=bits2))
    if rate:
        chip_smoke.check_bits("K2-wg", bits, seed, rate, shape)
        assert torch.equal(bits.view(torch.int32), bits2.view(torch.int32))
    assert flash_attn_bwd_dq.launches_wg - before == 2


LONG_SITES = ["vl_encoder_2_levels_b8", "multi_vl_encoder_2_levels",
              "vl_encoder_3_levels_b8", "vl_encoder_4_levels_b8",
              "vl_encoder_4_levels_b8_padded"]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("site", LONG_SITES)
def test_dq_warpgroup_kernel_matches_plain_at_the_long_sites(gen, site,
                                                             rate):
    """K2-wg at the encoders of 2-4 feature levels with the smoke's
    inputs (at four levels also with each image padded), the whole batch launched and batch row 0 (whose dropout
    offsets are those of B=1) held to attention_bwd_plain at B=1, where
    its [H, S, S] scores fit: dq at GRAD_TOL of the largest plain
    gradient, di against di_plain; with dropout the whole batch's keep
    bits against keep_bits_plain."""
    b, sq, sk, h, d = chip_smoke.site_shape(site)
    assert dq_variant(sq, sk, torch.bfloat16, d) == "wg"
    q, k, v, valid = chip_smoke.site_inputs(gen, site, torch.bfloat16)
    seed = 0x10_0000_0002 if rate else None
    out, lse = flash_attention(q, k, v, valid, return_lse=True,
                               dropout_rate=rate, seed=seed)
    do = torch.randn(out.shape, device="cuda", generator=gen).to(q.dtype)
    args = (q, k, v, valid, out, lse, do, rate, seed)
    di = torch.empty_like(lse)
    bits = new_keep_bits(q, k) if rate else None
    dq = _launch_dq("wg", *args, di_out=di, bits_out=bits)
    if rate:
        chip_smoke.check_bits(site, bits, seed, rate, (b, sq, sk, h, d))
    row0 = tuple(x[:1] if torch.is_tensor(x) else x for x in args)
    wants = attention_bwd_plain(*row0)
    torch.cuda.synchronize()
    torch.testing.assert_close(di[:1], di_plain(out[:1], do[:1]), atol=1e-5,
                               rtol=1e-5)
    scale = max(w.float().abs().max().item() for w in wants)
    rel_close(dq[:1], wants[0], GRAD_TOL[torch.bfloat16], floor=scale)


@pytest.mark.parametrize("variant", ["tc", "wg", "tf32x3"])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("shape", chip_smoke.KEEP_SHAPES)
def test_keep_bits_masks_are_exact_at_every_row_phase(gen, shape, kernel,
                                                      variant):
    """Every kernel that draws its dropout mask (K1 and K2, "tc", "wg" and
    "tf32x3": flash_tc::keep_bits),
    launched directly at key counts that are not a multiple of 4 (22, 90,
    490, 2090: row phases 0 and 2; 17, 131, 385: every phase): its kept
    set, read off K1's output or K2's dq, equals the plain Philox mask on
    every live key, and K2-wg's keep bits equal keep_bits_plain's
    (chip_smoke.check_mask_exact, check_dq_mask_exact, as phase 3e)."""
    dt = torch.float32 if variant == "tf32x3" else torch.bfloat16
    if kernel == "K1":
        n = chip_smoke.check_mask_exact(gen, shape, 0.1, 0x3E3E, dt,
                                        variant=variant)
    else:
        n = chip_smoke.check_dq_mask_exact(shape, 0.1, 0x3E3E, dt,
                                           variant=variant)
    assert n > 0


@pytest.mark.parametrize("variant", ["tc", "wg"])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_keep_bits_masks_are_exact_past_2_to_the_32_off_a_multiple_of_4(
        gen, kernel, variant):
    """The last batch row of B=8 at 8539^2 (a key count off a multiple of
    4, rows starting at every phase of a Philox counter), whose element
    offsets run past 2^32: K1's and K2's kept sets in bf16 equal that
    row's plain mask."""
    shape = chip_smoke.KEEP_SHAPE_PAST_2_32
    b, sq, sk, h, _ = shape
    assert sk % 4 and (b - 1) * h * sq * sk < 2 ** 32 < b * h * sq * sk
    if kernel == "K1":
        n = chip_smoke.check_mask_exact(gen, shape, 0.1, 0x2_0000_3E3E,
                                        torch.bfloat16, b - 1, variant)
    else:
        n = chip_smoke.check_dq_mask_exact(shape, 0.1, 0x2_0000_3E3E,
                                           torch.bfloat16, b - 1, variant)
    assert n > 0


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_function_gradients_through_the_dq_warpgroup_kernel(gen, rate):
    """FlashAttentionFn where the rule sends K2 and K3 to their warpgroup
    kernels: K2-wg hands K3-wg di and the keep bits, and the gradients
    match the plain path's; the backward counts one K2-wg and one K3-wg
    launch, and K3-wg takes no keep bits from keep_bits_plain."""
    q, k, v, valid = inputs(gen, 2, 2048, 2048, 2, 32, torch.bfloat16)
    assert dq_variant(2048, 2048, torch.bfloat16, 32) == "wg"
    assert dkv_variant(2048, 2048, torch.bfloat16, 32) == "wg"
    seed = 93 if rate else None
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    grads = {}
    before = (flash_attn_bwd_dq.launches_wg, flash_attn_bwd_dkv.launches_wg,
              flash_attn_bwd_dkv.bits_plain)
    for name, fn in (("kernel", FlashAttentionFn.apply),
                     ("plain", lambda *a: attention_plain(
                         *a[:4], dropout_rate=a[4], seed=a[5]))):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves, valid, rate, seed).backward(do)
        grads[name] = [x.grad for x in leaves]
    assert (flash_attn_bwd_dq.launches_wg - before[0],
            flash_attn_bwd_dkv.launches_wg - before[1],
            flash_attn_bwd_dkv.bits_plain - before[2]) == (1, 1, 0)
    scale = max(w.float().abs().max().item() for w in grads["plain"])
    for got, want in zip(grads["kernel"], grads["plain"]):
        rel_close(got, want, GRAD_TOL[torch.bfloat16], floor=scale)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_warpgroup_kernels_launch_from_a_thread_without_cuda_calls(
        gen, kernel):
    """Each warpgroup kernel launched as the first CUDA call of a new
    thread, as K2-wg is in autograd's device thread when it starts a
    backward: its tensor maps are encoded (they need a current context,
    which the launcher binds) and the result equals the main thread's
    bits."""
    import threading

    q, k, v, valid = inputs(gen, 2, 256, 256, 2, 32, torch.bfloat16)
    out, lse = _launch_fwd("tc", q, k, v, valid, 0.0, None)
    do = torch.randn(out.shape, device="cuda", generator=gen).to(q.dtype)
    args = (q, k, v, valid, out, lse, do, 0.0, None)
    di = di_plain(out, do)
    call = {"K1": lambda: _launch_fwd("wg", q, k, v, valid, 0.0, None)[0],
            "K2": lambda: _launch_dq("wg", *args),
            "K3": lambda: _launch_dkv("wg", *args, di)[0]}[kernel]
    got = {}

    def run():
        try:
            got["out"] = call()
            torch.cuda.synchronize()
        except Exception as err:  # reported below, in the test's thread
            got["error"] = err

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    assert chip_smoke.same_bits(got["out"], call())


RANK_CHILD = """
import json, sys
import torch
sys.path.insert(0, {repo!r})
from reftr_torch.cli.presets import preset_config
from reftr_torch.core import distributed
from reftr_torch.kernels.attention import (flash_attention,
                                           flash_attn_bwd_dkv,
                                           flash_attn_bwd_dq)
from reftr_torch.models.criterion import weight_dict
from reftr_torch.train.loop import (build_loaders, build_tokenizer,
                                    train_device)
from reftr_torch.train.state import TrainState
from reftr_torch.train.steps import make_train_step

dev = train_device("cuda")
assert distributed.initialize(dev)
cfg = preset_config("synthetic_smoke", dtype="bfloat16", batch_size=2,
                    synthetic_n=4, num_workers=1)
loader, _ = build_loaders(cfg, build_tokenizer(cfg), 1, 0)
batch, targets = next(iter(loader))
targets = {{k: targets[k] for k in ("boxes", "box_valid")}}
state = TrainState.create(cfg.model, cfg.train, 1, device=dev)
step = make_train_step(state.model, weight_dict(
    cfg.loss, cfg.model.dec_layers, cfg.model.aux_loss), cfg.loss,
    device=dev)
state, metrics = step(state, batch, targets)
torch.cuda.synchronize()
json.dump({{"device": str(dev), "current": torch.cuda.current_device(),
           "backend": torch.distributed.get_backend(),
           "world": distributed.world_size(),
           "loss": metrics.get()["loss"],
           "launches": [w.launches for w in (
               flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)]}},
          open({out!r}, "w"))
torch.distributed.destroy_process_group()
"""


def test_a_launched_rank_runs_the_kernels_on_its_local_card(gen, tmp_path):
    """One rank through the launcher (LOCAL_RANK 0): its device is
    cuda:LOCAL_RANK, made current before any CUDA call; the process
    group is NCCL's; one DDP bf16 train step of the smoke preset
    launches K1, K2 and K3 (on DDP's reducer thread too) with a finite
    loss."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "rank.json"
    script = tmp_path / "rank.py"
    script.write_text(RANK_CHILD.format(repo=repo, out=str(out)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    port = chip_smoke.free_port()
    proc = subprocess.run(
        [sys.executable, "-m", "reftr_torch.tools.launch",
         "--nproc_per_node", "1", "--coordinator_port", str(port), "--",
         sys.executable, str(script)], cwd=repo, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(out.read_text())
    assert got["device"] == "cuda:0" and got["current"] == 0
    assert (got["backend"], got["world"]) == ("nccl", 1)
    assert all(n > 0 for n in got["launches"]), got
    assert torch.isfinite(torch.tensor(got["loss"]))


def run_scratch_recipe(tmp_path, monkeypatch, s2d: bool):
    """tests/test_from_scratch.py's reduced recipe through run_training on
    the card, with its space-to-depth stem or without, float32, cuDNN's
    deterministic algorithms and no TF32: (result, losses, val accuracy
    by epoch, {checkpoint: (relpairdist, layer4 absmax)})."""
    import numpy as np

    from reftr_torch.convert import build_model
    from reftr_torch.core.checkpoint import load_checkpoint
    from reftr_torch.core.config import (BertConfig, DataConfig, ModelConfig,
                                         RefTRConfig, TrainConfig)
    from reftr_torch.train.loop import (build_loaders, build_tokenizer,
                                        run_training)

    # float32 as the JAX test computes it: no TF32 in cuDNN's convolutions,
    # and one trajectory: cuDNN's deterministic algorithms
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    out = str(tmp_path / "scratch")
    cfg = RefTRConfig(
        model=ModelConfig(
            enc_layers=3, dec_layers=3, hidden_dim=128, dim_feedforward=256,
            nheads=8, bert=BertConfig.tiny(), aux_loss=True, dtype="float32",
            backbone_norm="group", train_stem=True, normalize_before=True,
            space_to_depth_stem=s2d),
        data=DataConfig(
            dataset="synthetic", train_split="train", test_splits=("val",),
            img_size=64, max_img_size=64, max_query_len=12, batch_size=16,
            num_workers=2, synthetic_n=128, synthetic_box_frac=(0.25, 0.5)),
        train=TrainConfig(
            lr=3e-3, lr_backbone=3e-3, epochs=20,
            warm_up_epoch=2, clip_max_norm=1.0, lr_schedule="CosineWarmupLR",
            output_dir=out, seed=0))
    result = run_training(cfg)
    losses = [h["train_loss"] for h in result["history"]]
    accs = [h["test_val_accuracy_iou0.5"] for h in result["history"]]

    _, loaders = build_loaders(cfg, build_tokenizer(cfg))
    batch, _ = next(iter(loaders["val"]))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in batch.items()}
    probes = {}
    for name in ("checkpoint_best", "checkpoint"):
        model = build_model(cfg.model)
        model.load_state_dict(load_checkpoint(f"{out}/{name}",
                                              map_location="cuda")["model"])
        seen = {}
        hooks = [model.vl_transformer.encoder.register_forward_hook(
                     lambda m, i, o: seen.__setitem__("enc", o)),
                 model.img_backbone.register_forward_hook(
                     lambda m, i, o: seen.__setitem__("feat", o))]
        with torch.no_grad():
            model.eval()(batch)
        for h in hooks:
            h.remove()
        flat = seen["enc"].reshape(seen["enc"].shape[0], -1).float()
        d01 = (flat[0] - flat[1]).abs().mean()
        d23 = (flat[2] - flat[3]).abs().mean()
        within = flat.std(dim=1).mean()
        probes[name] = (float((d01 + d23) / (2 * within + 1e-9)),
                        float(seen["feat"].float().abs().max()))
    print(f"from-scratch recipe (reduced, "
          f"{'with' if s2d else 'no'} s2d stem), "
          f"{cfg.train.epochs} epochs: best_val_acc "
          f"{result['best_val_acc']:.4f} (JAX's bar 0.3), last train_loss "
          f"{losses[-1]:.4f} (JAX's bar 3.8); relpairdist at the best "
          f"checkpoint {probes['checkpoint_best'][0]:.4f} (JAX's bar 0.02); "
          f"losses {[round(v, 4) for v in losses]}; val accuracy {accs}; "
          f"(relpairdist, layer4 absmax) {probes}")
    return result, losses, accs, probes


def test_from_scratch_recipe_trains_healthy(gen, tmp_path, monkeypatch):
    """tests/test_from_scratch.py's reduced from-scratch recipe (:38-57:
    3+3 VL layers, d=128, 8 heads, bert tiny, 64 px, batch 16 of 128
    synthetic items, float32, GroupNorm, the stem trained, pre-norm, lr
    3e-3 with CosineWarmupLR over 20 epochs, clip 1.0, seed 0) without
    its space-to-depth stem (space_to_depth_stem), through run_training on
    the card. cuDNN runs its deterministic algorithms and no TF32, so the
    run is one trajectory, as the JAX test's on the CPU is (without them
    the convolutions' backward sums in no fixed order, and of five runs
    two left the language-only basin before their best epoch, two after
    it and one not at all). Asserted: every logged loss finite; on a val
    batch at the last epoch's checkpoint, the encoder's output carries
    the image: the pairwise distance of two images' outputs over their
    spread (:109) above 0.1, a healthy init's reading by the JAX test's
    note, where a run left in the basin reads 0.01-0.03 and the runs that
    left it 0.47-0.84; the backbone's output below 1e4 in magnitude at
    ``checkpoint_best`` and at the last (:111). Printed beside them, not
    asserted (ROADMAP.md queue 3): the distance at ``checkpoint_best``,
    which the JAX test holds above 0.02 (this trajectory's best epoch
    lies inside the basin), and the JAX test's bars for the capability
    (best accuracy 0.3, last loss 3.8, :78-79), calibrated with its stem
    on its trajectory; the JAX package's own reading without the stem is
    ``test_jax_recipe_without_its_stem`` in
    tests/test_torch_from_scratch.py; the recipe with its stem is
    ``test_from_scratch_recipe_with_its_stem``."""
    import math

    _, losses, _, probes = run_scratch_recipe(tmp_path, monkeypatch,
                                              s2d=False)
    assert all(math.isfinite(v) for v in losses), losses
    assert probes["checkpoint"][0] > 0.1, probes
    assert all(f < 1e4 for _, f in probes.values()), probes


def test_from_scratch_recipe_with_its_stem(gen, tmp_path, monkeypatch):
    """The same reduced recipe with its space-to-depth stem
    (--space_to_depth_stem, as tests/test_from_scratch.py:46 runs it; the
    GroupNorm backbone's stem conv1_s2d initialised as the standard
    stem's kernel folded, nn/fold.py): the same assertions as the recipe
    without the stem, and the JAX test's capability bars (best accuracy
    0.3, last loss 3.8, the distance at the best checkpoint 0.02) printed
    with their readings, not asserted: they were calibrated on the JAX
    package's trajectory (ROADMAP.md queue 3)."""
    import math

    result, losses, _, probes = run_scratch_recipe(tmp_path, monkeypatch,
                                                   s2d=True)
    assert all(math.isfinite(v) for v in losses), losses
    assert probes["checkpoint"][0] > 0.1, probes
    assert all(f < 1e4 for _, f in probes.values()), probes
    bars = {"best_val_acc >= 0.3": result["best_val_acc"] >= 0.3,
            "last loss < 3.8": losses[-1] < 3.8,
            "relpairdist at best > 0.02": probes["checkpoint_best"][0]
            > 0.02}
    print(f"from-scratch recipe with its stem against the JAX test's bars: "
          f"{bars}")


def test_http_server_serves_on_the_card(gen, monkeypatch):
    """tools/serve.build_server on the card at a tiny size (d=32, 2+2 VL
    layers, BERT-tiny, 64 px, float32, seeded init): a 200 round trip that
    launched K1, whose boxes equal the same rows run straight through the
    server's model within 1e-4 of the image's side (the same float32
    forward in another batch), and 400, 404 and 500 as the JAX server
    answers them. Images go as .npy bytes, as in chip_smoke.py phase 11
    (the card's machine has no PIL)."""
    import threading

    import numpy as np

    from reftr_torch.core.config import (BertConfig, DataConfig,
                                         ModelConfig, RefTRConfig)
    from reftr_torch.tools import serve as serve_tools
    from reftr_torch.train.loop import build_tokenizer

    monkeypatch.setattr(serve_tools, "decode_image", chip_smoke.npy_decode)
    cfg = RefTRConfig(
        model=ModelConfig(bert=BertConfig.tiny(), enc_layers=2, dec_layers=2,
                          dim_feedforward=64, hidden_dim=32, nheads=4),
        data=DataConfig(dataset="synthetic", img_size=64, max_img_size=64,
                        max_query_len=12))
    server, batcher = serve_tools.build_server(cfg, "127.0.0.1", 0, 4, 5.0)
    with torch.no_grad():  # at init the box head's last layer is zero
        batcher.model.model.bbox_embed.layers[-1].weight.normal_(
            0.0, 0.02, generator=gen)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
             ["the red box", "left"]),
            (rng.integers(0, 256, (80, 56, 3), dtype=np.uint8),
             ["green block on the right"])]
    try:
        before = flash_attention.launches
        answers = [chip_smoke.http_call(base + "/predict", {
            "image_b64": chip_smoke.npy_b64(img), "phrases": phrases})
            for img, phrases in reqs]
        assert flash_attention.launches > before
        img = chip_smoke.npy_b64(reqs[0][0])
        codes = [chip_smoke.http_call(base + "/predict",
                                      {"image_b64": img})[0],
                 chip_smoke.http_call(base + "/nowhere", method="GET")[0],
                 chip_smoke.http_call(base + "/predict", {
                     "image_b64": img,
                     "phrases": [f"p{i}" for i in range(5)]})[0]]
        assert codes == [400, 404, 500]
        fe = serve_tools.Frontend(cfg, build_tokenizer(cfg))
        want = chip_smoke.direct_boxes(batcher.model, fe, reqs)
        chip_smoke.check_answers("card http", reqs, answers, want, 1e-4)
    finally:
        server.shutdown()
        batcher.stop()
        server.server_close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_program_runs_the_kernels(gen, tmp_path, dtype):
    """A small RefTR exported on the card (tools/export_model.py) and
    loaded: its boxes against the live model's (1e-5 in float32, JAX's
    --selfcheck limit; 1e-3 in bf16), K1 launched once for each attention
    by the rule (torch.ops.reftr.flash_attention_fwd, one node each), K2
    and K3 never, and every call's outputs as the op's fake gives them."""
    import numpy as np

    from reftr_torch.core.config import (BertConfig, DataConfig, ModelConfig,
                                         RefTRConfig)
    from reftr_torch.tools import export_model

    cfg = RefTRConfig(
        model=ModelConfig(bert=BertConfig.tiny(), enc_layers=1, dec_layers=1,
                          dim_feedforward=64, hidden_dim=32, nheads=4,
                          aux_loss=False, dtype=dtype),
        data=DataConfig(img_size=64, max_img_size=64))
    model, _, manifest = export_model.export_with_config(
        cfg, "", str(tmp_path), 2, ("cuda",), print_fn=lambda *a: None)
    assert manifest["platforms"] == ["cuda"]
    call, _ = export_model.load_exported(str(tmp_path))
    spec = export_model.serving_batch_spec(cfg, 2)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in export_model.random_batch(spec).items()}
    dt = getattr(torch, dtype)
    sites = []
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.register_forward_pre_hook(
                lambda mod, args: sites.append(
                    (args[0].shape[1], args[1].shape[1],
                     args[0].shape[2] // mod.num_heads)))
    with torch.no_grad():
        want = model(batch)["pred_boxes"]
        chip_smoke.reset_counts([flash_attention, flash_attn_bwd_dq,
                                 flash_attn_bwd_dkv])
        got = call(batch)["pred_boxes"]
        torch.cuda.synchronize()
    variants = [fwd_variant(sq, sk, dt, d) for sq, sk, d in sites]
    assert flash_attention.launches == len(sites) > 0
    for v in ("tc", "tf32x3", "dec"):
        assert getattr(flash_attention, f"launches_{v}") == variants.count(v)
    assert flash_attention.launches_plain == 0
    assert flash_attn_bwd_dq.launches == flash_attn_bwd_dkv.launches == 0
    tol = 1e-5 if dtype == "float32" else 1e-3
    assert float((got - want).abs().max()) <= tol
    recorder = chip_smoke.op_call_recorder()
    with torch.no_grad(), recorder:
        call(batch)
    assert len(recorder.calls) == len(sites)
    chip_smoke.fake_check(recorder.calls)
    assert np.isfinite(got.cpu().numpy()).all()


@pytest.mark.parametrize("setting,kernels", [(None, True), (True, True),
                                             (False, False)],
                         ids=["auto", "on", "off"])
def test_use_pallas_attention_launches(gen, setting, kernels):
    """--use_pallas_attention on the card: auto and on launch K1 once for
    each attention of a small RefTR's forward and K2 and K3 once each in
    a training step's backward; off launches nothing (the plain version
    everywhere)."""
    import numpy as np

    from reftr_torch.convert import build_model
    from reftr_torch.core.config import BertConfig, ModelConfig

    cfg = ModelConfig(bert=BertConfig.tiny(), enc_layers=1, dec_layers=1,
                      dim_feedforward=64, hidden_dim=32, nheads=4,
                      aux_loss=False, use_pallas_attention=setting)
    model = build_model(cfg)
    n_attn = sum(isinstance(m, MultiHeadAttention) for m in model.modules())
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 256, (2, 64, 64, 3)).astype(np.uint8)).cuda(),
             "image_valid": torch.ones(2, 64, 64, dtype=torch.bool).cuda(),
             "sentence": torch.randint(1, 500, (2, 12)).cuda(),
             "sentence_valid": torch.ones(2, 12, dtype=torch.int32).cuda()}
    wrappers = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    chip_smoke.reset_counts(wrappers)
    model.train()
    with attention_rng(torch.Generator().manual_seed(0)):
        out = model(batch)
    out["pred_boxes"].float().sum().backward()
    torch.cuda.synchronize()
    got = chip_smoke.read_counts(wrappers)
    want = n_attn if kernels else 0
    assert (got["flash_attention"], got["flash_attn_bwd_dq"],
            got["flash_attn_bwd_dkv"]) == (want, want, want), got


# int8 (kernels/quant.py): the quantize pass and the int8 implicit-GEMM
# convolution, bit for bit against their plain versions
INT8_QUANTIZE_SHAPES = [(8, 20, 20, 64), (3, 7, 11, 5), (1000, 768), (13,),
                        (2, 40, 768)]
# (N, H, W, Cin, Cout, k, stride, dilation): the backbone's kinds, the
# ragged edges of "tc"'s 128 x 128 output tile, a dense (1x1 over M rows);
# then the edges of "wg"'s tiles: Cout = 64 over an M not a multiple of
# 128, Cin = 64 (the 64-byte K tile) 3x3 at stride 2 and at dilation 2,
# Cin = 128 and 2048 (the 128-byte K tile), the VL encoder's FFN dense at
# a ragged M; Cout = 2, 10 and 130 take only "tc"
INT8_CONVS = [(2, 20, 20, 64, 64, 1, 1, 1), (2, 20, 20, 64, 64, 3, 1, 1),
              (2, 21, 19, 128, 128, 3, 2, 1), (2, 20, 20, 512, 512, 3, 1, 2),
              (2, 21, 21, 256, 512, 1, 2, 1), (3, 9, 13, 64, 10, 3, 2, 1),
              (1, 1, 1, 64, 2, 1, 1, 1), (129, 1, 1, 256, 130, 1, 1, 1),
              (8, 1, 1, 2048, 256, 1, 1, 1), (3, 13, 11, 64, 64, 1, 1, 1),
              (3, 13, 11, 64, 64, 3, 1, 1), (2, 17, 15, 64, 128, 3, 2, 1),
              (2, 11, 13, 64, 64, 3, 1, 2), (2, 9, 7, 128, 64, 3, 1, 1),
              (1, 6, 6, 2048, 64, 3, 1, 1), (2, 10, 10, 2048, 256, 1, 1, 1),
              (333, 1, 1, 256, 2048, 1, 1, 1)]


def int8_variants(conv, dtype) -> list:
    """Every (variant, tile) the route can pick for a shape: "tc" where it
    takes the shape (an even Cout), "wg" at each tile width where it takes
    it."""
    from reftr_torch.kernels import quant

    out = [("tc", None)] if conv[4] % 2 == 0 else []
    if quant.int8_conv_variant(*conv, dtype) == "wg":
        out += [("wg", bn) for bn in quant.WG_TILES]
    return out


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INT8_QUANTIZE_SHAPES)
def test_int8_quantize_kernel_matches_plain(gen, shape, dtype, aligned):
    """Bit for bit, by 8-element vectors where aligned and element by
    element from an offset of one."""
    from reftr_torch.kernels import quant

    n = 1
    for s in shape:
        n *= s
    x = (torch.randn(n + 1, device="cuda", generator=gen) * 3).to(dtype)
    x = x[:n].view(shape) if aligned else x[1:].view(shape)
    scale = torch.tensor(0.0213, device="cuda")
    before = quant.quantize_int8.launches
    got = quant.quantize_int8(x, scale)
    assert quant.quantize_int8.launches == before + 1
    assert torch.equal(got, quant.quantize_plain(x, scale))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", INT8_CONVS)
def test_int8_conv_kernel_matches_plain(gen, conv, dtype, bias):
    """Bit for bit: exact int32 sums on the int8 tensor cores, the float32
    epilogue rounded as the plain version rounds it; through the wrapper
    (the variant the route picks, one launch on its counter) and through
    every variant and tile the route can pick for the shape, forced."""
    from reftr_torch.kernels import quant

    n, h, w, c, cout, k, s, d = conv
    x = torch.randint(-127, 128, (n, h, w, c), dtype=torch.int8,
                      device="cuda", generator=gen)
    wq = torch.randint(-127, 128, (cout, k * k * c), dtype=torch.int8,
                       device="cuda", generator=gen)
    ws = torch.rand(cout, device="cuda", generator=gen) * 0.01
    scale = torch.tensor(0.05, device="cuda")
    b = (torch.randn(cout, device="cuda", generator=gen) if bias else None)
    variant = quant.int8_conv_variant(*conv, dtype)
    c = quant.int8_conv
    before = (c.launches, c.launches_wg, c.launches_tc)
    got = quant.int8_conv(x, wq, ws, scale, b, k, s, d, dtype)
    assert (c.launches, c.launches_wg, c.launches_tc) == (
        before[0] + 1, before[1] + (variant == "wg"),
        before[2] + (variant == "tc"))
    want = quant.int8_conv_plain(x, wq, ws, scale, b, k, s, d, dtype)
    assert torch.equal(got, want)
    for name, bn in int8_variants(conv, dtype):
        forced = quant._launch_conv(name, x, wq, ws, scale, b, k, s, d,
                                    dtype, bn=bn)
        assert torch.equal(forced, want), (name, bn)
    assert torch.equal(quant.int8_conv(x, wq, ws, scale, b, k, s, d, dtype),
                       got)


def test_int8_conv_kernel_refuses_what_it_does_not_take(gen):
    from reftr_torch.kernels import quant

    x = torch.zeros(1, 4, 4, 32, dtype=torch.int8, device="cuda")
    w = torch.zeros(8, 32, dtype=torch.int8, device="cuda")
    ones, scale = torch.ones(8, device="cuda"), torch.ones((), device="cuda")
    with pytest.raises(ValueError, match="Cin a multiple of 64"):
        quant.int8_conv(x, w, ones, scale)
    x = torch.zeros(1, 4, 4, 64, dtype=torch.int8, device="cuda")
    w = torch.zeros(7, 64, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="even Cout"):
        quant.int8_conv(x, w, torch.ones(7, device="cuda"), scale)
    w = torch.zeros(10, 64, dtype=torch.int8, device="cuda")
    ten = torch.ones(10, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        quant._launch_conv("wg", x, w, ten, scale, None, 1, 1, 1,
                           torch.bfloat16)
    w = torch.zeros(64, 64, dtype=torch.int8, device="cuda")
    ones = torch.ones(64, device="cuda")
    with pytest.raises(ValueError, match="tiles of 256 columns"):
        quant._launch_conv("wg", x, w, ones, scale, None, 1, 1, 1,
                           torch.float32, bn=256)
    with pytest.raises(ValueError, match="no int8 conv kernel"):
        quant._launch_conv("mma", x, w, ones, scale, None, 1, 1, 1,
                           torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_serving_and_export_launch_the_int8_kernels(gen, tmp_path,
                                                        dtype):
    """A small folded RefTR at every int8 scope on the card: calibrated and
    served, one quantize and one int8 conv launch for each product and K1
    for each attention; exported, its program launches the same and gives
    the live model's boxes (1e-5 in float32, 1e-3 in bf16, as the fp
    export); finite boxes."""
    import numpy as np

    from reftr_torch.core.config import (BertConfig, DataConfig, ModelConfig,
                                         RefTRConfig)
    from reftr_torch.kernels import quant
    from reftr_torch.nn.quant import QUANT_MODULES
    from reftr_torch.tools import export_model

    cfg = RefTRConfig(
        model=ModelConfig(bert=BertConfig.tiny(), enc_layers=1, dec_layers=1,
                          dim_feedforward=128, hidden_dim=64, nheads=4,
                          aux_loss=False, dtype=dtype, fold_bn=True,
                          quantize_int8=True),
        data=DataConfig(img_size=64, max_img_size=64))
    spec = export_model.serving_batch_spec(cfg, 2)
    calib = [(export_model.random_batch(spec, seed=i), None)
             for i in range(2)]
    model, _, manifest = export_model.export_with_config(
        cfg, "", str(tmp_path), 2, ("cuda",), calib_batches=calib,
        print_fn=lambda *a: None)
    assert manifest["model"]["quantize_int8"] is True
    n_products = sum(isinstance(m, QUANT_MODULES) for m in model.modules())
    assert n_products == 52 + 12 + 6 + 10
    call, _ = export_model.load_exported(str(tmp_path))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in export_model.random_batch(spec, seed=7).items()}
    counters = [flash_attention, quant.quantize_int8, quant.int8_conv]
    outs = {}
    for label, fn in (("live", model), ("exported", call)):
        for c in counters:
            c.launches = 0
        with torch.no_grad():
            outs[label] = fn(batch)["pred_boxes"]
            torch.cuda.synchronize()
        assert quant.quantize_int8.launches == n_products
        assert quant.int8_conv.launches == n_products
        assert flash_attention.launches == 2 + 1 + 2
    tol = 1e-5 if dtype == "float32" else 1e-3
    assert float((outs["live"] - outs["exported"]).abs().max()) <= tol
    assert np.isfinite(outs["live"].float().cpu().numpy()).all()


# the mxu_bf16 mode (float32 in and out, bf16 products) against its plain
# versions: chip_smoke.MXU_TOL through chip_smoke.mxu_errors, whose
# comment gives its reasons (the plain forward rounds p against the
# kernel's running max; the control, the float32 kernels without the
# mode, must fail the mean checks)
# (Sq, Sk): the "tc" kernels at their 64-row and 64-key tile edges and K3
# below 16 keys; the decode kernels below 16 queries
MXU_SHAPES = [(16, 1), (63, 15), (65, 63), (64, 440), (1, 1), (5, 65),
              (15, 440)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", HEAD_DIMS + (24, 48))
@pytest.mark.parametrize("sq,sk", MXU_SHAPES)
def test_mxu_kernels_match_plain(gen, sq, sk, d, rate):
    """K1, K2 and K3 in the mxu_bf16 mode through the rule ("tc" from 16
    queries, "dec" below, a head dim between the instances padded), batch
    row 0 with every key masked, against attention_plain and
    attention_bwd_plain with mxu_bf16 on the same float32 inputs
    (chip_smoke.mxu_plain), the backward on the kernel's O and lse, within
    chip_smoke.MXU_TOL, and the control outside its mean checks; float32
    outputs; counted in launches_mxu."""
    q, k, v, valid = inputs(gen, 2, sq, sk, 3, d, torch.float32)
    seed = 0x5EED if rate else None
    counters = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    before = [c.launches_mxu for c in counters]
    out, lse = flash_attention(q, k, v, valid, True, dropout_rate=rate,
                               seed=seed, mxu_bf16=True)
    do = torch.randn(out.shape, device="cuda", generator=gen)
    args = (q, k, v, valid, out, lse, do, rate, seed)
    dq = flash_attn_bwd_dq(*args, mxu_bf16=True)
    dk, dv = flash_attn_bwd_dkv(*args, mxu_bf16=True)
    torch.cuda.synchronize()
    bwd = 2 if sq < 16 else 1  # the decode backward counts on K2 and K3
    assert [c.launches_mxu - b for c, b in zip(counters, before)] == [
        1, bwd, bwd]
    (want, want_lse), wants = chip_smoke.mxu_plain(
        *args, fwd_variant(sq, sk, torch.float32, d, True))
    for got, w in zip((out, dq, dk, dv), (want, *wants)):
        assert got.dtype == torch.float32 and got.shape == w.shape
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)
    errs = chip_smoke.mxu_errors((out, dq, dk, dv), (want, *wants))
    assert chip_smoke.mxu_failures(errs) == [], errs
    control = chip_smoke.mxu_errors(chip_smoke.mxu_control(*args),
                                    (want, *wants))
    assert chip_smoke.mxu_control_caught(
        chip_smoke.mxu_failures(control)), control


def test_mxu_mode_changes_nothing_for_bf16(gen):
    """A bf16 call ignores the mode: the same variants, the same bits,
    nothing counted in launches_mxu."""
    q, k, v, valid = inputs(gen, 2, 440, 440, 8, 32, torch.bfloat16)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    grads = []
    before = flash_attention.launches_mxu
    for mxu in (False, True):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = flash_attention(*leaves, valid, dropout_rate=0.1, seed=9,
                              mxu_bf16=mxu)
        out.backward(do)
        grads.append([out.detach()] + [x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert flash_attention.launches_mxu == before


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mxu_function_backward_is_the_wrappers(gen, rate):
    """FlashAttentionFn in the mode: its forward is K1's call in the mode
    and its backward K2's and K3's (on "tc"), bit for bit."""
    q, k, v, valid = inputs(gen, 4, 97, 97, 8, 32, torch.float32)
    seed = 78 if rate else None
    do = torch.randn(q.shape, device="cuda", generator=gen)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, valid, dropout_rate=rate, seed=seed,
                          mxu_bf16=True)
    out.backward(do)
    with torch.no_grad():
        want, lse = flash_attention(q, k, v, valid, True, dropout_rate=rate,
                                    seed=seed, mxu_bf16=True)
        args = (q, k, v, valid, want, lse, do, rate, seed)
        wants = (flash_attn_bwd_dq(*args, mxu_bf16=True),
                 *flash_attn_bwd_dkv(*args, mxu_bf16=True))
    assert torch.equal(out.detach(), want)
    for leaf, w in zip(leaves, wants):
        assert torch.equal(leaf.grad, w)
