"""reftr_torch attention: the kernel wrapper's plain version and the port's
MultiHeadAttention against reftr_tpu (float32, CPU).

Tolerance: atol 1e-5 (f32; the einsum and softmax sum in another order).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from reftr_tpu.kernels.attention import _xla_attention, fused_attention
from reftr_tpu.nn.attention import MultiHeadAttention as JaxMHA
from reftr_torch.kernels.attention import (_ARGTYPES, HEAD_DIMS,
                                           MAX_HEAD_DIM, TC_MIN_ROWS, WG_MIN,
                                           _launch_dkv, _launch_dq,
                                           _launch_fwd,
                                           attention_bwd_plain,
                                           attention_plain, dkv_variant,
                                           dq_variant, flash_attention,
                                           flash_attn_bwd_dkv,
                                           flash_attn_bwd_dq, fwd_variant,
                                           padded_head_dim)
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


# (Sq, Sk, head dim) of refcoco_det's four attention call sites at 640 px
CALL_SITES = {"vl_encoder_self": (440, 440, 32), "decoder_self": (1, 1, 32),
              "decoder_cross": (1, 440, 32), "bert_self": (40, 40, 64)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", sorted(CALL_SITES))
def test_variant_rule_at_the_call_sites(site, dtype):
    """bf16 BERT and encoder calls on the tensor cores, K2 and K3 at the
    encoder on their warpgroup kernels; float32 ones on the 3xTF32
    tensor-core kernels (K1, K2 and K3); the decoder's single query on the
    decode kernels (K1's, and the one backward kernel for K2 and K3) in
    either dtype."""
    sq, sk, d = CALL_SITES[site]
    dec = site.startswith("decoder")
    bf16 = dtype == torch.bfloat16
    want = "dec" if dec else "tc" if bf16 else "tf32x3"
    assert fwd_variant(sq, sk, dtype, d) == want
    wg = bf16 and site == "vl_encoder_self"
    assert dq_variant(sq, sk, dtype, d) == ("wg" if wg else want)
    assert dkv_variant(sq, sk, dtype, d) == ("wg" if wg else want)


def test_variant_rule_boundary():
    bf16, f32 = torch.bfloat16, torch.float32
    assert TC_MIN_ROWS == 16
    assert fwd_variant(15, 15, bf16, 32) == "dec"
    assert fwd_variant(16, 16, bf16, 32) == "tc"
    assert fwd_variant(16, 16, f32, 32) == "tf32x3"
    assert fwd_variant(15, 15, f32, 32) == "dec"
    assert fwd_variant(8540, 8540, f32, 32) == "tf32x3"
    # bf16 K1, K2 and K3 on the warpgroup kernels from WG_MIN queries and
    # keys at a head dim padding to 32, at any key count
    assert fwd_variant(2040, 2040, bf16, 32) == "wg"
    assert fwd_variant(2039, 2040, bf16, 32) == "tc"
    assert fwd_variant(2040, 2039, bf16, 32) == "tc"
    assert fwd_variant(2090, 2090, bf16, 32) == "wg"
    assert fwd_variant(2092, 2092, bf16, 32) == "wg"
    assert fwd_variant(8540, 8540, bf16, 24) == "wg"
    assert fwd_variant(8540, 8540, bf16, 64) == "tc"
    assert dkv_variant(256, 256, bf16, 32) == "wg"
    assert dkv_variant(255, 256, bf16, 32) == "tc"
    assert dkv_variant(256, 255, bf16, 32) == "tc"
    assert dkv_variant(490, 490, bf16, 32) == "wg"
    assert dkv_variant(2090, 2090, bf16, 32) == "wg"
    assert dkv_variant(2040, 2040, bf16, 32) == "wg"
    assert dkv_variant(440, 440, bf16, 16) == "tc"
    # K2 on its warpgroup kernel from WG_MIN["dq"], K3's least, at any key
    # count: K3-wg reads the keep bits K2-wg writes
    assert WG_MIN["dq"] == WG_MIN["dkv"]
    assert dq_variant(8540, 8540, bf16, 32) == "wg"
    assert dq_variant(2090, 2090, bf16, 32) == "wg"
    assert dq_variant(490, 490, bf16, 32) == "wg"
    assert dq_variant(256, 256, bf16, 32) == "wg"
    assert dq_variant(255, 256, bf16, 32) == "tc"
    assert dq_variant(256, 255, bf16, 32) == "tc"
    assert dq_variant(440, 440, bf16, 32) == "wg"
    assert dq_variant(8540, 8540, bf16, 64) == "tc"
    assert dq_variant(8540, 8540, f32, 32) == "tf32x3"
    assert dkv_variant(16, 16, bf16, 32) == "tc"
    assert dkv_variant(15, 440, bf16, 32) == "dec"
    assert dkv_variant(15, 15, f32, 32) == "dec"
    assert dkv_variant(440, 15, bf16, 32) == "tc"
    assert dkv_variant(440, 440, f32, 32) == "tf32x3"
    assert MAX_HEAD_DIM == 128
    assert fwd_variant(440, 440, f32, 128) == "tf32x3"
    assert fwd_variant(440, 440, f32, 129) == "plain"


@pytest.mark.parametrize("sq,dtype,fwd,dq", [
    (1, torch.float32, "dec", "dec"), (15, torch.float32, "dec", "dec"),
    (16, torch.float32, "tf32x3", "tf32x3"),
    (8540, torch.float32, "tf32x3", "tf32x3"),
    (1, torch.bfloat16, "dec", "dec"),
    (15, torch.bfloat16, "dec", "dec"), (16, torch.bfloat16, "tc", "tc"),
    (8540, torch.bfloat16, "tc", "tc")])
def test_dec_and_dq_variant_rules(sq, dtype, fwd, dq):
    """K1 and K2 take their decode kernels below TC_MIN_ROWS queries in
    either dtype; both take the tensor cores from TC_MIN_ROWS queries, K2
    whatever Sk and K1 at BERT's 40 keys, below the warpgroup kernel's
    least (test_variant_rule_boundary): bf16 products in bf16, float32
    ones by 3xTF32."""
    assert fwd_variant(sq, 40, dtype, 32) == fwd
    assert dq_variant(sq, 40, dtype, 32) == dq


@pytest.mark.parametrize("sq,sk,dtype,want", [
    (15, 440, torch.bfloat16, "dec"), (16, 440, torch.bfloat16, "tc"),
    (15, 1, torch.float32, "dec"), (16, 1, torch.float32, "tf32x3"),
    (15, 15, torch.bfloat16, "dec"), (16, 15, torch.bfloat16, "tc"),
    (16, 16, torch.bfloat16, "tc"), (16, 16, torch.float32, "tf32x3"),
    (16, 15, torch.float32, "tf32x3")])
def test_dkv_variant_rule(sq, sk, dtype, want):
    """K3 takes the decode backward below TC_MIN_ROWS queries whatever Sk
    and dtype, and the tensor cores from TC_MIN_ROWS queries at any key
    count, down to one (bf16 in bf16, float32 by 3xTF32); below
    TC_MIN_ROWS queries K2 and K3 agree, as one kernel computes both."""
    assert dkv_variant(sq, sk, dtype, 32) == want
    if sq < TC_MIN_ROWS:
        assert dq_variant(sq, sk, dtype, 32) == want


def _rule(kernel, sq, sk, dtype, d):
    """The dispatch rule written out as a table, apart from the code."""
    if d > 128:
        return "plain"
    if sq < 16:
        return "dec"
    bf16 = dtype == torch.bfloat16
    least = {"fwd": 2048, "dq": 256, "dkv": 256}.get(kernel)
    if bf16 and least and 16 < d <= 32 and min(sq, sk) >= least:
        return "wg"
    return "tc" if bf16 else "tf32x3"


@pytest.mark.parametrize("d", [8, 48, 128, 160])
@pytest.mark.parametrize("sk", [1, 15, 16, 440])
@pytest.mark.parametrize("sq", [1, 15, 16, 440])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variant_rule_at_every_corner(dtype, sq, sk, d):
    """Every (dtype, Sq, Sk, D) corner of the rule: the edges of
    TC_MIN_ROWS on both sides, a head dim that pads, the largest instance
    and one above it."""
    assert fwd_variant(sq, sk, dtype, d) == _rule("fwd", sq, sk, dtype, d)
    assert dq_variant(sq, sk, dtype, d) == _rule("dq", sq, sk, dtype, d)
    assert dkv_variant(sq, sk, dtype, d) == _rule("dkv", sq, sk, dtype, d)


@pytest.mark.parametrize("d,want", [(1, 16), (8, 16), (16, 16), (17, 32),
                                    (24, 32), (33, 64), (48, 64), (64, 64),
                                    (96, 128), (128, 128)])
def test_head_dims_pad_to_the_next_instance(d, want):
    assert padded_head_dim(d) == want and want in HEAD_DIMS


@pytest.mark.parametrize("d", [8, 24, 48, 96, 160])
def test_zero_padding_keeps_attention_and_its_gradients(d):
    """What the launchers rely on: q, k, v and dO zero-padded on the head
    dim (to the next instance, or to 256 above the last), with the true
    scale 1 / sqrt(D), give the unpadded output, lse and gradients within
    1e-6, and zero in the padded columns."""
    dp = padded_head_dim(d) if d <= MAX_HEAD_DIM else 256
    rng = np.random.default_rng(d)
    q, k, v, valid = make_qkv(d, 2, 21, 37, 2, d, all_masked_row=True)
    do = rng.normal(size=q.shape).astype(np.float32)
    q, k, v, valid, do = (t(x) for x in (q, k, v, valid, do))
    pad = lambda x: torch.nn.functional.pad(x, (0, dp - d))  # noqa: E731
    scale = 1.0 / np.sqrt(d)
    out, lse = attention_plain(q, k, v, valid, True)
    got, got_lse = attention_plain(pad(q), pad(k), pad(v), valid, True,
                                   scale=scale)
    close(got[..., :d], out.numpy(), 1e-6)
    close(got_lse, lse.numpy(), 1e-6)
    assert not got[..., d:].any()
    rate, seed = 0.2, 31
    out, lse = attention_plain(q, k, v, valid, True, dropout_rate=rate,
                               seed=seed)
    want = attention_bwd_plain(q, k, v, valid, out, lse, do, rate, seed)
    grads = attention_bwd_plain(pad(q), pad(k), pad(v), valid, pad(out), lse,
                                pad(do), rate, seed, scale=scale)
    for g, w in zip(grads, want):
        close(g[..., :d], w.numpy(), 1e-6)
        assert not g[..., d:].any()


@pytest.mark.parametrize("d", [8, 24, 160])
def test_cpu_path_takes_any_head_dim(d):
    """On the CPU every head dim runs the plain versions, forward and
    backward, against JAX's XLA attention."""
    q, k, v, valid = make_qkv(9, 2, 6, 11, 2, d)
    close(flash_attention(t(q), t(k), t(v), t(valid)),
          xla_reference(q, k, v, valid), ATOL)


CSRC = Path(__file__).resolve().parents[1] / "reftr_torch/kernels/csrc"


def _chip_smoke_kernels() -> dict:
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_kernels", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.KERNELS


@pytest.mark.parametrize("name", sorted(_ARGTYPES))
def test_ctypes_signatures_match_the_sources(name):
    """Each entry point's ctypes arguments against its extern "C"
    definition in the named source: one parameter more (the stream, which
    the wrapper appends), so a signature that drifts fails without a card.
    chip_smoke.py lists every entry point with the same source."""
    source, argtypes = _ARGTYPES[name]
    text = (CSRC / source).read_text()
    found = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    assert found, f"no extern \"C\" {name} in {source}"
    params = [p for p in found.group(1).split(",") if p.strip()]
    assert len(params) == len(argtypes) + 1
    assert params[-1].split() == ["void*", "stream"]
    assert _chip_smoke_kernels()[name][0] == source


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", [1, 16, 64])
def test_cpu_tensors_take_the_plain_version_whatever_the_variant(sq, dtype):
    """CPU tensors at shapes the rule sends to the decode kernel (one
    query) and to the tensor-core kernels (bf16, and 3xTF32 in float32):
    the plain versions run, forward and backward, and no launch counter
    moves."""
    q, k, v, valid = (t(a) for a in make_qkv(8, 2, sq, 20, 2, 32))
    q, k, v = (x.to(dtype).requires_grad_() for x in (q, k, v))
    counters = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    assert fwd_variant(sq, 20, dtype, 32) == ("dec" if sq == 1 else "tf32x3"
                                              if dtype == torch.float32
                                              else "tc")

    def counts():
        return [(c.launches, c.launches_tc, c.launches_tf32x3,
                 c.launches_dec) for c in counters]

    before = counts()
    out = flash_attention(q, k, v, valid)
    do = torch.ones_like(out)
    grads = torch.autograd.grad(out, (q, k, v), do)
    with torch.no_grad():
        want, lse = attention_plain(q, k, v, valid, return_lse=True)
        want_grads = attention_bwd_plain(q, k, v, valid, want, lse, do)
    assert torch.equal(out, want)
    for g, w in zip(grads, want_grads):
        assert torch.equal(g, w)
    assert counts() == before


@pytest.mark.parametrize("launch,variant", [
    (_launch_fwd, "dec"), (_launch_fwd, "tc"), (_launch_fwd, "tf32x3"),
    (_launch_dq, "tc"), (_launch_dq, "tf32x3"),
    (_launch_dq, "dec"), (_launch_dkv, "tc"),
    (_launch_dkv, "tf32x3"), (_launch_dkv, "dec"), (_launch_fwd, "wg"),
    (_launch_dkv, "wg")])
def test_launchers_refuse_cpu_tensors(launch, variant):
    """Each launcher, called with CPU tensors for any of its kernel
    variants, raises before it pads, allocates or launches, and no launch
    counter moves: only the wrappers send CPU tensors to the plain
    versions."""
    sq = 1 if variant == "dec" else 16
    q, k, v, valid = (t(a) for a in make_qkv(10, 2, sq, 20, 2, 32))
    if variant in ("tc", "wg"):
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    args = (q, k, v, valid)
    if launch is not _launch_fwd:
        out, lse = attention_plain(q, k, v, valid, True)
        args += (out, lse, out)
    counters = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch(variant, *args, 0.0, None)
    assert [c.launches for c in counters] == before
