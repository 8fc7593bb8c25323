"""reftr_torch transformer, VL transformer, query encoder and small heads
against reftr_tpu (float32, CPU).

Tolerance: atol 1e-5 per module (LayerNorm and matmul sums run in another
order in XLA and in PyTorch's CPU kernels).
"""

import numpy as np
import pytest
import torch

from reftr_tpu.models.vl_transformer import VLTransformer as JaxVLTransformer
from reftr_tpu.nn.mlp import MLP as JaxMLP
from reftr_tpu.nn.mlp import MLPMapping as JaxMLPMapping
from reftr_tpu.nn.posembed import ImagePositionEmbedding as JaxPosEmbed
from reftr_tpu.nn.query_encoder import QueryEncoder as JaxQueryEncoder
from reftr_tpu.nn.transformer import TransformerDecoder as JaxDecoder
from reftr_tpu.nn.transformer import TransformerEncoder as JaxEncoder
from reftr_torch.models.vl_transformer import VLTransformer
from reftr_torch.nn.mlp import MLP, MLPMapping
from reftr_torch.nn.posembed import ImagePositionEmbedding
from reftr_torch.nn.query_encoder import QueryEncoder
from reftr_torch.nn.transformer import TransformerDecoder, TransformerEncoder
from torch_parity_utils import close, load_port, random_flax_params, t

ATOL = 1e-5
D, H, FF = 32, 4, 48


def ragged_valid(rng, b, s):
    valid = np.arange(s)[None, :] < rng.integers(1, s + 1, b)[:, None]
    valid[0] = True  # one full row
    return valid


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_matches_jax(normalize_before, activation):
    rng = np.random.default_rng(0)
    b, s = 3, 13
    src = rng.normal(size=(b, s, D)).astype(np.float32)
    pos = rng.normal(size=(b, s, D)).astype(np.float32)
    valid = ragged_valid(rng, b, s)
    jenc = JaxEncoder(2, D, H, FF, dropout=0.0, activation=activation,
                      normalize_before=normalize_before, use_pallas=False)
    params = random_flax_params(jenc, src, pos, valid)
    want = jenc.apply({"params": params}, src, pos, valid)
    port = load_port(TransformerEncoder(2, D, H, FF, activation,
                                        normalize_before), params)
    with torch.no_grad():
        got = port(t(src), t(pos), t(valid))
    close(got, want, ATOL)


@pytest.mark.parametrize("normalize_before,intermediate",
                         [(False, True), (True, True), (False, False)])
def test_decoder_matches_jax(normalize_before, intermediate):
    rng = np.random.default_rng(1)
    b, nq, s = 3, 2, 17
    tgt = rng.normal(size=(b, nq, D)).astype(np.float32)
    query_pos = rng.normal(size=(b, nq, D)).astype(np.float32)
    memory = rng.normal(size=(b, s, D)).astype(np.float32)
    pos = rng.normal(size=(b, s, D)).astype(np.float32)
    mem_valid = ragged_valid(rng, b, s)
    tgt_valid = np.ones((b, nq), bool)
    args = (tgt, memory, tgt_valid, mem_valid, pos, query_pos)
    jdec = JaxDecoder(3, D, H, FF, dropout=0.0,
                      normalize_before=normalize_before,
                      return_intermediate=intermediate, use_pallas=False)
    params = random_flax_params(jdec, *args)
    want = jdec.apply({"params": params}, *args)
    port = load_port(TransformerDecoder(3, D, H, FF, "relu", normalize_before,
                                        intermediate), params)
    with torch.no_grad():
        got = port(*(t(a) for a in args))
    assert tuple(got.shape) == want.shape == ((3 if intermediate else 1),
                                              b, nq, D)
    close(got, want, ATOL)


def test_vl_transformer_encode_decode_match_jax():
    rng = np.random.default_rng(2)
    b, hh, ww, s, nq = 2, 3, 4, 9, 1
    img = rng.normal(size=(b, hh, ww, D)).astype(np.float32)
    img_valid = np.ones((b, hh, ww), bool)
    img_valid[1, :, 3:] = False
    img_pos = rng.normal(size=(b, hh, ww, D)).astype(np.float32)
    lang = rng.normal(size=(b, s, D)).astype(np.float32)
    lang_valid = ragged_valid(rng, b, s)
    query = rng.normal(size=(b, nq, D)).astype(np.float32)
    query_pos = rng.normal(size=(b, nq, D)).astype(np.float32)
    query_valid = np.ones((b, nq), bool)
    jvl = JaxVLTransformer(d_model=D, nhead=H, num_encoder_layers=2,
                           num_decoder_layers=2, dim_feedforward=FF,
                           dropout=0.0, max_lang_seq=16, use_pallas=False)
    args = ([img], [img_valid], [img_pos], lang, lang_valid, query,
            query_pos, query_valid)
    params = random_flax_params(jvl, *args)
    memory, mem_valid, mem_pos = jvl.apply(
        {"params": params}, *args[:5], method=jvl.encode)
    hs = jvl.apply({"params": params}, query, query_pos, query_valid, memory,
                   mem_valid, mem_pos, method=jvl.decode)
    port = load_port(VLTransformer(D, H, 2, 2, FF, max_lang_seq=16), params)
    with torch.no_grad():
        p_mem, p_valid, p_pos = port.encode([t(img)], [t(img_valid)],
                                            [t(img_pos)], t(lang),
                                            t(lang_valid))
        p_hs = port.decode(t(query), t(query_pos), t(query_valid), p_mem,
                           p_valid, p_pos)
    np.testing.assert_array_equal(p_valid.numpy(), np.asarray(mem_valid))
    close(p_pos, mem_pos, ATOL)
    close(p_mem, memory, ATOL)
    close(p_hs, hs, ATOL)


@pytest.mark.parametrize("n_q", [1, 3])
def test_query_encoder_matches_jax(n_q):
    rng = np.random.default_rng(3)
    b, s, n_ph = 3, 11, 1
    context = rng.normal(size=(b, s, D)).astype(np.float32)
    phrase = rng.normal(size=(b, n_ph, D)).astype(np.float32)
    lens = np.array([11, 6, 3])
    t_ = np.arange(s)[None, :]
    ctx_valid = ((t_ < lens[:, None]) & (t_ != 0)
                 & (t_ != (lens - 1)[:, None]))[:, None, :]
    jqe = JaxQueryEncoder(n_q, D, dropout=0.0)
    params = random_flax_params(jqe, context, phrase, ctx_valid)
    want_q, want_pos = jqe.apply({"params": params}, context, phrase,
                                 ctx_valid)
    port = load_port(QueryEncoder(n_q, D), params)
    with torch.no_grad():
        got_q, got_pos = port(t(context), t(phrase), t(ctx_valid))
    close(got_q, want_q, ATOL)
    close(got_pos, want_pos, ATOL)


def test_mlp_heads_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, D)).astype(np.float32)
    jmlp = JaxMLP(D, 4, 3)
    params = random_flax_params(jmlp, x)
    close(load_port(MLP(D, D, 4, 3), params)(t(x)),
          jmlp.apply({"params": params}, x), ATOL)
    wide = rng.normal(size=(2, 5, 2 * D)).astype(np.float32)
    jmap = JaxMLPMapping(D, dropout=0.0)
    params = random_flax_params(jmap, wide)
    close(load_port(MLPMapping(2 * D, D), params)(t(wide)),
          jmap.apply({"params": params}, wide), ATOL)


@pytest.mark.parametrize("kind", ["sine", "learned"])
def test_position_embedding_matches_jax(kind):
    valid = np.ones((2, 6, 7), bool)
    valid[1, 4:] = False
    valid[1, :, 5:] = False
    jpe = JaxPosEmbed(D, kind)
    params = random_flax_params(jpe, valid) if kind == "learned" else {}
    want = jpe.apply({"params": params}, valid)
    port = ImagePositionEmbedding(D, kind)
    if kind == "learned":
        port = load_port(port, params)
    close(port(t(valid)), want, ATOL)
