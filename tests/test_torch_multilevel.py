"""reftr_torch's feature levels and RoBERTa against reftr_tpu, on the CPU
in float32.

The same seeded numpy inputs and the same random weights (every Flax leaf
replaced, ``torch_parity_utils.random_flax_params``) go through both
packages. Tolerances: whole forwards at 2, 3 and 4 feature levels 1e-4 max
abs, as in tests/test_torch_model.py (some 80 layers of LayerNorm and
matmul sums in another order); RoBERTa's embeddings and encoder 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.models.reftr import RefTR as JaxRefTR
from reftr_tpu.models.reftr_seg import RefTRSeg as JaxRefTRSeg
from reftr_tpu.nn.bert import BertEmbeddings as JaxBertEmbeddings
from reftr_tpu.nn.bert import BertModel as JaxBertModel
from reftr_torch.convert import from_flax, init_params
from reftr_torch.core.config import BertConfig
from reftr_torch.models.reftr import RefTR
from reftr_torch.models.reftr_seg import RefTRSeg
from reftr_torch.nn.bert import BertModel
from test_torch_model import tiny_batch
from test_torch_multiphrase import ATOL, bert_tiny, configs
from torch_parity_utils import close, load_port, random_flax_params, t

torch.set_num_threads(1)


@pytest.mark.parametrize("nfl", [2, 3, 4])
def test_multi_level_forward_matches_jax(nfl):
    """The last min(nfl, 3) stages through 1x1 projections, then 3x3 /
    stride-2 extras: every Flax leaf fills a port tensor, and the forward
    (memory over every level, boxes) agrees at 1e-4."""
    jcfg, pcfg = configs(num_feature_levels=nfl)
    jax_model = JaxRefTR(jcfg)
    batch = tiny_batch()
    params = random_flax_params(jax_model, batch)
    sd = from_flax(params, pcfg)
    n_leaves = len(flatten_dict(params))
    assert len(sd) == n_leaves == len(RefTR(pcfg).state_dict())
    assert sd["input_proj.0.conv.weight"].shape[1] == (
        (1024, 512, 512)[nfl - 2])
    if nfl == 4:
        assert sd["input_proj.3.conv.weight"].shape == (64, 64, 3, 3)
    want = jax_model.apply({"params": params}, batch, return_internals=True)
    port = RefTR(pcfg)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port.eval()({k: t(v) for k, v in batch.items()},
                          return_internals=True)
    assert len(got["internals"]["srcs"]) == nfl
    for g, w in zip(got["internals"]["srcs"], want["internals"]["srcs"]):
        close(g, w, ATOL)
    close(got["internals"]["memory"], want["internals"]["memory"], ATOL)
    np.testing.assert_array_equal(
        got["internals"]["memory_valid"].numpy(),
        np.asarray(want["internals"]["memory_valid"]))
    close(got["pred_boxes"], want["pred_boxes"], ATOL)


def test_seeded_init_fills_every_level():
    _, pcfg = configs(num_feature_levels=4)
    gen = torch.Generator()
    gen.manual_seed(0)
    model = init_params(RefTR(pcfg), gen)
    w = model.input_proj[3].conv.weight
    bound = np.sqrt(6.0 / (2 * 64 * 9))  # xavier over 3x3 fans
    assert 0.5 * bound < w.abs().max().item() <= bound + 1e-6
    assert not model.input_proj[3].conv.bias.any()
    with torch.no_grad():
        out = model.eval()({k: t(v) for k, v in tiny_batch().items()})
    assert torch.isfinite(out["pred_boxes"]).all()


def test_roberta_matches_jax():
    """RoBERTa's position ids (cumsum of the real tokens, offset past the
    pad id, pads at the pad id's row) and its encoder, at 1e-5."""
    kw = dict(is_roberta=True, pad_token_id=1, layer_norm_eps=1e-5,
              max_position_embeddings=20)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 512, (3, 12)).astype(np.int32)
    mask = np.zeros((3, 12), np.int32)
    for i, n in enumerate((12, 7, 3)):
        mask[i, :n] = 1
    ids = np.where(mask == 1, ids, 1).astype(np.int32)
    jbert = JaxBertModel(bert_tiny(JaxBertConfig, **kw))
    params = random_flax_params(jbert, ids, mask)
    want_seq, want_pooled = jbert.apply({"params": params}, ids, mask)
    want_emb = JaxBertEmbeddings(bert_tiny(JaxBertConfig, **kw)).apply(
        {"params": params["embeddings"]}, ids)
    port = load_port(BertModel(bert_tiny(BertConfig, **kw)), params)
    with torch.no_grad():
        emb = port.embeddings(t(ids).long())
        seq, pooled = port(t(ids).long(), t(mask))
    close(emb, want_emb, 1e-5)
    close(seq, want_seq, 1e-5)
    close(pooled, want_pooled, 1e-5)


def test_a_roberta_base_tree_loads():
    """from_flax carries RoBERTa-base's 50265-word vocabulary and its
    514-row position table."""
    jcfg, pcfg = configs()
    jcfg.bert, pcfg.bert = JaxBertConfig.roberta_base(), \
        BertConfig.roberta_base()
    jcfg.bert.num_hidden_layers = pcfg.bert.num_hidden_layers = 1
    shapes = jax.eval_shape(lambda: JaxRefTR(jcfg).init(
        jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray,
                                                      tiny_batch())))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    shapes["params"])
    sd = from_flax(params, pcfg)
    emb = "lang_backbone.embeddings."
    assert sd[emb + "position_embeddings.weight"].shape == (514, 768)
    assert sd[emb + "word_embeddings.weight"].shape == (50265, 768)


def test_seg_refuses_more_than_one_feature_level():
    jcfg, pcfg = configs(num_feature_levels=2, masks=True)
    with pytest.raises(ValueError, match="single feature level"):
        RefTRSeg(pcfg)
    with pytest.raises(AssertionError, match="single feature level"):
        random_flax_params(JaxRefTRSeg(jcfg), tiny_batch())
