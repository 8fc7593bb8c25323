"""reftr_torch RefTR (single-phrase REC) against reftr_tpu, the weight
bridge and the seeded init.

The full forward runs at a tiny size (bert tiny, ResNet-50 at 64 px, 2+2
VL layers, d=64) in float32 on the CPU, with every Flax leaf replaced by
seeded random values before conversion. Tolerance: atol 1e-4 for the full
model (LayerNorm and accumulation order through some 80 layers).
"""

import numpy as np
import pytest
import torch

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.models.reftr import RefTR as JaxRefTR
from reftr_torch.convert import build_model, from_flax, init_params
from reftr_torch.core.config import BertConfig, ModelConfig
from reftr_torch.models.reftr import RefTR
from torch_parity_utils import close, random_flax_params, t

ATOL = 1e-4
TINY = dict(enc_layers=2, dec_layers=2, dim_feedforward=64, hidden_dim=64,
            nheads=4, aux_loss=True)


def tiny_batch(seed=0, b=2, hw=64, s=12):
    rng = np.random.default_rng(seed)
    sentence_valid = np.zeros((b, s), np.int32)
    sentence_valid[0, :7] = 1
    sentence_valid[1, :s] = 1
    image_valid = np.zeros((b, hw, hw), bool)
    image_valid[0, :48, :] = True
    image_valid[1, :, :40] = True
    return {
        "image": rng.integers(0, 256, (b, hw, hw, 3)).astype(np.uint8),
        "image_valid": image_valid,
        "sentence": rng.integers(1, 512, (b, s)).astype(np.int32),
        "sentence_valid": sentence_valid,
    }


@pytest.fixture(scope="module")
def tiny_pair():
    """(jax model, random params, port config) at the tiny size."""
    jax_model = JaxRefTR(JaxModelConfig(bert=JaxBertConfig.tiny(), **TINY))
    params = random_flax_params(jax_model, tiny_batch())
    return jax_model, params, ModelConfig(bert=BertConfig.tiny(), **TINY)


def test_full_forward_matches_jax(tiny_pair):
    jax_model, params, cfg = tiny_pair
    batch = tiny_batch()
    want = jax_model.apply({"params": params}, batch, return_internals=True)
    port = RefTR(cfg)
    port.load_state_dict(from_flax(params, cfg))
    port.eval()
    with torch.no_grad():
        got = port({k: t(v) for k, v in batch.items()},
                   return_internals=True)
    close(got["pred_boxes"], want["pred_boxes"], ATOL)
    for key in ("memory", "hs"):
        assert tuple(got["internals"][key].shape) == \
            want["internals"][key].shape
        close(got["internals"][key], want["internals"][key], ATOL)
    np.testing.assert_array_equal(got["internals"]["memory_valid"].numpy(),
                                  np.asarray(want["internals"]
                                             ["memory_valid"]))
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 1
    close(got["aux_outputs"][0]["pred_boxes"],
          want["aux_outputs"][0]["pred_boxes"], ATOL)
    np.testing.assert_array_equal(got["phrase_mask"].numpy(),
                                  np.asarray(want["phrase_mask"]))


def test_converter_fills_every_tensor_and_uses_every_leaf(tiny_pair):
    _, params, cfg = tiny_pair
    sd = from_flax(params, cfg)
    expected = RefTR(cfg).state_dict()
    assert set(sd) == set(expected)
    n_leaves = sum(1 for _ in _leaves(params))
    assert n_leaves == len(sd)
    for name, value in sd.items():
        assert value.shape == expected[name].shape, name


def _leaves(tree):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def _edited(params, edit):
    tree = {k: dict(v) if isinstance(v, dict) else v
            for k, v in params.items()}
    edit(tree)
    return tree


def test_converter_rejects_unused_missing_and_misshaped(tiny_pair):
    _, params, cfg = tiny_pair
    extra = _edited(params, lambda p: p.update(
        stray={"kernel": np.zeros((3, 3), np.float32)}))
    with pytest.raises(ValueError, match="left unused.*stray"):
        from_flax(extra, cfg)
    missing = _edited(params, lambda p: p["bbox_embed"].pop("layers_2"))
    with pytest.raises(ValueError, match="left unfilled.*bbox_embed"):
        from_flax(missing, cfg)
    bad = _edited(params, lambda p: p.update(
        map_phrase={**p["map_phrase"],
                    "fc1": {"kernel": np.zeros((5, 64), np.float32),
                            "bias": p["map_phrase"]["fc1"]["bias"]}}))
    with pytest.raises(ValueError, match="shape"):
        from_flax(bad, cfg)


def _seeded(cfg, seed):
    model = RefTR(cfg)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return init_params(model, gen)


def test_init_params_is_seeded_and_follows_the_jax_initialisers():
    cfg = ModelConfig(bert=BertConfig.tiny(), **TINY)
    a, b, c = _seeded(cfg, 0), _seeded(cfg, 0), _seeded(cfg, 1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for name in sa:
        torch.testing.assert_close(sa[name], sb[name], rtol=0, atol=0)
    assert not torch.equal(sa["vl_transformer.level_embed"],
                           sc["vl_transformer.level_embed"])
    # zero final layer of bbox_embed: every box starts at the centre
    last = a.bbox_embed.layers[-1]
    assert not last.weight.any() and not last.bias.any()
    # normal(1.0) level embedding, normal(0.02) BERT embeddings
    level = a.vl_transformer.level_embed
    assert 0.7 < level.std().item() < 1.3
    words = a.lang_backbone.embeddings.word_embeddings.weight
    assert abs(words.std().item() - 0.02) < 0.002
    # xavier-uniform projections: bound sqrt(6 / (fan_in + fan_out))
    w = a.vl_transformer.encoder.layers[0].self_attn.q_proj.weight
    assert w.abs().max().item() <= np.sqrt(6.0 / (2 * 64)) + 1e-6
    bn = a.img_backbone.layer1[0].bn1
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    with torch.no_grad():
        out = a.eval()({k: t(v) for k, v in tiny_batch().items()})
    torch.testing.assert_close(out["pred_boxes"],
                               torch.full_like(out["pred_boxes"], 0.5))


@pytest.mark.parametrize("change", [
    {"heatmap_box": True},
    {"vision_aux": True, "heatmap_box": True, "num_queries_per_phrase": 2}])
def test_unported_options_raise(change):
    """The from-scratch heads run since their slice; what the JAX factory
    refuses of them (reftr_tpu/models/build.py:41-53), the heatmap box
    without the probe or over more than one query, has no port either and
    raises as there."""
    with pytest.raises(ValueError, match="heatmap_box"):
        build_model(ModelConfig(bert=BertConfig.tiny(),
                                **dict(TINY, **change)), "cpu")
