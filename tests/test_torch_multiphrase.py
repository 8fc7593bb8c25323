"""reftr_torch's multi-phrase path, its datasets and the matcher against
reftr_tpu, on the CPU in float32 (feature levels and RoBERTa:
tests/test_torch_multilevel.py).

The same seeded numpy inputs and the same random weights (every Flax leaf
replaced, ``torch_parity_utils.random_flax_params``) go through both
packages. Tolerances:

- datasets, loader batches, phrase spans and validities, matcher
  assignments: exact (the same C++ tokenizer and image ops, integer logic);
- the phrases' pooled BERT features: 1e-5 max abs (LayerNorm and matmul
  sums in another order);
- the whole multi-phrase forward: 1e-4 max abs, as in
  tests/test_torch_model.py (some 80 layers of such sums);
- one float32 multi-phrase train step: tests/test_torch_train.py's
  tolerances (losses 1e-5 relative, clip norm 1e-4 relative, each gradient
  1e-4 of its leaf's largest magnitude plus 1e-6 of the model's, updated
  parameters 1e-6 where the clipped gradient is above 100 Adam eps);
- evaluate's stats 1e-5 relative, its boxes 1e-3 pixels;
- matcher costs: 1e-6 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import DataConfig as JaxDataConfig
from reftr_tpu.core.config import LossConfig as JaxLossConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import TrainConfig as JaxTrainConfig
from reftr_tpu.data import build as jax_build
from reftr_tpu.data import datasets as jax_datasets
from reftr_tpu.data import loader as jax_loader
from reftr_tpu.data import native as jax_native
from reftr_tpu.models import criterion as jax_criterion
from reftr_tpu.models import matcher as jax_matcher
from reftr_tpu.models.reftr import RefTR as JaxRefTR
from reftr_tpu.train import schedules as jax_schedules
from reftr_tpu.train.engine import evaluate as jax_evaluate
from reftr_tpu.train.optimizer import build_optimizer, label_fn
from reftr_tpu.train.state import TrainState as JaxTrainState
from reftr_tpu.train.steps import make_eval_step as jax_eval_step
from reftr_tpu.train.steps import make_train_step as jax_train_step
from reftr_torch.convert import flax_leaf_to_torch, from_flax, init_params
from reftr_torch.core.config import (BertConfig, DataConfig, LossConfig,
                                     ModelConfig, TrainConfig)
from reftr_torch.data import build, datasets, loader, native
from reftr_torch.models import criterion as port_criterion
from reftr_torch.models import matcher
from reftr_torch.models.reftr import RefTR
from reftr_torch.models.reftr_seg import RefTRSeg
from reftr_torch.train.engine import evaluate
from reftr_torch.train.state import TrainState
from reftr_torch.train.steps import make_eval_step, make_train_step
from test_torch_data import WORDPIECE_VOCAB, assert_trees_equal, write_lines
from test_torch_model import tiny_batch
from torch_parity_utils import close, random_flax_params, t

torch.set_num_threads(1)
ATOL = 1e-4
TINY = dict(enc_layers=2, dec_layers=2, dim_feedforward=64, hidden_dim=64,
            nheads=4, aux_loss=True, dropout=0.0)
CLIP = 0.1
ADAM_EPS = 1e-8


def bert_tiny(cls, **kw):
    c = cls.tiny()
    c.hidden_dropout = c.attention_dropout = 0.0
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def configs(**model):
    model = dict(TINY, **model)
    return (JaxModelConfig(bert=bert_tiny(JaxBertConfig), **model),
            ModelConfig(bert=bert_tiny(BertConfig), **model))


def mp_batch(seed=0):
    """tiny_batch with 3 phrase slots of 6 tokens per row: row 0 has two
    phrases and an empty slot ("[CLS] [SEP]", span (0, 1)), row 1 three,
    one of them 2 tokens long (its third token is padding: no query)."""
    batch = tiny_batch(seed)
    rng = np.random.default_rng(seed + 1)
    valid = np.zeros((2, 3, 6), np.int32)
    valid[0, 0, :5] = 1
    valid[0, 1, :3] = 1
    valid[0, 2, :2] = 1
    valid[1, :2, :] = 1
    valid[1, 2, :4] = 1
    batch.update(
        phrases=rng.integers(1, 512, (2, 3, 6)).astype(np.int32) * valid,
        phrase_valid=valid,
        phrase_pos_l=np.array([[1, 3, 0], [2, 1, 5]], np.int32),
        phrase_pos_r=np.array([[3, 6, 1], [5, 4, 11]], np.int32))
    return batch


def mp_targets():
    rng = np.random.default_rng(3)
    centre = rng.uniform(0.3, 0.7, (2, 3, 2))
    size = rng.uniform(0.1, 0.4, (2, 3, 2))
    return {"boxes": np.concatenate([centre, size], -1).astype(np.float32),
            "box_valid": np.array([[True, True, False], [True] * 3])}


@pytest.fixture(scope="module")
def mp_pair():
    """(jax model, random params, port model) of the tiny multi-phrase
    RefTR."""
    jcfg, pcfg = configs()
    jax_model = JaxRefTR(jcfg)
    params = random_flax_params(jax_model, mp_batch())
    port = RefTR(pcfg)
    port.load_state_dict(from_flax(params, pcfg))
    return jax_model, params, port.eval()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_phrase_inputs_match_jax(mp_pair):
    """Spans and validities exactly, the phrases' pooled features (through
    map_phrase) at 1e-5."""
    jax_model, params, port = mp_pair
    batch = mp_batch()
    pooled = np.random.default_rng(4).normal(size=(2, 32)).astype(np.float32)
    want = jax_model.apply({"params": params}, batch, pooled, True,
                           method=JaxRefTR.phrase_inputs)
    with torch.no_grad():
        got = port.phrase_inputs({k: t(v) for k, v in batch.items()},
                                 t(pooled))
    close(got[0], want[0], 1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].tolist() == [[True, True, False], [True, True, True]]


def test_multi_phrase_forward_matches_jax(mp_pair):
    jax_model, params, port = mp_pair
    batch = mp_batch()
    want = jax_model.apply({"params": params}, batch, return_internals=True)
    with torch.no_grad():
        got = port({k: t(v) for k, v in batch.items()},
                   return_internals=True)
    assert tuple(got["pred_boxes"].shape) == (2, 3, 1, 4)
    close(got["pred_boxes"], want["pred_boxes"], ATOL)
    for key in ("memory", "hs"):
        close(got["internals"][key], want["internals"][key], ATOL)
    close(got["aux_outputs"][0]["pred_boxes"],
          want["aux_outputs"][0]["pred_boxes"], ATOL)
    np.testing.assert_array_equal(got["phrase_mask"].numpy(),
                                  np.asarray(want["phrase_mask"]))


def test_freeze_bert_on_the_phrase_path():
    """freeze_bert: no gradient reaches BERT from the sentence or the
    phrases, and the rest of the model gets one."""
    _, pcfg = configs(freeze_bert=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    model = init_params(RefTR(pcfg), gen).train()
    torch.nn.init.normal_(model.bbox_embed.layers[-1].weight, generator=gen)
    out = model({k: t(v) for k, v in mp_batch().items()})
    wd = port_criterion.weight_dict(LossConfig(), 2, True)
    loss = port_criterion.total_loss(port_criterion.criterion(
        out, {k: t(v) for k, v in mp_targets().items()}, LossConfig()), wd)
    loss.backward()
    bert = [p for n, p in model.named_parameters()
            if n.startswith("lang_backbone.")]
    assert bert and all(p.grad is None and not p.requires_grad
                        for p in bert)
    assert model.map_phrase.fc1.weight.grad.abs().sum() > 0
    assert model.query_encoder.linear1.weight.grad.abs().sum() > 0


def test_seg_leaves_the_phrase_keys_out():
    """RES is single-phrase: a batch's phrase keys change nothing."""
    _, pcfg = configs(masks=True, hidden_dim=128, nheads=8)
    gen = torch.Generator()
    gen.manual_seed(0)
    model = init_params(RefTRSeg(pcfg), gen).eval()
    batch = {k: t(v) for k, v in mp_batch().items()}
    with torch.no_grad():
        got = model(batch)
        want = model({k: v for k, v in batch.items()
                      if not k.startswith("phrase")})
    assert tuple(got["pred_boxes"].shape) == (2, 1, 1, 4)
    for key in ("pred_boxes", "pred_masks", "phrase_mask"):
        assert torch.equal(got[key], want[key]), key


# ---------------------------------------------------------------------------
# one float32 train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mp_step(mp_pair):
    """JAX's multi-phrase step from mp_pair's weights: (new params,
    metrics, clip norm, masked gradients)."""
    jax_model, params, _ = mp_pair
    jcfg = jax_model.config
    batch, targets = mp_batch(), mp_targets()
    tc = JaxTrainConfig(epochs=1)
    tx = build_optimizer(jcfg, tc, jax_schedules.build_schedule(tc, 1))
    wd = jax_criterion.weight_dict(JaxLossConfig(), jcfg.dec_layers,
                                   jcfg.aux_loss)
    state = JaxTrainState.create(params, tx, jax.random.PRNGKey(1))
    step = jax_train_step(jax_model, wd, JaxLossConfig(), donate=False)
    new_state, metrics = step(state, batch, targets)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        out = jax_model.apply({"params": p}, jbatch, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_criterion.total_loss(
            jax_criterion.criterion(out, targets, JaxLossConfig()), wd)

    grads = jax.jit(jax.grad(loss_fn))(params)
    labels = label_fn(jcfg, tc)(params)
    masked = jax.tree_util.tree_map(lambda g, lab: g * (lab != "frozen"),
                                    grads, labels)
    return {"new_params": jax.device_get(new_state.params),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "clip_norm": float(optax.global_norm(masked)),
            "grads": flatten_dict(jax.device_get(masked))}


@pytest.fixture(scope="module")
def port_mp_step(mp_pair):
    _, params, _ = mp_pair
    _, pcfg = configs()
    state = TrainState.create(pcfg, TrainConfig(epochs=1), 1, device="cpu",
                              state_dict=from_flax(params, pcfg))
    wd = port_criterion.weight_dict(LossConfig(), pcfg.dec_layers,
                                    pcfg.aux_loss)
    step = make_train_step(state.model, wd, LossConfig(), device="cpu")
    state, metrics = step(state, mp_batch(), mp_targets())
    return state, metrics.get()


def test_multi_phrase_step_losses_and_clip_norm_match_jax(jax_mp_step,
                                                          port_mp_step):
    _, got = port_mp_step
    want = jax_mp_step["metrics"]
    for key in ("loss", "loss_bbox", "loss_giou", "loss_bbox_0",
                "loss_giou_0"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], jax_mp_step["clip_norm"],
                               rtol=1e-4)


def test_multi_phrase_step_gradients_and_params_match_jax(jax_mp_step,
                                                          port_mp_step):
    state, _ = port_mp_step
    _, pcfg = configs()
    coef = CLIP / max(jax_mp_step["clip_norm"], CLIP)
    named = dict(state.model.named_parameters())
    gmax = coef * max(np.abs(g).max() for g in jax_mp_step["grads"].values())
    compared, grads = 0, {}
    for path, g in jax_mp_step["grads"].items():
        name, want = flax_leaf_to_torch(path, np.asarray(g) * coef)
        grads[name] = np.abs(want)
        if name not in named:  # FrozenBN statistics: buffers in the port
            assert not want.any()
            continue
        p = named[name]
        if p.grad is None:  # frozen: the stem and layer1
            assert not p.requires_grad and not want.any(), name
            continue
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max() + 1e-6 * gmax, name
        compared += 1
    assert compared == len(state.trainable())
    want_params = from_flax(jax_mp_step["new_params"], pcfg)
    lr = TrainConfig().lr
    for name, got in state.model.state_dict().items():
        err = np.abs(got.numpy() - want_params[name].numpy())
        if name in named and named[name].requires_grad:
            big = grads[name] > 100 * ADAM_EPS
            assert (err[big] <= 1e-6).all(), name
            assert err.max() <= 2 * lr, name
        else:
            assert err.max() == 0.0, name


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------

def test_matcher_costs_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.2, 0.8, (7, 4)).astype(np.float32)
    tgt = rng.uniform(0.2, 0.8, (3, 4)).astype(np.float32)
    logits = rng.normal(size=(7, 5)).astype(np.float32)
    ids = np.array([4, 0, 2])
    kw = dict(set_cost_class=2.0, set_cost_bbox=3.0, set_cost_giou=1.5,
              focal_alpha=0.3)
    want = np.asarray(jax_matcher.match_cost(pred, tgt, logits, ids, **kw))
    got = matcher.match_cost(t(pred), t(tgt), t(logits), t(ids), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        matcher.match_cost(t(pred), t(tgt)).numpy(),
        np.asarray(jax_matcher.match_cost(pred, tgt)), rtol=1e-6, atol=1e-6)
    prob = 1 / (1 + np.exp(-logits))
    np.testing.assert_allclose(
        matcher.focal_class_cost(t(prob), t(ids)).numpy(),
        np.asarray(jax_matcher.focal_class_cost(prob, ids)), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("q,n", [(7, 3), (4, 4), (2, 6)])
def test_matcher_assignments_match_jax(q, n):
    rng = np.random.default_rng(q * 10 + n)
    cost = rng.normal(size=(q, n)).astype(np.float32)
    for g, w in zip(matcher.hungarian_match(t(cost)),
                    jax_matcher.hungarian_match(cost)):
        np.testing.assert_array_equal(g, w)
    col = cost[:, :1]
    np.testing.assert_array_equal(matcher.one_to_all_match(t(col), 2),
                                  jax_matcher.one_to_all_match(col, 2))


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wordpiece(tmp_path_factory):
    path = write_lines(tmp_path_factory.mktemp("vocab") / "vocab.txt",
                       WORDPIECE_VOCAB)
    return jax_native.WordPieceTokenizer(path), native.WordPieceTokenizer(path)


FLICKR_RECORDS = [
    # scalar phrase starts (the reference's .pth records)
    ("im0.png", [0, 11], [[2, 3, 30, 20], [10, 12, 40, 44]],
     ["the man", "the red shirt"], None,
     "the man in the red shirt is walking"),
    # (start, end) pairs, a phrase past the phrase length (truncated) and
    # more phrases than slots
    ("im1.png", [[0, 9], [14, 40], [44, 51], [0, 3]],
     [[0, 0, 10, 10], [5, 5, 25, 30], [20, 2, 47, 33], [1, 1, 2, 2]],
     ["a person", "with his bicycle on the left with a hat", "the dog",
      "a p"], None,
     "a person with his bicycle on the left with a hat! the dog."),
    # a start that maps to no token: the span falls back to (0, len - 1]
    ("im2.png", [60], [[4, 4, 20, 28]], ["green"], None,
     "green blue"),
]


@pytest.fixture(scope="module")
def flickr_root(tmp_path_factory):
    """<root>/annotations/flickr30k_entities/flickr30k_entities_<split>.json
    and PNGs under <root>/flickr30k/f30k_images (one grayscale)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("flickr")
    im_dir = root / "flickr30k" / "f30k_images"
    im_dir.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i, (h, w) in enumerate([(48, 64), (50, 50), (36, 60)]):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img[..., 0] if i == 2 else img).save(
            im_dir / f"im{i}.png")
    ann = root / "annotations" / "flickr30k_entities"
    ann.mkdir(parents=True)
    for split in ("train", "val"):
        (ann / f"flickr30k_entities_{split}.json").write_text(
            json.dumps(FLICKR_RECORDS))
    return root


FLICKR_KW = dict(img_size=48, max_img_size=56, max_sentence_len=16,
                 phrase_seq_len=6, max_num_phrases=3)


@pytest.mark.parametrize("train", [True, False])
def test_flickr_items_agree(wordpiece, flickr_root, train):
    args = (str(flickr_root / "annotations"),
            str(flickr_root / "flickr30k" / "f30k_images"), "train")
    ref = jax_datasets.FlickrMultiPhraseDataset(
        *args, wordpiece[0], train=train, seed=3, **FLICKR_KW)
    port = datasets.FlickrMultiPhraseDataset(
        *args, wordpiece[1], train=train, seed=3, **FLICKR_KW)
    assert len(port) == len(ref) == 3
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        port.set_epoch(epoch)
        for i in range(3):
            for g, w in zip(port[i], ref[i]):
                assert_trees_equal(g, w)
    s, tg = port[1]
    assert s["phrase_valid"][1].all()  # truncated at 6 tokens
    assert tg["box_valid"].tolist() == [True, True, True]
    s, tg = port[2]
    assert tg["box_valid"].tolist() == [True, False, False]
    assert (s["phrase_pos_l"][1:].tolist(), s["phrase_pos_r"][1:].tolist()
            ) == ([0, 0], [1, 1])


@pytest.mark.parametrize("kw", [
    {}, dict(img_size=48, canvas=56, max_sentence_len=90, phrase_seq_len=22,
             max_num_phrases=16, box_frac=(0.25, 0.4))],
    ids=["defaults", "flickr_widths"])
def test_synthetic_multi_phrase_items_agree(tmp_path, kw):
    path = datasets.write_synthetic_vocab(str(tmp_path / "vocab.txt"))
    ref = jax_datasets.SyntheticMultiPhraseDataset(
        jax_native.WordPieceTokenizer(path), n=5, **kw)
    port = datasets.SyntheticMultiPhraseDataset(
        native.WordPieceTokenizer(path), n=5, **kw)
    for i in range(5):
        for g, w in zip(port[i], ref[i]):
            assert_trees_equal(g, w)
    sample, target = port[0]
    assert target["box_valid"].sum() == 2
    assert (sample["phrase_valid"][2:, 2] == 0).all()


def _data_configs(**kw):
    return DataConfig(**kw), JaxDataConfig(**kw)


@pytest.mark.parametrize("split,train", [("train", True), ("val", False)])
def test_build_flickr30k_agrees(wordpiece, flickr_root, split, train):
    cfg, jcfg = _data_configs(dataset="flickr30k",
                              data_root=str(flickr_root), img_size=48,
                              max_img_size=56, max_sentence_len=16,
                              phrase_seq_len=6, max_num_phrases=3)
    port = build.build_refer_dataset(split, cfg, wordpiece[1], train, seed=2)
    ref = jax_build.build_refer_dataset(split, jcfg, wordpiece[0], train,
                                        seed=2)
    assert isinstance(port, datasets.FlickrMultiPhraseDataset)
    for i in range(len(ref)):
        for g, w in zip(port[i], ref[i]):
            assert_trees_equal(g, w)


@pytest.mark.parametrize("train", [True, False])
def test_build_synthetic_multi_is_the_jax_fixture(wordpiece, train):
    """synthetic_multi (the port's name): the JAX package's
    SyntheticMultiPhraseDataset at the DataConfig's widths, synthetic_n
    train items and 64 of every other split."""
    cfg, _ = _data_configs(dataset="synthetic_multi", img_size=40,
                           max_img_size=48, synthetic_n=10,
                           synthetic_box_frac=(0.25, 0.4))
    port = build.build_refer_dataset("train" if train else "val", cfg,
                                     wordpiece[1], train)
    ref = jax_datasets.SyntheticMultiPhraseDataset(
        wordpiece[0], n=10 if train else 64, img_size=40, canvas=48,
        max_sentence_len=90, phrase_seq_len=22, max_num_phrases=16,
        box_frac=(0.25, 0.4))
    assert len(port) == len(ref)
    for i in (0, len(ref) - 1):
        for g, w in zip(port[i], ref[i]):
            assert_trees_equal(g, w)


def test_loader_pads_a_multi_phrase_batch(wordpiece):
    """The padded last batch stacks the four phrase keys and zeroes
    box_valid alone, as JAX's loader does."""
    kw = dict(n=5, img_size=32)
    port = loader.DataLoader(
        datasets.SyntheticMultiPhraseDataset(wordpiece[1], **kw), 4,
        num_workers=2, drop_last=False)
    ref = jax_loader.DataLoader(
        jax_datasets.SyntheticMultiPhraseDataset(wordpiece[0], **kw), 4,
        num_workers=2, drop_last=False)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 2
    for (s1, t1), (s2, t2) in zip(got, want):
        assert_trees_equal(s1, s2)
        assert_trees_equal(t1, t2)
    samples, targets = got[-1]
    assert samples["phrases"].shape == (4, 4, 8)
    assert targets["box_valid"].sum(-1).tolist() == [2, 0, 0, 0]
    assert (samples["phrase_valid"][1:] == samples["phrase_valid"][0]).all()


def test_evaluate_matches_jax_on_a_multi_phrase_loader(mp_pair, wordpiece):
    """The port's evaluate over the multi-phrase fixture (5 items in
    batches of 2, the last one padded) against JAX's evaluate with the
    same weights: counts per valid phrase, accuracy and mIoU, the logged
    losses and each image's boxes."""
    jax_model, params, port = mp_pair
    kw = dict(n=5, img_size=64, max_sentence_len=12, phrase_seq_len=6,
              max_num_phrases=3)
    port_loader = loader.DataLoader(
        datasets.SyntheticMultiPhraseDataset(wordpiece[1], **kw), 2,
        num_workers=1, drop_last=False)
    ref_loader = jax_loader.DataLoader(
        jax_datasets.SyntheticMultiPhraseDataset(wordpiece[0], **kw), 2,
        num_workers=1, drop_last=False)
    jwd = jax_criterion.weight_dict(JaxLossConfig(), 2, True)
    want, want_res = jax_evaluate(
        jax_eval_step(jax_model, jwd, JaxLossConfig()), params, ref_loader,
        weight_dict=jwd, collect_results=True, print_fn=lambda *a: None)
    wd = port_criterion.weight_dict(LossConfig(), 2, True)
    got, got_res = evaluate(make_eval_step(port, LossConfig(), device="cpu"),
                            port_loader, weight_dict=wd,
                            collect_results=True, print_fn=lambda *a: None)
    assert set(got) == set(want)
    assert got["accuracy_iou0.5"] == want["accuracy_iou0.5"]
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k
    assert sorted(got_res) == sorted(want_res) == list(range(5))
    for i in want_res:
        assert len(got_res[i]) == len(want_res[i]) == 2
        np.testing.assert_allclose(got_res[i], want_res[i], atol=1e-3)
