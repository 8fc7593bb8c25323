"""The JAX step's knobs in reftr_torch, on the CPU in float32: recompute
in the backward (``--remat``, ``--backbone_remat``), the attention route
(``--use_pallas_attention``), ``--debug_nans``, ``--no_donate_state`` and
the optimizer's labels of a folded backbone.

Tolerances: the backbone recomputed per bottleneck against JAX's forward
at 1e-5 of the largest output (tests/test_torch_backbone.py's rule), its
gradients against the port's without recompute at 1e-4 (JAX's
tests/test_resnet.py:326); the VL encoder recomputed with dropout 0.1
against the step without recompute at 1e-6, since the recompute must use
the forward's masks, the attention seeds (``nn/attention.seed_replay``)
and the elementwise dropouts' (checkpoint's RNG state) alike. A recompute
that drew new attention seeds gives other gradients, which the test shows
by drawing them.
"""

import contextlib

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import TrainConfig as JaxTrainConfig
from reftr_tpu.models.reftr import RefTR as JaxRefTR
from reftr_tpu.nn.resnet import ResNet as JaxResNet
from reftr_tpu.train.optimizer import label_fn
from reftr_torch.convert import build_model, flax_leaf_to_torch
from reftr_torch.core.config import (BertConfig, LossConfig, ModelConfig,
                                     TrainConfig)
from reftr_torch.models import criterion as port_criterion
from reftr_torch.nn import attention as port_attention
from reftr_torch.nn import transformer as port_transformer
from reftr_torch.nn.resnet import Bottleneck, ResNet
from reftr_torch.train import steps as port_steps
from reftr_torch.train.optimizer import param_label
from reftr_torch.train.state import TrainState
from reftr_torch.train.steps import make_train_step
from test_torch_model import tiny_batch
from test_torch_train import tiny_targets
from torch_parity_utils import (close_to_scale, load_port,
                                random_flax_params, t)

torch.set_num_threads(1)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6
DROPOUT = 0.1
TINY = dict(enc_layers=2, dec_layers=1, dim_feedforward=64, hidden_dim=32,
            nheads=4, aux_loss=True)


@pytest.mark.parametrize("kw", [dict(remat_blocks=True),
                                dict(remat_stages=(1, 2))],
                         ids=["blocks", "stages_1_2"])
def test_backbone_remat_matches_jax(kw, monkeypatch):
    """Every bottleneck (or those of layers 1-2) recomputed in the
    backward: the forward is JAX's, the gradients those of the backbone
    kept whole, and each recomputed bottleneck runs twice."""
    x = np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    jnet = JaxResNet("resnet50")
    params = random_flax_params(jnet, x)
    (want,) = jnet.apply({"params": params}, x)
    plain = load_port(ResNet("resnet50"), params)
    remat = load_port(ResNet("resnet50", **kw), params)
    calls = {"n": 0}
    forward = Bottleneck.forward

    def count(self, y):
        calls["n"] += self in blocks
        return forward(self, y)

    blocks = {m for m in remat.modules() if isinstance(m, Bottleneck)}
    monkeypatch.setattr(Bottleneck, "forward", count)
    grads = []
    for net in (plain, remat):
        out = net(t(x))
        (out ** 2).sum().backward()
        grads.append({n: p.grad for n, p in net.named_parameters()})
        if net is remat:
            close_to_scale(out, want, FWD_TOL)
    n_blocks = 16
    recomputed = n_blocks if "remat_blocks" in kw else 3 + 4
    assert calls["n"] == n_blocks + recomputed
    for name, g in grads[0].items():
        scale = float(g.abs().max()) or 1.0
        err = float((grads[1][name] - g).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def model_config(dropout=DROPOUT, **kw):
    bert = BertConfig.tiny()
    bert.hidden_dropout = bert.attention_dropout = dropout
    return ModelConfig(bert=bert, dropout=dropout, **TINY, **kw)


def one_step(cfg, elementwise_only=False):
    """One port train step of the tiny RefTR from seed 0 with the same
    generator: (loss, every gradient after the clip)."""
    state = TrainState.create(cfg, TrainConfig(epochs=1, lr=0.0), 1,
                              device="cpu", seed=0)
    with torch.no_grad():  # a box head that passes gradients down
        last = state.model.bbox_embed.layers[-1].weight
        last.copy_(torch.linspace(-0.2, 0.2, last.numel()).view_as(last))
    if elementwise_only:
        for m in state.model.vl_transformer.encoder.modules():
            if isinstance(m, port_attention.MultiHeadAttention):
                m.dropout = 0.0
    wd = port_criterion.weight_dict(LossConfig(), cfg.dec_layers,
                                    cfg.aux_loss)
    step = make_train_step(state.model, wd, LossConfig(), device="cpu")
    state, metrics = step(state, tiny_batch(), tiny_targets())
    return metrics.get()["loss"], {n: p.grad.clone() for n, p in
                                   state.model.named_parameters()
                                   if p.grad is not None}


@pytest.mark.parametrize("elementwise_only", [False, True],
                         ids=["attention_and_elementwise", "elementwise"])
def test_encoder_remat_replays_the_dropout_masks(elementwise_only):
    """--remat at dropout 0.1: the encoder layers, recomputed in the
    backward, draw the forward's masks (attention's seeds and the
    elementwise dropouts'), so the step's loss and every gradient are the
    step's without recompute."""
    loss, grads = one_step(model_config(), elementwise_only)
    loss_r, grads_r = one_step(model_config(remat=True), elementwise_only)
    assert loss_r == loss
    assert set(grads_r) == set(grads)
    enc = [n for n in grads if ".encoder." in n]
    assert enc and any(float(grads[n].abs().max()) > 0 for n in enc)
    for name, g in grads.items():
        err = float((grads_r[name] - g).abs().max())
        assert err <= REMAT_TOL, (name, err)


def manual_grads(model, batch, targets, gen_seed):
    """Forward and backward outside the step, the attention generator bound
    over both: a recompute that draws from it gets new seeds."""
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(gen_seed)
    wd = port_criterion.weight_dict(LossConfig(), model.config.dec_layers,
                                    model.config.aux_loss)
    with port_attention.attention_rng(gen):
        with torch.random.fork_rng():
            torch.manual_seed(gen_seed)
            out = model(batch)
        loss = port_criterion.total_loss(port_criterion.criterion(
            out, targets, LossConfig()), wd)
        loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def test_a_recompute_with_new_seeds_gives_other_gradients(monkeypatch):
    """Without seed_replay, a recomputed encoder layer draws new attention
    seeds from the bound generator: K2 and K3 (here their plain versions)
    then run on masks the forward never used, and the encoder's gradients
    move by far more than the 1e-6 of the replayed step."""
    cfg = model_config()
    batch = {k: t(v) for k, v in tiny_batch().items()}
    targets = {k: t(v) for k, v in tiny_targets().items()}
    plain = build_model(cfg, "cpu", seed=0).train()
    remat = build_model(model_config(remat=True), "cpu", seed=0).train()
    with torch.no_grad():
        for m in (plain, remat):
            last = m.bbox_embed.layers[-1].weight
            last.copy_(torch.linspace(-0.2, 0.2, last.numel()).view_as(last))
    want = manual_grads(plain, batch, targets, 3)
    got = manual_grads(remat, batch, targets, 3)
    enc = [n for n in want if "encoder.layers" in n]
    replayed = max(float((got[n] - want[n]).abs().max()) for n in enc)
    assert replayed <= REMAT_TOL
    monkeypatch.setattr(port_transformer, "seed_replay", lambda: (
        contextlib.nullcontext(), contextlib.nullcontext()))
    drawn = manual_grads(remat, batch, targets, 3)
    moved = max(float((drawn[n] - want[n]).abs().max()) for n in enc)
    assert moved > 1e3 * REMAT_TOL, moved


def test_seed_replay_refuses_an_extra_draw():
    record, replay = port_attention.seed_replay()
    gen = torch.Generator().manual_seed(0)
    with port_attention.attention_rng(gen), record:
        first = port_attention._draw_seed(2)
    with replay:
        assert port_attention._draw_seed(2) == first
        with pytest.raises(RuntimeError, match="more attention seeds"):
            port_attention._draw_seed(2)


def route_calls(model, monkeypatch):
    """Count the calls of the kernels' wrapper and of the plain version
    made through the model's MultiHeadAttention modules."""
    calls = {"kernel": 0, "plain": 0}
    flash, plain = port_attention.flash_attention, \
        port_attention.attention_plain

    def counted(kind, fn):
        def call(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(port_attention, "flash_attention",
                        counted("kernel", flash))
    monkeypatch.setattr(port_attention, "attention_plain",
                        counted("plain", plain))
    with torch.no_grad():
        model.eval()({k: t(v) for k, v in tiny_batch().items()})
    return calls


# BERT-tiny's 2 layers, the encoder's 2, the decoder's self and cross
ATTENTIONS = 2 + 2 + 2


@pytest.mark.parametrize("setting,want", [
    (None, {"kernel": ATTENTIONS, "plain": 0}),
    (True, {"kernel": ATTENTIONS, "plain": 0}),
    (False, {"kernel": 0, "plain": ATTENTIONS})],
    ids=["auto", "on", "off"])
def test_use_pallas_attention_routes_every_attention(monkeypatch, setting,
                                                     want):
    """auto and on send every attention to the kernels' wrapper (which
    runs their plain versions on a CPU tensor and launches a kernel on a
    card), off to the plain version; the smoke counts the card's
    launches."""
    model = build_model(model_config(dropout=0.0,
                                     use_pallas_attention=setting), "cpu")
    assert route_calls(model, monkeypatch) == want


def test_use_pallas_attention_on_refuses_a_head_dim_without_kernel():
    """on: a head dim above 128 raises; auto leaves it to the rule (the
    plain version on the card)."""
    mha = port_attention.MultiHeadAttention(512, 2)
    x = torch.randn(1, 5, 512)
    port_attention.set_attention_route(mha, True)
    with pytest.raises(ValueError, match="head dim 256"):
        mha(x, x, x)
    port_attention.set_attention_route(mha, None)
    assert mha(x, x, x).shape == (1, 5, 512)


class NanGrad(torch.autograd.Function):
    """The identity forward, a NaN gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


@pytest.fixture
def debug_nans():
    port_steps.set_debug_nans(True)
    yield
    port_steps.set_debug_nans(False)


def nan_state(cfg):
    state = TrainState.create(cfg, TrainConfig(epochs=1), 1, device="cpu",
                              seed=0)
    wd = port_criterion.weight_dict(LossConfig(), cfg.dec_layers,
                                    cfg.aux_loss)
    return state, make_train_step(state.model, wd, LossConfig(),
                                  device="cpu")


def test_debug_nans_names_the_module_of_a_forward_nan(debug_nans):
    state, step = nan_state(model_config(dropout=0.0))
    with torch.no_grad():
        state.model.vl_transformer.encoder.layers[1].ffn.linear1.weight[
            0, 0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"vl_transformer\.encoder\.layers\.1\.ffn"
                             r"\.linear1 \(Linear\)"):
        step(state, tiny_batch(), tiny_targets())


def test_debug_nans_names_the_op_of_a_backward_nan(debug_nans):
    state, step = nan_state(model_config(dropout=0.0))
    head = state.model.bbox_embed
    forward = head.forward
    head.forward = lambda x: forward(NanGrad.apply(x))
    with pytest.raises(RuntimeError, match="NanGradBackward"):
        step(state, tiny_batch(), tiny_targets())


def test_without_debug_nans_a_nan_runs_through():
    state, step = nan_state(model_config(dropout=0.0))
    with torch.no_grad():
        state.model.vl_transformer.encoder.layers[1].ffn.linear1.weight[
            0, 0] = float("nan")
    _, metrics = step(state, tiny_batch(), tiny_targets())
    assert not np.isfinite(metrics.get()["loss"])


def test_donate_state_changes_no_bit():
    """TrainConfig.donate_state (--no_donate_state) leaves the step as it
    is: two steps each way end with the same parameters, bit for bit."""
    cfg = model_config()
    out = []
    for donate in (True, False):
        state = TrainState.create(cfg, TrainConfig(epochs=1,
                                                    donate_state=donate), 2,
                                  device="cpu", seed=0)
        wd = port_criterion.weight_dict(LossConfig(), cfg.dec_layers,
                                        cfg.aux_loss)
        step = make_train_step(state.model, wd, LossConfig(), device="cpu")
        for _ in range(2):
            state, _ = step(state, tiny_batch(), tiny_targets())
        out.append({k: v.clone() for k, v in state.model.state_dict().items()})
    for k, v in out[0].items():
        assert torch.equal(v, out[1][k]), k


@pytest.mark.parametrize("train_stem", [False, True])
def test_param_groups_of_a_folded_backbone_match_label_fn(train_stem):
    """JAX's labels of a folded tree (s2d stem, folded FrozenBN): the
    folded biases, buffers here, are frozen there too; conv1_s2d is the
    stem's and trains with train_stem only."""
    flags = dict(space_to_depth_stem=True, fold_bn=True,
                 train_stem=train_stem, dropout=0.0)
    jb = JaxBertConfig.tiny()
    jcfg = JaxModelConfig(bert=jb, **TINY, **flags)
    pcfg = ModelConfig(bert=BertConfig.tiny(), **TINY, **flags)
    params = random_flax_params(JaxRefTR(jcfg), tiny_batch())
    labels = flatten_dict(label_fn(jcfg, JaxTrainConfig())(params))
    leaves = flatten_dict(params)
    port = dict(build_model(pcfg, "cpu").named_parameters())
    seen = set()
    for path, label in labels.items():
        name, _ = flax_leaf_to_torch(path, np.asarray(leaves[path]))
        if name not in port:  # FrozenBN's tensors, folded or not
            assert label == "frozen", name
            continue
        assert param_label(name, pcfg, TrainConfig()) == label, name
        seen.add(name)
    assert seen == set(port)
    assert (param_label("img_backbone.conv1_s2d.weight", pcfg, TrainConfig())
            == ("backbone" if train_stem else "frozen"))
