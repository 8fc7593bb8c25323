"""reftr_torch training against reftr_tpu (float32, CPU): one train step,
the criterion and weights, the LR schedules, the parameter groups and the
epoch loop.

The step runs the tiny RefTR (bert tiny, ResNet-50 at 64 px, 2+2 VL layers,
d=64) with dropout 0 from the same converted weights through JAX's
``make_train_step(..., donate=False)`` and the port's ``make_train_step``,
both with AdamW, the four LR groups and the clip at 0.1. Tolerances:

- losses and each term: 1e-5 relative (the forward agrees to 1e-7);
- the clip norm (the norm over trainable gradients, which is what the port
  reports as grad_norm; JAX's reported grad_norm also counts the FrozenBN
  leaves of layer2-4, buffers in the port): 1e-4 relative;
- each gradient leaf: 1e-4 of the leaf's largest magnitude plus 1e-6 of
  the largest gradient of the model (gradients that are zero in exact
  arithmetic, such as a key bias's, come out at rounding level);
- the updated parameters: 1e-6 absolute where the clipped gradient is
  above 100 Adam eps (Adam's first step is lr * g / (|g| + eps), so below
  that it follows rounding noise in g), elsewhere 2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import LossConfig as JaxLossConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import TrainConfig as JaxTrainConfig
from reftr_tpu.models import criterion as jax_criterion
from reftr_tpu.models.reftr import RefTR as JaxRefTR
from reftr_tpu.train import schedules as jax_schedules
from reftr_tpu.train.optimizer import build_optimizer, label_fn
from reftr_tpu.train.state import TrainState as JaxTrainState
from reftr_tpu.train.steps import make_train_step as jax_train_step
from reftr_torch.convert import build_model, flax_leaf_to_torch, from_flax
from reftr_torch.core.config import (BertConfig, LossConfig, ModelConfig,
                                     TrainConfig)
from reftr_torch.models import criterion as port_criterion
from reftr_torch.models.reftr import RefTR
from reftr_torch.train import schedules
from reftr_torch.train.engine import train_one_epoch
from reftr_torch.train.optimizer import clip_by_global_norm, param_label
from reftr_torch.train.state import TrainState
from reftr_torch.train.steps import make_eval_step, make_train_step
from test_torch_model import tiny_batch
from torch_parity_utils import random_flax_params, t

torch.set_num_threads(1)
TINY = dict(enc_layers=2, dec_layers=2, dim_feedforward=64, hidden_dim=64,
            nheads=4, aux_loss=True)
CLIP = 0.1
ADAM_EPS = 1e-8


def configs(dropout=0.0, **model):
    jb, pb = JaxBertConfig.tiny(), BertConfig.tiny()
    for c in (jb, pb):
        c.hidden_dropout = c.attention_dropout = dropout
    return (JaxModelConfig(bert=jb, dropout=dropout, **TINY, **model),
            ModelConfig(bert=pb, dropout=dropout, **TINY, **model))


def tiny_targets():
    return {"boxes": np.array([[[0.4, 0.5, 0.3, 0.2]], [[0.6, 0.4, 0.5, 0.3]]],
                              np.float32),
            "box_valid": np.ones((2, 1), bool)}


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step's results from random weights: (params, new params,
    metrics, clip norm, masked gradients)."""
    jcfg, _ = configs()
    model = JaxRefTR(jcfg)
    batch, targets = tiny_batch(), tiny_targets()
    params = random_flax_params(model, batch)
    tc = JaxTrainConfig(epochs=1)
    tx = build_optimizer(jcfg, tc, jax_schedules.build_schedule(tc, 1))
    wd = jax_criterion.weight_dict(JaxLossConfig(), jcfg.dec_layers,
                                   jcfg.aux_loss)
    state = JaxTrainState.create(params, tx, jax.random.PRNGKey(1))
    step = jax_train_step(model, wd, JaxLossConfig(), donate=False)
    new_state, metrics = step(state, batch, targets)

    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        out = model.apply({"params": p}, jbatch, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_criterion.total_loss(
            jax_criterion.criterion(out, targets, JaxLossConfig()), wd)

    grads = jax.jit(jax.grad(loss_fn))(params)
    labels = label_fn(jcfg, tc)(params)
    masked = jax.tree_util.tree_map(lambda g, lab: g * (lab != "frozen"),
                                    grads, labels)
    return {"params": params,
            "new_params": jax.device_get(new_state.params),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "clip_norm": float(optax.global_norm(masked)),
            "grads": flatten_dict(jax.device_get(masked))}


@pytest.fixture(scope="module")
def port_step(jax_step):
    _, pcfg = configs()
    state = TrainState.create(pcfg, TrainConfig(epochs=1), 1, device="cpu",
                              state_dict=from_flax(jax_step["params"], pcfg))
    wd = port_criterion.weight_dict(LossConfig(), pcfg.dec_layers,
                                    pcfg.aux_loss)
    step = make_train_step(state.model, wd, LossConfig(), device="cpu")
    state, metrics = step(state, tiny_batch(), tiny_targets())
    return state, metrics.get()


def test_train_step_losses_and_clip_norm_match_jax(jax_step, port_step):
    _, got = port_step
    want = jax_step["metrics"]
    for key in ("loss", "loss_bbox", "loss_giou", "loss_bbox_0",
                "loss_giou_0"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], jax_step["clip_norm"],
                               rtol=1e-4)
    assert got["lr"] == pytest.approx(1e-4)


def test_train_step_gradients_match_jax_per_leaf(jax_step, port_step):
    state, _ = port_step
    coef = CLIP / max(jax_step["clip_norm"], CLIP)
    named = dict(state.model.named_parameters())
    gmax = coef * max(np.abs(g).max() for g in jax_step["grads"].values())
    compared = 0
    for path, g in jax_step["grads"].items():
        name, want = flax_leaf_to_torch(path, np.asarray(g) * coef)
        if name not in named:  # FrozenBN statistics: buffers in the port
            assert path[-1] in ("weight", "bias", "running_mean",
                                "running_var")
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


def test_train_step_updated_params_match_jax(jax_step, port_step):
    state, _ = port_step
    _, pcfg = configs()
    want = from_flax(jax_step["new_params"], pcfg)
    coef = CLIP / max(jax_step["clip_norm"], CLIP)
    grads = dict(flax_leaf_to_torch(p, np.abs(np.asarray(g)) * coef)
                 for p, g in jax_step["grads"].items())
    lr = TrainConfig().lr
    for name, got in state.model.state_dict().items():
        err = np.abs(got.numpy() - want[name].numpy())
        if name in grads:
            big = grads[name] > 100 * ADAM_EPS
            assert (err[big] <= 1e-6).all(), name
            assert err.max() <= 2 * lr, name
        else:
            assert err.max() == 0.0, name


def test_criterion_and_weight_dict_match_jax():
    rng = np.random.default_rng(0)
    b, p, k, layers = 3, 2, 1, 4
    pred = rng.uniform(0.2, 0.8, (layers, b, p, k, 4)).astype(np.float32)
    mask = np.array([[True, True], [True, False], [False, True]])
    boxes = rng.uniform(0.2, 0.8, (b, p, 4)).astype(np.float32)
    targets = {"boxes": boxes, "box_valid": mask}
    out = {"pred_boxes": pred[-1], "phrase_mask": mask,
           "aux_outputs": [{"pred_boxes": pred[i], "phrase_mask": mask}
                           for i in range(layers - 1)]}
    want = jax_criterion.criterion(out, targets, JaxLossConfig())
    got = port_criterion.criterion(
        {"pred_boxes": t(pred[-1]), "phrase_mask": t(mask),
         "aux_outputs": [{"pred_boxes": t(pred[i]), "phrase_mask": t(mask)}
                         for i in range(layers - 1)]},
        {k: t(v) for k, v in targets.items()}, LossConfig())
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=1e-6)
    jwd = jax_criterion.weight_dict(JaxLossConfig(giou_loss_coef=2.0),
                                    layers, True)
    pwd = port_criterion.weight_dict(LossConfig(giou_loss_coef=2.0), layers,
                                     True)
    assert pwd == jwd
    np.testing.assert_allclose(
        port_criterion.total_loss(got, pwd).item(),
        float(jax_criterion.total_loss(want, jwd)), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="StepLR", lr_drop=3),
    dict(lr_schedule="MultiStepWarmupLR", lr_drop_epochs=(4, 7),
         warm_up_epoch=2),
    dict(lr_schedule="CosineWarmupLR", epochs=10, warm_up_epoch=2),
])
def test_schedules_match_jax(kw):
    steps_per_epoch = 5
    want = jax_schedules.build_schedule(JaxTrainConfig(**kw), steps_per_epoch)
    got = schedules.build_schedule(TrainConfig(**kw), steps_per_epoch)
    for step in range(0, 60):
        # JAX evaluates the schedule in float32
        np.testing.assert_allclose(got(step), float(want(jnp.float32(step))),
                                   rtol=1e-5)


@pytest.mark.parametrize("change", [
    {}, {"lr_backbone": 0.0}, {"freeze_bert": True},
    {"freeze_backbone": True}])
def test_param_groups_match_label_fn(change):
    train_kw = {k: v for k, v in change.items() if k == "lr_backbone"}
    model_kw = {k: v for k, v in change.items() if k != "lr_backbone"}
    jcfg, pcfg = configs(**model_kw)
    params = random_flax_params(JaxRefTR(jcfg), tiny_batch())
    labels = flatten_dict(label_fn(jcfg, JaxTrainConfig(**train_kw))(params))
    leaves = flatten_dict(params)
    port = {n for n, _ in RefTR(pcfg).named_parameters()}
    seen = set()
    for path, label in labels.items():
        name, _ = flax_leaf_to_torch(path, np.asarray(leaves[path]))
        if name not in port:  # FrozenBN statistics
            assert label == "frozen"
            continue
        assert param_label(name, pcfg, TrainConfig(**train_kw)) == label, name
        seen.add(name)
    assert seen == port


@pytest.mark.parametrize("sgd", [False, True])
def test_optimizer_and_clip_updates_match_optax(sgd):
    """Three clipped updates of two tensors: torch AdamW or SGD with
    momentum against optax.adamw or add_decayed_weights + sgd after
    optax.clip_by_global_norm."""
    rng = np.random.default_rng(3)
    params = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * scale
              for p in params] for scale in (1.0, 0.01, 3.0)]
    lr, wd, clip = 1e-2, 1e-4, 0.5
    tx = optax.chain(
        optax.clip_by_global_norm(clip),
        optax.chain(optax.add_decayed_weights(wd),
                    optax.sgd(lr, momentum=0.9)) if sgd else
        optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(t(p.copy())) for p in params]
    opt = (torch.optim.SGD(tp, lr=lr, momentum=0.9, weight_decay=wd) if sgd
           else torch.optim.AdamW(tp, lr=lr, eps=1e-8, weight_decay=wd))
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = t(x.copy())
        norm = clip_by_global_norm(tp, clip)
        np.testing.assert_allclose(
            norm.item(), float(optax.global_norm([jnp.asarray(x) for x in g])),
            rtol=1e-6)
        opt.step()
        for p, want in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)


def test_backbone_at_lr_zero_gets_gradients_and_no_update():
    """lr_backbone=0 labels the backbone frozen: it keeps its gradient, as
    in the JAX step, and stays out of the optimizer and the clip. Two
    steps: at init the box head's last layer is zero, so the first step's
    gradient stops there."""
    _, pcfg = configs()
    torch.manual_seed(0)
    state = TrainState.create(pcfg, TrainConfig(epochs=1, lr_backbone=0.0),
                              2, device="cpu")
    backbone = {n: p for n, p in state.model.named_parameters()
                if n.startswith("img_backbone.") and p.requires_grad}
    assert backbone and not any(param_label(n, pcfg, TrainConfig(
        lr_backbone=0.0)) != "frozen" for n in backbone)
    assert not {id(p) for p in backbone.values()} & {
        id(p) for p in state.trainable()}
    before = {n: p.detach().clone() for n, p in backbone.items()}
    wd = port_criterion.weight_dict(LossConfig(), pcfg.dec_layers, True)
    step = make_train_step(state.model, wd, LossConfig(), device="cpu")
    for _ in range(2):
        state, metrics = step(state, tiny_batch(), tiny_targets())
    assert all(torch.equal(p, before[n]) for n, p in backbone.items())
    assert any(p.grad is not None and p.grad.abs().max() > 0
               for p in backbone.values())
    assert np.isfinite(metrics.get()["grad_norm"])


def test_train_entry_points_run_on_cuda_unless_asked(monkeypatch):
    _, pcfg = configs()
    wd = port_criterion.weight_dict(LossConfig(), pcfg.dec_layers, True)
    model = build_model(pcfg, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainState.create(pcfg, TrainConfig(epochs=1), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(model, wd, LossConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(model, LossConfig())
    # a model that lies elsewhere than the step's device is refused
    with pytest.raises(ValueError, match="the model is on cpu"):
        make_train_step(model, wd, LossConfig(), device="meta")
    with pytest.raises(ValueError, match="the model is on cpu"):
        make_eval_step(model, LossConfig(), device="meta")


def test_frozen_modules_keep_no_graph():
    _, pcfg = configs(freeze_bert=True)
    model = RefTR(pcfg).train()
    frozen = [model.img_backbone.conv1, model.img_backbone.layer1,
              model.lang_backbone]
    assert not any(p.requires_grad for m in frozen for p in m.parameters())
    assert all(p.requires_grad for p in model.img_backbone.layer2.parameters())
    batch = {k: t(v) for k, v in tiny_batch().items()}
    out = model(batch)
    out["pred_boxes"].sum().backward()
    assert all(p.grad is None for m in frozen for p in m.parameters())
    assert model.img_backbone.layer2[0].conv1.weight.grad is not None


def _run_epoch(seed, steps=3, dropout=0.1):
    _, pcfg = configs(dropout=dropout)
    torch.manual_seed(0)
    state = TrainState.create(pcfg, TrainConfig(epochs=1, seed=seed), steps,
                              device="cpu", seed=0)
    wd = port_criterion.weight_dict(LossConfig(), pcfg.dec_layers, True)
    step = make_train_step(state.model, wd, LossConfig(), device="cpu")
    seen = []

    def traced(state, batch, targets):
        state, metrics = step(state, batch, targets)
        seen.append(metrics)
        return state, metrics

    loader = [(tiny_batch(), tiny_targets())] * steps
    lines = []
    state, stats = train_one_epoch(traced, state, loader, 0, print_freq=1,
                                   weight_dict=wd, print_fn=lines.append)
    return state, stats, [m.get() for m in seen], lines


def test_train_one_epoch_runs_three_steps_with_dropout():
    state, stats, per_step, lines = _run_epoch(seed=7)
    assert state.step == 3 and len(per_step) == 3
    for m in per_step:
        assert all(np.isfinite(v) for v in m.values())
    assert stats["loss"] == pytest.approx(
        np.mean([m["loss"] for m in per_step]))
    assert {"grad_norm", "lr", "loss_bbox", "loss_giou_0"} <= set(stats)
    assert any("Epoch: [0]" in line for line in lines)
    # the same seed gives the same losses; another seed other dropout masks
    _, _, again, _ = _run_epoch(seed=7)
    _, _, other, _ = _run_epoch(seed=8)
    assert [m["loss"] for m in again] == [m["loss"] for m in per_step]
    assert [m["loss"] for m in other] != [m["loss"] for m in per_step]


def test_eval_step_gives_losses_and_rec_sums(jax_step):
    _, pcfg = configs()
    model = build_model(pcfg, "cpu", from_flax(jax_step["params"], pcfg))
    out, losses, sums = make_eval_step(model, LossConfig(), device="cpu")(
        tiny_batch(), tiny_targets())
    assert not model.training
    assert out["pred_boxes"].shape == (2, 1, 1, 4)
    np.testing.assert_allclose(losses["loss_bbox"].item(),
                               jax_step["metrics"]["loss_bbox"], rtol=1e-5)
    assert sums["cnt"].item() == 2.0
    assert 0.0 <= sums["sum_iou"].item() <= 2.0
