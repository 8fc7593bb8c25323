"""reftr_torch in bfloat16 against reftr_tpu in bfloat16 (CPU): the serving
forward and one train step, the main path's dtype.

The tiny RefTR of test_torch_model.py and test_torch_train.py (bert tiny,
ResNet-50 at 64 px, 2+2 VL layers, d=64), with the same seeded weights
carried across by convert.from_flax and dropout 0. The serving forward
runs ModelConfig(dtype="bfloat16") on both sides: the port casts the
model to bf16 (``cast_to_compute_dtype``, as ``ServingModel`` does), Flax
casts f32 parameters to bf16 at each use. The train step is JAX's bf16
``make_train_step`` against the port's, which runs the forward under
``torch.autocast`` over f32 parameters.

The two sides round to bf16 at different places, by design: autocast keeps
LayerNorm, softmax and the losses in f32 where Flax rounds their outputs
to bf16, and the port's attention rounds its output once where JAX rounds
the softmax weights before p v. bf16 keeps 8 mantissa bits (relative
rounding 2^-9 = 2e-3), so each side's bf16 result sits some 1-2 % (rel
L2) from the exact, float32 one, and the two sides differ by about as
much. Each tolerance below is stated with its reason; where one would
depend on that rounding noise alone, the test holds the port to JAX's own
bf16 error (both measured against JAX in float32): the port may not lose
more accuracy than the reference does.
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
from reftr_torch.convert import flax_leaf_to_torch, from_flax
from reftr_torch.core.config import (BertConfig, LossConfig, ModelConfig,
                                     TrainConfig)
from reftr_torch.models import criterion as port_criterion
from reftr_torch.models.reftr import RefTR
from reftr_torch.train.state import TrainState
from reftr_torch.train.steps import make_train_step
from test_torch_model import TINY, tiny_batch
from test_torch_train import CLIP, tiny_targets
from torch_parity_utils import random_flax_params, t

torch.set_num_threads(1)
DTYPES = ("float32", "bfloat16")


def configs(dtype):
    jb, pb = JaxBertConfig.tiny(), BertConfig.tiny()
    for c in (jb, pb):
        c.hidden_dropout = c.attention_dropout = 0.0
    return (JaxModelConfig(bert=jb, dtype=dtype, dropout=0.0, **TINY),
            ModelConfig(bert=pb, dtype=dtype, dropout=0.0, **TINY))


def rel_l2(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def params():
    return random_flax_params(JaxRefTR(configs("float32")[0]), tiny_batch())


@pytest.fixture(scope="module")
def forwards(params):
    return run_forwards(params)


def run_forwards(params):
    """Boxes, encoder memory and decoder states of JAX's forward in float32
    and bf16 and of the port's bf16 serving forward, as float32 numpy."""
    batch = tiny_batch()
    out = {}
    for dtype in DTYPES:
        jcfg, _ = configs(dtype)
        got = JaxRefTR(jcfg).apply({"params": params}, batch,
                                   return_internals=True)
        out[("jax", dtype)] = {
            "boxes": np.asarray(got["pred_boxes"], np.float32),
            **{k: np.asarray(got["internals"][k], np.float32)
               for k in ("memory", "hs")}}
    _, pcfg = configs("bfloat16")
    port = RefTR(pcfg)
    port.load_state_dict(from_flax(params, pcfg))
    port.eval().cast_to_compute_dtype()
    with torch.no_grad():
        got = port({k: t(v) for k, v in batch.items()}, return_internals=True)
    out[("port", "bfloat16")] = {
        "boxes": got["pred_boxes"].float().numpy(),
        **{k: got["internals"][k].float().numpy() for k in ("memory", "hs")}}
    return out


def test_bf16_serving_forward_matches_jax(forwards):
    """Boxes within 1e-2 absolute (sigmoid outputs in [0, 1]; JAX's own
    bf16 boxes sit 3e-3 from its float32 ones); encoder memory and decoder
    states within 5e-2 relative L2, the card's bound for bf16 against
    float32 (chip_smoke.py MODEL_TOL_BF16_REL): bf16 rounding of every
    activation through some 80 layers."""
    port, jax_ = forwards[("port", "bfloat16")], forwards[("jax", "bfloat16")]
    assert port["boxes"].shape == jax_["boxes"].shape
    np.testing.assert_allclose(port["boxes"], jax_["boxes"], atol=1e-2,
                               rtol=0)
    for key in ("memory", "hs"):
        assert port[key].shape == jax_[key].shape
        assert rel_l2(port[key], jax_[key]) <= 5e-2, key


@pytest.mark.parametrize("key", ["boxes", "memory", "hs"])
def test_bf16_serving_forward_loses_no_more_than_jax(forwards, key):
    """Against JAX's float32 forward, the port's bf16 forward is at most
    1.5 times as far as JAX's own bf16 forward (relative L2): the port
    rounds to bf16 at no more places than the reference, so its bf16 path
    may not lose more accuracy; 1.5 leaves room for two independent
    roundings of the same size."""
    exact = forwards[("jax", "float32")][key]
    port = rel_l2(forwards[("port", "bfloat16")][key], exact)
    ref = rel_l2(forwards[("jax", "bfloat16")][key], exact)
    assert port <= 1.5 * ref, (port, ref)


def _jax_step(params, dtype):
    """JAX's train step in ``dtype``: metrics, new params, and the raw
    gradients of the trainable leaves with their clip norm."""
    jcfg, _ = configs(dtype)
    model = JaxRefTR(jcfg)
    batch, targets = tiny_batch(), tiny_targets()
    tc = JaxTrainConfig(epochs=1)
    tx = build_optimizer(jcfg, tc, jax_schedules.build_schedule(tc, 1))
    wd = jax_criterion.weight_dict(JaxLossConfig(), jcfg.dec_layers,
                                   jcfg.aux_loss)
    state = JaxTrainState.create(params, tx, jax.random.PRNGKey(1))
    new_state, metrics = jax_train_step(model, wd, JaxLossConfig(),
                                        donate=False)(state, batch, targets)
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
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "new_params": jax.device_get(new_state.params),
            "clip_norm": float(optax.global_norm(masked)),
            "grads": {flax_leaf_to_torch(p, np.asarray(g, np.float32))[0]:
                      flax_leaf_to_torch(p, np.asarray(g, np.float32))[1]
                      for p, g in flatten_dict(
                          jax.device_get(masked)).items()}}


@pytest.fixture(scope="module")
def steps(params):
    return run_steps(params)


def run_steps(params):
    """JAX's step in float32 and bf16, and the port's bf16 autocast step
    (its gradients unclipped by the step's own clip coefficient)."""
    out = {dtype: _jax_step(params, dtype) for dtype in DTYPES}
    _, pcfg = configs("bfloat16")
    state = TrainState.create(pcfg, TrainConfig(epochs=1), 1, device="cpu",
                              state_dict=from_flax(params, pcfg))
    wd = port_criterion.weight_dict(LossConfig(), pcfg.dec_layers,
                                    pcfg.aux_loss)
    step = make_train_step(state.model, wd, LossConfig(), device="cpu")
    state, metrics = step(state, tiny_batch(), tiny_targets())
    metrics = metrics.get()
    coef = CLIP / max(metrics["grad_norm"], CLIP)
    out["port"] = {
        "metrics": metrics,
        "state_dict": {k: v.clone() for k, v in
                       state.model.state_dict().items()},
        "grads": {n: p.grad.double().numpy() / coef
                  for n, p in state.model.named_parameters()
                  if p.grad is not None}}
    return out


def test_bf16_train_step_losses_and_clip_norm_match_jax(steps):
    """The loss and each term within 1e-2 relative: the forward's bf16
    rounding (JAX's bf16 loss is 1.3e-3 from its float32 loss). The clip
    norm: at most twice as far from JAX's float32 norm as JAX's own bf16
    norm is. In bf16 the gradients of the backbone's convolutions and of
    the query encoder move by rounding, by a quarter to a third for single
    conv weights, and the norm with them, by a few percent either way:
    here JAX's bf16 norm is 73.10 and the port's 78.28 against 75.19 in
    float32, and with hidden dropout on, JAX's bf16 norm came out at 79.6.
    The two bf16 norms part by the sum of two rounding errors of that
    size, so a fixed tolerance between them would measure that noise, not
    the port; twice the reference's own error bounds the port's."""
    got, want = steps["port"]["metrics"], steps["bfloat16"]["metrics"]
    for key in ("loss", "loss_bbox", "loss_giou", "loss_bbox_0",
                "loss_giou_0"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-2)
    exact = steps["float32"]["clip_norm"]
    port = abs(got["grad_norm"] - exact)
    ref = abs(steps["bfloat16"]["clip_norm"] - exact)
    assert port <= 2 * ref, (got["grad_norm"],
                             steps["bfloat16"]["clip_norm"], exact)


def _grad_gap(got: dict, want: dict) -> float:
    """Relative L2 distance of two gradient sets over the port's trainable
    tensors."""
    num = sum(float(((got[n] - want[n]) ** 2).sum()) for n in got)
    den = sum(float((np.asarray(want[n], np.float64) ** 2).sum())
              for n in got)
    return (num / den) ** 0.5


def test_bf16_train_step_gradients_match_jax(steps):
    """Every trainable tensor gets a gradient, and the port's bf16
    gradients are within twice JAX's own bf16 error of JAX's bf16 ones
    (relative L2 over all trainable tensors, both against JAX's float32
    gradients): two bf16 paths that each round as much as the reference
    differ by at most the sum of their errors."""
    port = steps["port"]["grads"]
    assert port and set(port) <= set(steps["bfloat16"]["grads"])
    ref_err = _grad_gap({n: steps["bfloat16"]["grads"][n] for n in port},
                        steps["float32"]["grads"])
    gap = _grad_gap(port, steps["bfloat16"]["grads"])
    assert gap <= 2 * ref_err, (gap, ref_err)
    assert _grad_gap(port, steps["float32"]["grads"]) <= 1.5 * ref_err


def test_bf16_train_step_updated_params_match_jax(steps):
    """AdamW's first step moves each parameter by lr * g / (|g| + eps),
    about lr times the sign of g, plus the decay: so every parameter is
    within 2 lr of JAX's, and within 1e-6 wherever the clipped JAX gradient
    is larger than the largest gap between the two clipped gradients,
    where the two signs must agree. Parameters outside the optimizer
    (frozen) and the FrozenBN statistics are unchanged on both sides."""
    _, pcfg = configs("bfloat16")
    want = from_flax(steps["bfloat16"]["new_params"], pcfg)
    lr = TrainConfig().lr
    coef = {side: CLIP / max(norm, CLIP) for side, norm in (
        ("port", steps["port"]["metrics"]["grad_norm"]),
        ("jax", steps["bfloat16"]["clip_norm"]))}
    g_port = {n: g * coef["port"] for n, g in steps["port"]["grads"].items()}
    g_jax = {n: steps["bfloat16"]["grads"][n] * coef["jax"] for n in g_port}
    margin = max(float(np.abs(g_port[n] - g_jax[n]).max()) for n in g_port)
    compared = 0
    for name, got in steps["port"]["state_dict"].items():
        err = np.abs(got.numpy() - want[name].numpy())
        assert err.max() <= 2 * lr, name
        if name in g_jax:
            sure = np.abs(g_jax[name]) > margin
            assert (err[sure] <= 1e-6).all(), name
            compared += int(sure.sum())
    assert compared > 0
