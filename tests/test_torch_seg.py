"""reftr_torch RES (RefTRSeg, its heads, mask losses and seg metrics)
against reftr_tpu, on the CPU.

Sizes follow the JAX package's own seg tests: bert tiny, ResNet-50 at
64 px, 2+2 VL layers, hidden_dim=128 and nheads=8, so GroupNorm's 8 groups
divide both 2 * 128 + 8 = 264 and 128 / 16 = 8 channels (as 520 and 16 do
at full width). Inputs come from numpy seeds; the weights are seeded
random Flax trees carried over by ``convert.from_flax``. Tolerances, each
with its reason:

- single modules and losses in float32: 1e-5 (a few hundred terms summed
  in another order; the conv stacks' outputs are O(1));
- the bilinear resizes: 1e-5 absolute on O(1) inputs (both sides weight
  the same two or four neighbours; only the order of the products
  differs);
- the seg metrics: IoU sums within 1e-6 and the thresholded masks equal;
- the whole RefTRSeg forward: 1e-4 absolute on boxes, mask logits and
  attention maps (LayerNorm and accumulation order through some 80
  layers, as test_torch_model.py);
- one float32 train step: test_torch_train.py's tolerances;
- bf16: the port may be no further from JAX's float32 result than JAX's
  own bf16 result, times 1.5 (test_torch_bf16_parity.py's rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import LossConfig as JaxLossConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import TrainConfig as JaxTrainConfig
from reftr_tpu.models import criterion as jax_criterion
from reftr_tpu.models import postprocess as jax_post
from reftr_tpu.models.reftr_seg import RefTRSeg as JaxRefTRSeg
from reftr_tpu.nn import seg_heads as jax_heads
from reftr_tpu.ops import losses as jax_losses
from reftr_tpu.train import schedules as jax_schedules
from reftr_tpu.train.optimizer import build_optimizer, label_fn
from reftr_tpu.train.state import TrainState as JaxTrainState
from reftr_tpu.train.steps import make_train_step as jax_train_step
from reftr_torch.convert import (build_model, flax_leaf_to_torch, from_flax,
                                 init_params)
from reftr_torch.core.config import (BertConfig, LossConfig, ModelConfig,
                                     TrainConfig)
from reftr_torch.models import criterion as port_criterion
from reftr_torch.models import postprocess as port_post
from reftr_torch.models.reftr import RefTR
from reftr_torch.models.reftr_seg import FPN_DIMS, RefTRSeg
from reftr_torch.nn import seg_heads
from reftr_torch.ops import losses as port_losses
from reftr_torch.train.optimizer import param_label
from reftr_torch.train.state import TrainState
from reftr_torch.train.steps import make_eval_step, make_train_step
from test_torch_model import tiny_batch
from test_torch_train import ADAM_EPS, CLIP
from torch_parity_utils import close, load_port, random_flax_params, t

torch.set_num_threads(1)
TINY_SEG = dict(enc_layers=2, dec_layers=2, dim_feedforward=64,
                hidden_dim=128, nheads=8, aux_loss=True, masks=True)
ATOL = 1e-5
MODEL_ATOL = 1e-4


def configs(dtype="float32", **model):
    jb, pb = JaxBertConfig.tiny(), BertConfig.tiny()
    for c in (jb, pb):
        c.hidden_dropout = c.attention_dropout = 0.0
    kw = dict(TINY_SEG, dropout=0.0, dtype=dtype, **model)
    return JaxModelConfig(bert=jb, **kw), ModelConfig(bert=pb, **kw)


def seg_targets(seed=0, hw=64):
    rng = np.random.default_rng(seed)
    masks = np.zeros((2, hw, hw), np.float32)
    masks[0, 10:40, 5:30] = 1.0
    masks[1, 30:60, 20:56] = 1.0
    masks[1] *= rng.uniform(size=(hw, hw)) > 0.2
    return {"boxes": np.array([[[0.3, 0.4, 0.4, 0.5]],
                               [[0.6, 0.7, 0.5, 0.4]]], np.float32),
            "box_valid": np.ones((2, 1), bool), "masks": masks,
            "mask_valid": np.ones(2, bool)}


def rel_l2(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# losses and heads


@pytest.mark.parametrize("weighted", [False, True])
def test_dice_and_focal_losses_match_jax(weighted):
    """Over logits up to +-100 (the stable BCE form keeps them finite),
    with and without per-sample weights."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 3.0, (4, 50)).astype(np.float32)
    x[0, :5] = [100.0, -100.0, 40.0, -40.0, 0.0]
    x[1] = 60.0 * np.sign(x[1])
    tgt = (rng.uniform(size=(4, 50)) > 0.6).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32) if weighted else None
    tw = None if w is None else t(w)
    for alpha, gamma in ((0.25, 2.0), (-1.0, 2.0), (0.5, 1.0)):
        got = port_losses.sigmoid_focal_loss(t(x), t(tgt), 3.0, alpha,
                                             gamma, weights=tw)
        want = jax_losses.sigmoid_focal_loss(x, tgt, 3.0, alpha, gamma,
                                             weights=w)
        assert np.isfinite(got.item())
        np.testing.assert_allclose(got.item(), float(want), rtol=ATOL)
    got = port_losses.dice_loss(t(x), t(tgt), 3.0, weights=tw)
    want = jax_losses.dice_loss(x, tgt, 3.0, weights=w)
    np.testing.assert_allclose(got.item(), float(want), rtol=ATOL)


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (15, 28)),
                                          ((16, 16), (32, 32)),
                                          ((11, 13), (4, 5)),
                                          ((2, 3), (7, 7))])
def test_nearest_resize_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(1).normal(size=(2,) + in_hw + (3,)).astype(
        np.float32)
    want = np.asarray(jax_heads.nearest_resize(x, out_hw))
    got = seg_heads.nearest_resize(t(x).permute(0, 3, 1, 2), out_hw)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def _attention_inputs():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 3, 32)).astype(np.float32)
    k = rng.normal(size=(2, 5, 6, 32)).astype(np.float32)
    valid = np.ones((2, 5, 6), bool)
    valid[1, 3:, :] = False
    valid[0, :, 4:] = False
    return q, k, valid


def test_mh_attention_map_matches_jax():
    """The same weights and inputs; the map sums to 1 jointly over heads x
    pixels and masked pixels get ~0."""
    q, k, valid = _attention_inputs()
    jm = jax_heads.MHAttentionMap(hidden_dim=32, num_heads=4)
    params = random_flax_params(jm, q, k, valid)
    want = jm.apply({"params": params}, q, k, valid)
    port = load_port(seg_heads.MHAttentionMap(32, 4), params)
    with torch.no_grad():
        got = port(t(q), t(k), t(valid))
    assert tuple(got.shape) == (2, 3, 4, 5, 6)
    close(got, want, ATOL)
    w = got.numpy()
    np.testing.assert_allclose(w.reshape(2, 3, -1).sum(-1), 1.0, rtol=1e-5)
    assert w[1, :, :, 3:, :].max() < 1e-6 and w[0, :, :, :, 4:].max() < 1e-6


def test_mh_attention_map_bf16_logits_stay_float32():
    """Under bf16 autocast the projections run in bf16 but the logits and
    the joint softmax are float32, as JAX's preferred_element_type keeps
    them: the port's bf16 map (rounded to bf16 at the end, as JAX's) is
    no further from the float32 map than JAX's bf16 map is, times 1.5,
    and still sums to 1 within bf16's rounding of its entries."""
    q, k, valid = _attention_inputs()
    params = random_flax_params(
        jax_heads.MHAttentionMap(hidden_dim=32, num_heads=4), q, k, valid)
    exact = jax_heads.MHAttentionMap(32, 4).apply({"params": params}, q, k,
                                                  valid)
    jax16 = jax_heads.MHAttentionMap(32, 4, dtype=jnp.bfloat16).apply(
        {"params": params}, q, k, valid)
    port = load_port(seg_heads.MHAttentionMap(32, 4), params)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = port(t(q), t(k), t(valid))
    assert got.dtype == torch.bfloat16
    err = rel_l2(got.float().numpy(), exact)
    ref = rel_l2(np.asarray(jax16, np.float32), exact)
    assert err <= 1.5 * ref, (err, ref)
    sums = got.float().numpy().reshape(2, 3, -1).sum(-1)
    np.testing.assert_allclose(sums, 1.0, atol=2e-2)


@pytest.mark.parametrize("tiles", [1, 2])
def test_mask_head_matches_jax(tiles):
    """The FPN mask head on maps whose sizes are not multiples of each
    other (the nearest upsampling's floor indices), with the adapters'
    outputs tiled over ``tiles`` queries: logits and res_feat."""
    rng = np.random.default_rng(3)
    b, cd, nh = 2, 128, 8
    x = rng.normal(size=(b * tiles, 5, 6, 2 * cd + nh)).astype(np.float32)
    fpns = [rng.normal(size=(b, h, w, c)).astype(np.float32)
            for (h, w), c in zip(((9, 13), (20, 24), (37, 47)),
                                 FPN_DIMS)]
    jm = jax_heads.MaskHeadSmallConv(context_dim=cd)
    params = random_flax_params(jm, x, fpns)
    want_logits, want_feat = jm.apply({"params": params}, x, fpns)
    port = load_port(seg_heads.MaskHeadSmallConv(2 * cd + nh, FPN_DIMS, cd),
                     params)
    nchw = lambda a: t(a).permute(0, 3, 1, 2)  # noqa: E731
    with torch.no_grad():
        logits, feat = port(nchw(x), [nchw(f) for f in fpns])
    assert tuple(logits.shape) == (b * tiles, 1, 37, 47)
    assert tuple(feat.shape) == (b * tiles, cd // 16, 37, 47)
    close(logits.permute(0, 2, 3, 1), want_logits, ATOL)
    close(feat.permute(0, 2, 3, 1), want_feat, ATOL)


def test_cem_matches_jax():
    rng = np.random.default_rng(4)
    d = 64
    rec = rng.normal(size=(2, 1, 3, d)).astype(np.float32)
    res = rng.normal(size=(2, 5, 7, d // 16)).astype(np.float32)
    jm = jax_heads.CEM(hidden_dim=d)
    params = random_flax_params(jm, rec, res)
    want = jm.apply({"params": params}, rec, res)
    port = load_port(seg_heads.CEM(d), params)
    with torch.no_grad():
        got = port(t(rec), t(res))
    np.testing.assert_allclose(got.item(), float(want), rtol=ATOL)


@pytest.mark.parametrize("pred_hw", [(16, 16), (64, 64)])
def test_loss_masks_matches_jax(pred_hw):
    """Logits at 1/4 of the target (bilinear upsampling) and at its size,
    two queries sharing the target, one sample padded (mask_valid 0)."""
    rng = np.random.default_rng(5)
    pred = rng.normal(0.0, 2.0, (3, 2) + pred_hw).astype(np.float32)
    tgt = (rng.uniform(size=(3, 64, 64)) > 0.7).astype(np.float32)
    valid = np.array([True, False, True])
    want = jax_criterion.loss_masks(pred, tgt, valid, JaxLossConfig())
    got = port_criterion.loss_masks(t(pred), t(tgt), t(valid), LossConfig())
    assert set(got) == set(want) == {"loss_mask", "loss_dice"}
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=ATOL)


@pytest.mark.parametrize("in_hw,out_hw", [((160, 160), (640, 640)),
                                          ((16, 16), (64, 64)),
                                          ((16, 16), (40, 40)),
                                          ((7, 5), (64, 64))])
def test_bilinear_upsampling_matches_jax_image_resize(in_hw, out_hw):
    """F.interpolate(bilinear, align_corners=False, no antialias) against
    jax.image.resize "linear" and "bilinear" (the names loss_masks and
    segm_masks use), edges included: half-pixel centres on both sides,
    and JAX's renormalised edge weights equal torch's clamp at the
    border."""
    x = np.random.default_rng(6).normal(size=(2, 1) + in_hw).astype(
        np.float32)
    got = F.interpolate(t(x), size=out_hw, mode="bilinear",
                        align_corners=False, antialias=False).numpy()
    for method in ("linear", "bilinear"):
        want = np.asarray(jax.image.resize(x, (2, 1) + out_hw, method))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        for edge in (got[..., 0, :], got[..., -1, :], got[..., :, 0],
                     got[..., :, -1]):
            assert np.isfinite(edge).all()
        np.testing.assert_allclose(got[..., 0, :], want[..., 0, :],
                                   atol=ATOL)
        np.testing.assert_allclose(got[..., :, -1], want[..., :, -1],
                                   atol=ATOL)


def test_segm_metrics_and_masks_match_jax():
    """The same logits through both: the IoU sums within 1e-6 and the
    thresholded masks equal, with crops to ragged valid regions and a
    padded sample (mask_valid 0)."""
    rng = np.random.default_rng(7)
    logits = rng.normal(0.0, 3.0, (3, 1, 16, 16)).astype(np.float32)
    tgt = np.zeros((3, 64, 64), np.float32)
    tgt[0, 10:40, 5:50] = 1
    tgt[1, 20:64, 30:60] = 1
    tgt[2, :30, :30] = 1
    valid = np.zeros((3, 64, 64), bool)
    valid[0, :48] = True
    valid[1, :, :40] = True
    valid[2] = True
    mvalid = np.array([True, True, False])
    want = jax_post.segm_metrics(logits, tgt, valid, mask_valid=mvalid)
    got = port_post.segm_metrics(t(logits), t(tgt), t(valid),
                                 mask_valid=t(mvalid))
    for key in ("sum_seg_iou", "cnt_seg"):
        assert abs(got[key].item() - float(want[key])) <= 1e-6, key
    assert got["cnt_seg"].item() == 2.0
    for size in ((64, 64), (640, 640), (50, 70)):
        want_m = np.asarray(jax_post.segm_masks(logits, size))
        got_m = port_post.segm_masks(t(logits), size).numpy()
        assert got_m.dtype == bool
        np.testing.assert_array_equal(got_m, want_m)


def test_segm_metrics_upsample_in_float32_under_autocast():
    """Under bf16 autocast the upsampling and the sigmoid stay float32:
    the sums are those of the float32 path."""
    rng = np.random.default_rng(8)
    logits = t(rng.normal(0.0, 3.0, (2, 1, 16, 16)).astype(np.float32))
    tgt = t((rng.uniform(size=(2, 64, 64)) > 0.5).astype(np.float32))
    valid = torch.ones(2, 64, 64, dtype=torch.bool)
    want = port_post.segm_metrics(logits, tgt, valid)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = port_post.segm_metrics(logits, tgt, valid)
        masks = port_post.segm_masks(logits, (64, 64))
    assert got["sum_seg_iou"].item() == want["sum_seg_iou"].item()
    assert torch.equal(masks, port_post.segm_masks(logits, (64, 64)))


def test_criterion_and_weight_dict_with_masks_match_jax():
    rng = np.random.default_rng(9)
    out = {"pred_boxes": rng.uniform(0.2, 0.8, (2, 1, 1, 4)).astype(
               np.float32),
           "phrase_mask": np.ones((2, 1), bool),
           "pred_masks": rng.normal(size=(2, 1, 16, 16)).astype(np.float32),
           "cem_loss": np.float32(0.7)}
    targets = seg_targets()
    want = jax_criterion.criterion(out, targets, JaxLossConfig(),
                                   with_masks=True)
    got = port_criterion.criterion({k: t(np.asarray(v)) for k, v in
                                    out.items()},
                                   {k: t(v) for k, v in targets.items()},
                                   LossConfig(), with_masks=True)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=ATOL)
    for aux, layers in ((True, 6), (False, 2)):
        jwd = jax_criterion.weight_dict(JaxLossConfig(mask_loss_coef=2.0),
                                        layers, aux, with_masks=True)
        pwd = port_criterion.weight_dict(LossConfig(mask_loss_coef=2.0),
                                         layers, aux, with_masks=True)
        assert pwd == jwd
    assert "loss_mask_0" not in pwd and "loss_cem" in pwd


# ---------------------------------------------------------------------------
# the model


@pytest.fixture(scope="module")
def seg_params():
    jcfg, _ = configs(ablation="cem_loss")
    return random_flax_params(JaxRefTRSeg(jcfg), tiny_batch())


def test_converter_maps_every_seg_leaf(seg_params):
    """from_flax fills every tensor of RefTRSeg (with the CEM block) from
    every leaf, and raises on a leaf left unused or a tensor unfilled."""
    _, pcfg = configs(ablation="cem_loss")
    sd = from_flax(seg_params, pcfg)
    assert set(sd) == set(RefTRSeg(pcfg).state_dict())
    assert {k.split(".")[0] for k in sd} >= {"bbox_attention", "mask_head",
                                             "cem_block"}
    assert sd["mask_head.lay1.weight"].shape == (264, 264, 3, 3)
    assert sd["mask_head.adapter1.weight"].shape == (64, 1024, 1, 1)
    _, no_cem = configs()
    with pytest.raises(ValueError, match="left unused.*cem_block"):
        from_flax(seg_params, no_cem)
    trimmed = {k: v for k, v in seg_params.items() if k != "mask_head"}
    with pytest.raises(ValueError, match="unfilled.*mask_head"):
        from_flax(trimmed, pcfg)


def test_seg_forward_matches_jax(seg_params):
    """Boxes, mask logits (float32, 1/4 of the canvas), query 0's
    attention maps and the CEM loss at 1e-4."""
    jcfg, pcfg = configs(ablation="cem_loss")
    batch = tiny_batch()
    want = jax.jit(lambda p, b: JaxRefTRSeg(jcfg).apply({"params": p}, b))(
        seg_params, batch)
    port = RefTRSeg(pcfg)
    port.load_state_dict(from_flax(seg_params, pcfg))
    port.eval()
    with torch.no_grad():
        got = port({k: t(v) for k, v in batch.items()})
    assert "aux_outputs" not in got
    assert got["pred_masks"].dtype == torch.float32
    assert tuple(got["pred_masks"].shape) == (2, 1, 16, 16)
    for key in ("pred_boxes", "pred_masks", "mask_att"):
        assert tuple(got[key].shape) == want[key].shape, key
        close(got[key], want[key], MODEL_ATOL)
    np.testing.assert_allclose(got["cem_loss"].item(),
                               float(want["cem_loss"]), rtol=MODEL_ATOL)


def test_build_model_dispatches_on_masks():
    """masks selects RefTRSeg (reftr_tpu/models/build.py:55-64) with the
    mask head's kaiming-uniform init; the factory's head checks come with
    it, and freeze_reftr without masks is refused."""
    _, pcfg = configs()
    torch.manual_seed(0)
    model = build_model(pcfg, "cpu", seed=3)
    assert type(model) is RefTRSeg and not hasattr(model, "cem_block")
    conv = model.mask_head.lay2
    bound = (3.0 / conv.weight[0].numel()) ** 0.5
    assert conv.weight.abs().max() <= bound and not conv.bias.any()
    assert conv.weight.abs().max() > 0.9 * bound
    _, rec = configs(masks=False)
    assert type(build_model(rec, "cpu")) is RefTR
    with pytest.raises(ValueError, match="needs masks"):
        build_model(configs(masks=False, freeze_reftr=True)[1], "cpu")
    with pytest.raises(ValueError, match="heatmap_box is a REC head"):
        build_model(configs(heatmap_box=True, vision_aux=True)[1], "cpu")


def test_freeze_reftr_trains_the_mask_branch_alone():
    """freeze_reftr: only bbox_attention, mask_head and cem_block require a
    gradient, the trunk builds no graph, and the backward reaches the
    heads alone."""
    _, pcfg = configs(freeze_reftr=True, ablation="cem_loss")
    model = init_params(RefTRSeg(pcfg), torch.Generator().manual_seed(0))
    model.train()
    live = {n.split(".")[0] for n, p in model.named_parameters()
            if p.requires_grad}
    assert live == {"bbox_attention", "mask_head", "cem_block"}
    out = model({k: t(v) for k, v in tiny_batch().items()},
                return_internals=True)
    assert not out["pred_boxes"].requires_grad
    assert not out["internals"]["memory"].requires_grad
    assert not out["internals"]["hs"].requires_grad
    (out["pred_masks"].sum() + out["cem_loss"]).backward()
    for name, p in model.named_parameters():
        assert (p.grad is not None) == p.requires_grad, name


@pytest.mark.parametrize("change", [{}, {"freeze_reftr": True},
                                    {"freeze_reftr": True,
                                     "ablation": "cem_loss"}])
def test_seg_param_groups_match_label_fn(seg_params, change):
    """The port's labels are JAX's label_fn's on every parameter; under
    freeze_reftr cem_block stays at the base LR."""
    jcfg, pcfg = configs(**change)
    params = seg_params if pcfg.cem_loss else {
        k: v for k, v in seg_params.items() if k != "cem_block"}
    labels = flatten_dict(label_fn(jcfg, JaxTrainConfig())(params))
    leaves = flatten_dict(params)
    port = {n for n, _ in RefTRSeg(pcfg).named_parameters()}
    seen = set()
    for path, label in labels.items():
        name, _ = flax_leaf_to_torch(path, np.asarray(leaves[path]))
        if name not in port:  # FrozenBN statistics
            assert label == "frozen"
            continue
        assert param_label(name, pcfg, TrainConfig()) == label, name
        seen.add(name)
    assert seen == port
    if pcfg.freeze_reftr and pcfg.cem_loss:
        assert param_label("cem_block.c1.weight", pcfg,
                           TrainConfig()) == "base"


# ---------------------------------------------------------------------------
# one float32 train step against JAX

STEP_VARIANTS = {"cem_loss": dict(ablation="cem_loss"),
                 "freeze_reftr_cem_loss": dict(freeze_reftr=True,
                                               ablation="cem_loss")}


@pytest.fixture(scope="module", params=sorted(STEP_VARIANTS))
def seg_steps(request, seg_params):
    """JAX's RES train step and the port's from the same weights: JAX's
    metrics, new params, masked gradients and clip norm; the port's state
    and metrics."""
    model_kw = STEP_VARIANTS[request.param]
    jcfg, pcfg = configs(**model_kw)
    model = JaxRefTRSeg(jcfg)
    batch, targets = tiny_batch(), seg_targets()
    tc = JaxTrainConfig(epochs=1)
    tx = build_optimizer(jcfg, tc, jax_schedules.build_schedule(tc, 1))
    wd = jax_criterion.weight_dict(JaxLossConfig(), jcfg.dec_layers,
                                   jcfg.aux_loss, with_masks=True)
    state = JaxTrainState.create(seg_params, tx, jax.random.PRNGKey(1))
    new_state, metrics = jax_train_step(model, wd, JaxLossConfig(),
                                        with_masks=True, donate=False)(
        state, batch, targets)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        out = model.apply({"params": p}, jbatch, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_criterion.total_loss(jax_criterion.criterion(
            out, targets, JaxLossConfig(), with_masks=True), wd)

    grads = jax.jit(jax.grad(loss_fn))(seg_params)
    labels = label_fn(jcfg, tc)(seg_params)
    masked = jax.tree_util.tree_map(lambda g, lab: g * (lab != "frozen"),
                                    grads, labels)
    jax_side = {"new_params": jax.device_get(new_state.params),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "clip_norm": float(optax.global_norm(masked)),
                "grads": flatten_dict(jax.device_get(masked))}

    state = TrainState.create(pcfg, TrainConfig(epochs=1), 1, device="cpu",
                              state_dict=from_flax(seg_params, pcfg))
    pwd = port_criterion.weight_dict(LossConfig(), pcfg.dec_layers,
                                     pcfg.aux_loss, with_masks=True)
    step = make_train_step(state.model, pwd, LossConfig(), device="cpu")
    state, port_metrics = step(state, batch, targets)
    return pcfg, jax_side, state, port_metrics.get()


def test_seg_train_step_losses_and_clip_norm_match_jax(seg_steps):
    pcfg, want, _, got = seg_steps
    for key in ("loss", "loss_bbox", "loss_giou", "loss_mask", "loss_dice",
                "loss_cem"):
        np.testing.assert_allclose(got[key], want["metrics"][key],
                                   rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["clip_norm"],
                               rtol=1e-4)


def test_seg_train_step_gradients_match_jax_per_leaf(seg_steps):
    pcfg, want, state, _ = seg_steps
    coef = CLIP / max(want["clip_norm"], CLIP)
    named = dict(state.model.named_parameters())
    gmax = coef * max(np.abs(g).max() for g in want["grads"].values())
    compared = 0
    for path, g in want["grads"].items():
        name, w = flax_leaf_to_torch(path, np.asarray(g) * coef)
        if name not in named:  # FrozenBN statistics: buffers in the port
            assert not w.any()
            continue
        p = named[name]
        if p.grad is None:  # frozen: no gradient on either side
            assert not p.requires_grad and not w.any(), name
            continue
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-6 * gmax, name
        compared += 1
    assert compared == len(state.trainable())
    heads = {n.split(".")[0] for n in state.param_names()}
    if pcfg.freeze_reftr:
        assert heads == {"bbox_attention", "mask_head", "cem_block"}
    else:
        assert {"bbox_attention", "mask_head", "cem_block",
                "vl_transformer", "img_backbone"} <= heads


def test_seg_train_step_updated_params_match_jax(seg_steps):
    pcfg, want_side, state, _ = seg_steps
    want = from_flax(want_side["new_params"], pcfg)
    coef = CLIP / max(want_side["clip_norm"], CLIP)
    grads = dict(flax_leaf_to_torch(p, np.abs(np.asarray(g)) * coef)
                 for p, g in want_side["grads"].items())
    lr = TrainConfig().lr
    trainable = set(state.param_names())
    for name, got in state.model.state_dict().items():
        err = np.abs(got.numpy() - want[name].numpy())
        if name in trainable:
            big = grads[name] > 100 * ADAM_EPS
            assert (err[big] <= 1e-6).all(), name
            assert err.max() <= 2 * lr, name
        else:  # the frozen trunk keeps its bytes on both sides
            assert err.max() == 0.0, name


def test_seg_eval_step_gives_seg_sums(seg_params):
    jcfg, pcfg = configs(ablation="cem_loss")
    model = build_model(pcfg, "cpu", from_flax(seg_params, pcfg))
    batch, targets = tiny_batch(), seg_targets()
    targets["mask_valid"][1] = False
    step = make_eval_step(model, LossConfig(), device="cpu")
    out, losses, sums = step(batch, targets)
    want = jax_post.segm_metrics(
        np.asarray(out["pred_masks"]), targets["masks"],
        batch["image_valid"], mask_valid=targets["mask_valid"])
    assert sums["cnt_seg"].item() == 1.0
    assert abs(sums["sum_seg_iou"].item() - float(want["sum_seg_iou"])) \
        <= 1e-6
    assert {"loss_mask", "loss_dice", "loss_cem"} <= set(losses)


# ---------------------------------------------------------------------------
# bf16


def test_bf16_seg_forward_loses_no_more_than_jax(seg_params):
    """The port's bf16 serving forward (the model cast to bf16) against
    JAX's float32 forward is at most 1.5 times as far as JAX's own bf16
    forward (relative L2) on the boxes, the mask logits and the attention
    maps, and its boxes are within 1e-2 of JAX's bf16 boxes (sigmoid
    outputs)."""
    batch = tiny_batch()
    outs = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, _ = configs(dtype)
        got = jax.jit(lambda p, b: JaxRefTRSeg(jcfg).apply({"params": p}, b))(
            {k: v for k, v in seg_params.items() if k != "cem_block"}, batch)
        outs[dtype] = {k: np.asarray(got[k], np.float32)
                       for k in ("pred_boxes", "pred_masks", "mask_att")}
    _, pcfg = configs("bfloat16")
    port = RefTRSeg(pcfg)
    port.load_state_dict(from_flax(
        {k: v for k, v in seg_params.items() if k != "cem_block"}, pcfg))
    port.eval().cast_to_compute_dtype()
    with torch.no_grad():
        got = port({k: t(v) for k, v in batch.items()})
    assert got["pred_masks"].dtype == torch.float32
    np.testing.assert_allclose(got["pred_boxes"].numpy(),
                               outs["bfloat16"]["pred_boxes"], atol=1e-2)
    for key in ("pred_boxes", "pred_masks", "mask_att"):
        port_err = rel_l2(got[key].float().numpy(), outs["float32"][key])
        ref_err = rel_l2(outs["bfloat16"][key], outs["float32"][key])
        assert port_err <= 1.5 * ref_err, (key, port_err, ref_err)
