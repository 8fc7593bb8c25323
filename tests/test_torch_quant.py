"""reftr_torch's int8 post-training quantization (nn/quant.py,
kernels/quant.py) against reftr_tpu's (nn/quant.py), on the CPU, where the
products run their plain versions (exact integer sums, JAX's float32
epilogue).

Held bit for bit: QuantConv and QuantDense against JAX's on the same int8
params and inputs, in float32 and bf16 (XLA's CPU epilogue rounds each
step as the plain version does: no fused multiply-add); the weight and
input quantization (``quantize_*_kernel``); ``quantize_params`` against
JAX's rewrite carried through ``convert.from_flax``. Within 2e-6 relative:
the calibration tree against JAX's ``calib`` collection (the float32
forwards sum in other orders). The micro RefTR of tests/test_quantize.py:74
(BERT-base widths with 2 layers, 2 + 2 VL layers, fold_bn, every scope) on
JAX's quantized params: the decisions that flip at rounding level and the
decisions that differ in all counted and bounded, the boxes closer to
JAX's int8 ones than JAX's int8 boxes are to its fp ones. JAX's own bars for
int8 against fp (tests/test_quantize.py): backbone cosine > 0.995 and mean
relative error < 0.06, boxes within 0.05. Then the refusals, the eval-only
route and the train prefix through ``run_training``, and the ops.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import flatten_dict

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import RefTRConfig as JaxRefTRConfig
from reftr_tpu.models.build import build_model as jax_build_model
from reftr_tpu.nn import quant as jax_quant
from reftr_torch.convert import build_model, from_flax, model_class
from reftr_torch.core.config import (BertConfig, DataConfig, ModelConfig,
                                     RefTRConfig, TrainConfig)
from reftr_torch.kernels import quant as kquant
from reftr_torch.nn import quant
from reftr_torch.train.loop import run_training
from torch_parity_utils import load_port, random_flax_params, t

torch.set_num_threads(1)
SCOPE = ("backbone", "bert", "vl")
# the micro int8 model against JAX's: decisions whose inputs lie within
# ROUNDING_STEP quantization steps of JAX's count as flips at rounding
# level (inputs a few 1e-5 steps apart; 2 such flips measured)
ROUNDING_STEP = 1e-3
ROUNDING_FLIPS = 4
# and the share of all its quantize decisions that differ from JAX's: the
# consequences of those flips downstream (4487 of 2309120, 0.19 %,
# measured); a product run in float (its input not quantized) moves every
# later product's inputs by int8 noise (5.6 % measured with one layer3
# conv, or BERT's denses, in float)
DIFFER_SHARE = 0.01
# its boxes against JAX's int8 ones, as a share of JAX's own int8 noise on
# this model, its int8 boxes against its fp ones (0.54 measured; 1.01 with
# BERT's denses in float)
NOISE_SHARE = 0.75
# the calibration tree: each leaf is one activation's absmax through the
# float32 forward, whose sums run in other orders than XLA's (measured
# 1.4e-6 at layer4's last inputs, after 50 convolutions)
CALIB_RTOL = 2e-6


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


# (Cin, Cout, kernel, stride, dilation) of the backbone's conv kinds
CONVS = {"1x1": (64, 32, 1, 1, 1), "1x1_s2": (64, 48, 1, 2, 1),
         "3x3_s2": (32, 32, 3, 2, 1), "3x3_d2": (32, 16, 3, 1, 2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def port_conv_params(qp) -> dict:
    """JAX's QuantConv params in the port's buffers (from_flax's rule)."""
    kq = np.asarray(qp["kernel_q"])
    return {"kernel_q": torch.from_numpy(np.ascontiguousarray(
                kq.transpose(3, 0, 1, 2).reshape(kq.shape[3], -1))),
            "w_scale": t(f32(qp["w_scale"])),
            "in_scale": t(f32(qp["in_scale"]))}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(CONVS))
def test_quant_conv_matches_jax(kind, dtype):
    """Bit for bit: int32 sums are exact, the epilogue rounds as JAX's."""
    cin, cout, k, s, d = CONVS[kind]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    kernel = rng.normal(size=(k, k, cin, cout)).astype(np.float32) * 0.1
    qp = jax_quant.quantize_conv_kernel(kernel, float(np.abs(x).max()) * .7)
    jdt, tdt = DTYPES[dtype]
    pad = d * (k - 1) // 2
    want = jax_quant.QuantConv(
        cout, (k, k), strides=(s, s), padding=((pad, pad), (pad, pad)),
        kernel_dilation=(d, d), dtype=jdt).apply(
            {"params": qp}, jnp.asarray(x).astype(jdt))
    conv = quant.QuantConv(cin, cout, k, s, d)
    conv.load_state_dict(port_conv_params(qp))
    got = conv(t(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), f32(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("use_bias", [True, False])
def test_quant_dense_matches_jax(use_bias, dtype):
    """Bit for bit, the bias added after the float32 dequantization."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 40, 96)).astype(np.float32)
    kernel = rng.normal(size=(96, 192)).astype(np.float32) * 0.1
    bias = rng.normal(size=(192,)).astype(np.float32) * 0.05
    qp = jax_quant.quantize_dense_kernel(kernel, bias if use_bias else None,
                                         float(np.abs(x).max()))
    jdt, tdt = DTYPES[dtype]
    want = jax_quant.QuantDense(192, dtype=jdt, use_bias=use_bias).apply(
        {"params": qp}, jnp.asarray(x).astype(jdt))
    dense = quant.QuantDense(96, 192, use_bias)
    dense.load_state_dict({
        "kernel_q": t(np.ascontiguousarray(np.asarray(qp["kernel_q"]).T)),
        "w_scale": t(f32(qp["w_scale"])), "in_scale": t(f32(qp["in_scale"])),
        **({"bias": t(f32(qp["bias"]))} if use_bias else {})})
    got = dense(t(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), f32(want))


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_quantize_kernels_are_jax_bit_for_bit(kind):
    """int8 weights, weight scales and input scale equal JAX's, with a dead
    output channel (the 1e-12 floor) and weights on rounding halves."""
    rng = np.random.default_rng(2)
    if kind == "conv":
        k = rng.normal(size=(3, 3, 64, 32)).astype(np.float32)
        k[..., 5] = 0.0
        k[0, 0, 0, 7] = 127.0
        k[1, 1, 1, 7] = 2.5  # 2.5 on the grid of channel 7's scale 1.0
        want = jax_quant.quantize_conv_kernel(k, 3.21)
        got = quant.quantize_conv_kernel(t(k.transpose(3, 2, 0, 1)), 3.21)
        wk = np.asarray(want["kernel_q"]).transpose(3, 0, 1, 2).reshape(32,
                                                                        -1)
    else:
        k = rng.normal(size=(96, 40)).astype(np.float32)
        k[:, 3] = 0.0
        bias = rng.normal(size=(40,)).astype(np.float32)
        want = jax_quant.quantize_dense_kernel(k, bias, 0.0)
        got = quant.quantize_dense_kernel(t(k.T.copy()), t(bias), 0.0)
        wk = np.asarray(want["kernel_q"]).T
        np.testing.assert_array_equal(got["bias"].numpy(), want["bias"])
    assert got["kernel_q"].dtype == torch.int8
    np.testing.assert_array_equal(got["kernel_q"].numpy(), wk)
    np.testing.assert_array_equal(got["w_scale"].numpy(), want["w_scale"])
    assert got["in_scale"].dtype == torch.float32
    assert got["in_scale"].item() == float(want["in_scale"])


def test_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0, 126.6])
    got = kquant.quantize_int8(x, torch.tensor(1.0))
    assert got.tolist() == [0, 2, 2, 0, -2, 127, -127, 127]


# the micro RefTR of tests/test_quantize.py:74, at 64 px
MICRO = dict(fold_bn=True, aux_loss=False, enc_layers=2, dec_layers=2)


def micro_batch(seed: int = 0, b: int = 2, hw: int = 64, s: int = 12):
    rs = np.random.default_rng(seed)
    valid = np.ones((b, s), bool)
    valid[0, 9:] = False
    return {"image": rs.normal(size=(b, hw, hw, 3)).astype(np.float32),
            "image_valid": np.ones((b, hw, hw), bool),
            "sentence": rs.integers(1, 500, size=(b, s)).astype(np.int32),
            "sentence_valid": valid}


def tensors(batch):
    return {k: t(v) for k, v in batch.items()}


def jax_inputs(model, params, batch):
    """Apply a JAX model (jitted) recording each QuantConv's and
    QuantDense's input by its module path: (outputs, {path: [input,
    ...]})."""

    @jax.jit
    def run(p, b):
        seen = {}

        def record(next_fun, args, kwargs, context):
            mod = context.module
            if (isinstance(mod, (jax_quant.QuantConv, jax_quant.QuantDense))
                    and context.method_name == "__call__"):
                seen.setdefault("/".join(mod.scope.path), []).append(
                    args[0].astype(jnp.float32))
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(record):
            out = model.apply({"params": p}, b)
        return out, seen

    out, seen = jax.device_get(run(params, batch))
    return out, {tuple(k.split("/")): [f32(x) for x in v]
                 for k, v in seen.items()}


def module_path(name: str) -> tuple:
    """JAX's module path of the port's module ``name``."""
    path = quant.calib_path(name)
    return path[:-1] + (path[-1].removesuffix("_in"),)


def port_inputs(model, batch):
    """The port's counterpart: each QuantConv's and QuantDense's input (a
    conv's as NHWC) by JAX's module path."""
    seen, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, quant.QUANT_MODULES):
            path = module_path(name)

            def record(m, args, path=path):
                x = args[0]
                if isinstance(m, quant.QuantConv):
                    x = x.permute(0, 2, 3, 1)
                seen.setdefault(path, []).append(x.detach().numpy().copy())
            hooks.append(mod.register_forward_pre_hook(record))
    with torch.no_grad():
        out = model(tensors(batch))
    for h in hooks:
        h.remove()
    return out, seen


def decisions(x: np.ndarray, in_scale) -> np.ndarray:
    inv = np.float32(1.0) / np.float32(in_scale)
    return np.clip(np.round(x * inv), -127, 127)


@pytest.fixture(scope="module")
def micro():
    """JAX's fp micro model and seeded params, its calib collection and its
    int8 params; the port's fp twin on the same params and its own
    calibration tree."""
    jmc = JaxModelConfig(bert=dataclasses.replace(
        JaxBertConfig(), num_hidden_layers=2, vocab_size=500), **MICRO)
    pmc = ModelConfig(bert=dataclasses.replace(
        BertConfig(), num_hidden_layers=2, vocab_size=500), **MICRO)
    batch = micro_batch()
    jfp, _ = jax_build_model(JaxRefTRConfig(model=jmc))
    params = random_flax_params(jfp, batch)
    jcal, _ = jax_build_model(JaxRefTRConfig(model=dataclasses.replace(
        jmc, quant_calibrate=True)))
    out_fp, var = jax.jit(lambda p, b: jcal.apply(
        {"params": p}, b, mutable=["calib"]))(params, batch)
    calib = jax.device_get(var["calib"])
    qparams = jax_quant.quantize_params(params, calib, scope=SCOPE)
    port_fp = load_port(model_class(pmc)(pmc), params)
    pmc_q = dataclasses.replace(pmc, quantize_int8=True)
    cal = quant.Calibrator(port_fp, quant.quant_targets(model_class(pmc_q),
                                                        pmc_q))
    with cal.recording(), torch.no_grad():
        port_out_fp = port_fp(tensors(batch))
    return {"jmc": jmc, "pmc": pmc, "pmc_q": pmc_q, "batch": batch,
            "params": params, "calib": calib, "qparams": qparams,
            "jax_out_fp": out_fp, "port_fp": port_fp,
            "port_out_fp": port_out_fp, "port_calib": cal.tree()}


def leaves(tree):
    return {"/".join(k): float(np.asarray(v))
            for k, v in flatten_dict(tree).items()}


def test_calibration_tree_matches_jax(micro):
    """Every product of every scope has a leaf, named as JAX's; values to
    CALIB_RTOL (float32 forwards in other orders)."""
    want, got = leaves(micro["calib"]), leaves(micro["port_calib"])
    assert set(got) == set(want)
    assert len(got) == 52 + 2 * 6 + 2 * 6 + 2 * 10
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=CALIB_RTOL), k


def test_quantize_params_matches_jax_through_from_flax(micro):
    """The port's rewrite of its fp state_dict equals JAX's rewrite carried
    through from_flax, tensor for tensor, on JAX's calibration; the stem,
    BERT's pooler and the heads stay fp."""
    carried = from_flax(micro["qparams"], micro["pmc_q"])
    mine = quant.quantize_params(micro["port_fp"].state_dict(),
                                 micro["calib"], scope=SCOPE)
    assert set(mine) == set(carried)
    for k, v in carried.items():
        assert mine[k].dtype == v.dtype, k
        assert torch.equal(mine[k], v), k
    assert "img_backbone.conv1.weight" in mine
    assert "lang_backbone.pooler.weight" in mine
    assert "bbox_embed.layers.0.weight" in mine
    assert mine["img_backbone.layer3.5.conv2.kernel_q"].dtype == torch.int8


def test_micro_int8_model_matches_jax(micro):
    """The port's int8 model on JAX's int8 params against JAX's int8 model
    (jitted, as it serves).

    The float32 steps between the products (the stem, the dequantizing
    epilogues with the folded biases, LayerNorm, attention) round in other
    places than XLA's fused code, so the products see inputs a few 1e-5 of
    a quantization step apart; where one lies that close to a rounding
    boundary, a decision flips (ROUNDING_FLIPS bounds those at rounding
    level: inputs within ROUNDING_STEP of JAX's). Each flip moves a
    product's output by one weight times in_scale, and on these random
    weights later inputs then differ by up to a few steps, as int8 noise
    does: DIFFER_SHARE bounds the decisions that differ in all. The boxes
    are held to NOISE_SHARE of JAX's own int8 noise on this model (its int8
    boxes against its fp ones, itself within JAX's 0.05)."""
    jq, _ = jax_build_model(JaxRefTRConfig(model=dataclasses.replace(
        micro["jmc"], quantize_int8=True)))
    want, jin = jax_inputs(jq, micro["qparams"], micro["batch"])
    port_q = build_model(micro["pmc_q"], "cpu", from_flax(
        micro["qparams"], micro["pmc_q"])).eval()
    got, pin = port_inputs(port_q, micro["batch"])
    assert set(pin) == set(jin) and len(pin) == 96
    scales = {module_path(name): mod.in_scale.item()
              for name, mod in port_q.named_modules()
              if isinstance(mod, quant.QUANT_MODULES)}
    flips = at_rounding = total = 0
    for path, xs in pin.items():
        assert len(xs) == len(jin[path]) == 1
        xp, xj = xs[0], jin[path][0]
        a, b = decisions(xp, scales[path]), decisions(xj, scales[path])
        gap = float(np.abs(xp - xj).max()) / scales[path]
        n = int((a != b).sum())
        flips += n
        at_rounding += n if gap <= ROUNDING_STEP else 0
        total += a.size
    noise = float(np.abs(f32(want["pred_boxes"])
                         - f32(micro["jax_out_fp"]["pred_boxes"])).max())
    gb = got["pred_boxes"].numpy()
    err = float(np.abs(gb - f32(want["pred_boxes"])).max())
    print(f"\nint8 micro model: {at_rounding} quantize decisions flip at "
          f"rounding level, {flips} of {total} differ in all; pred_boxes "
          f"max |port - JAX| {err:.3g}, JAX's int8 noise {noise:.3g}")
    assert at_rounding <= ROUNDING_FLIPS
    assert flips <= DIFFER_SHARE * total
    assert np.isfinite(gb).all()
    assert err <= NOISE_SHARE * noise and noise <= 0.05


def test_port_int8_meets_jax_bars_against_fp(micro):
    """The port end to end (its own calibration through
    calibrate_and_quantize, its int8 model) against its fp model, at JAX's
    bars (tests/test_quantize.py:131-133, 169-175): backbone cosine >
    0.995, mean relative error < 0.06; boxes within 0.05."""
    cfg = RefTRConfig(model=micro["pmc"])
    qweights = quant.calibrate_and_quantize(
        cfg, micro["port_fp"], [(micro["batch"], None)], n_batches=1,
        print_fn=lambda *a: None)
    port_q = build_model(micro["pmc_q"], "cpu", qweights).eval()
    image = t(micro["batch"]["image"])
    with torch.no_grad():
        a = micro["port_fp"].run_backbone(image).numpy()
        b = port_q.run_backbone(image).numpy()
        boxes = port_q(tensors(micro["batch"]))["pred_boxes"].numpy()
    cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)
    rel = np.abs(a - b).mean() / (np.abs(a).mean() + 1e-9)
    assert cos > 0.995, cos
    assert rel < 0.06, rel
    fp_boxes = micro["port_out_fp"]["pred_boxes"].numpy()
    assert np.isfinite(boxes).all()
    assert np.abs(boxes - fp_boxes).max() < 0.05


def test_validate_calibration_rejects_bad_absmax():
    good = {"layer1": {"conv1_in": np.array(3.2, np.float32)}}
    quant.validate_calibration(good)
    for bad in (0.0, np.nan, np.inf, 1e9):
        tree = {"layer1": {"conv1_in": np.asarray(np.float32(bad))}}
        with pytest.raises(ValueError, match="invalid activation absmax"):
            jax_quant.validate_calibration(tree)
        with pytest.raises(ValueError, match="invalid activation absmax"):
            quant.validate_calibration(tree)


def test_calibration_drift_is_jax():
    calib = {"a": {"c_in": np.array(1.0, np.float32)},
             "b": {"c_in": np.array(4.0, np.float32)}}
    obs = {"a": {"c_in": np.array(2.5, np.float32)},
           "b": {"c_in": np.array(7.0, np.float32)}}
    assert quant.calibration_drift(calib, obs) == \
        jax_quant.calibration_drift(calib, obs) == [("['a']['c_in']", 1.0,
                                                     2.5)]


def test_train_prefix_matches_jax_and_is_frozen(micro):
    """calibrate_train_prefix: layer1's convs become the int8 of JAX's
    float-stored prefix carried through from_flax; the rest stays fp; no
    parameter is left in layer1; layer1's features stay within JAX's bar
    (cosine > 0.99) of the fp ones, and a step's gradients reach layer4."""
    pmc_p = dataclasses.replace(micro["pmc"], quantize_train_prefix=True)
    cfg = RefTRConfig(model=pmc_p)
    sd = quant.calibrate_train_prefix(cfg, micro["port_fp"],
                                      [(micro["batch"], None)], n_batches=1,
                                      print_fn=lambda *a: None)
    jparams = dict(micro["params"])
    jparams["img_backbone"] = jax_quant.quantize_backbone_params(
        micro["params"]["img_backbone"], micro["calib"]["img_backbone"],
        stages={1}, float_kernel=True)
    carried = from_flax(jparams, pmc_p)
    assert set(sd) == set(carried)
    for k, v in carried.items():
        if k.startswith("img_backbone.layer1.") and "in_scale" in k:
            assert v.item() == pytest.approx(sd[k].item(), rel=1e-6), k
        elif k.startswith("img_backbone.layer1."):
            assert torch.equal(sd[k], v), k
    model = build_model(pmc_p, "cpu", sd)
    assert not list(model.img_backbone.layer1.parameters())
    image = t(micro["batch"]["image"])
    with torch.no_grad():
        x = micro["port_fp"].img_backbone.stem(image)
        a = micro["port_fp"].img_backbone.run_stage(1, x).numpy()
        b = model.img_backbone.run_stage(1, x).numpy()
    cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.99, cos
    model.train()
    out = model.img_backbone(image)
    (out.float() ** 2).mean().backward()
    g = model.img_backbone.layer4[2].conv3.weight.grad
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("flags,match", [
    (dict(quantize_int8=True), "requires fold_bn"),
    (dict(quantize_train_prefix=True), "requires fold_bn"),
    (dict(quantize_train_prefix=True, fold_bn=True, train_stem=True),
     "train_stem"),
    (dict(quantize_train_prefix=True, fold_bn=True, quantize_int8=True),
     "mutually exclusive"),
    (dict(quantize_int8=True, backbone_norm="group"), "backbone_norm"),
])
def test_int8_configs_are_refused_as_jax(flags, match):
    """The JAX factory's refusals (reftr_tpu/models/build.py:25-44; int8
    without fold_bn is JAX's ResNet assertion and its run_training's
    error)."""
    with pytest.raises(ValueError, match=match):
        model_class(ModelConfig(**flags))
    if not (flags.get("quantize_int8") and len(flags) == 1):
        with pytest.raises(ValueError, match=match):
            jax_build_model(JaxRefTRConfig(model=JaxModelConfig(**flags)))


def test_an_int8_model_needs_its_quantized_weights():
    with pytest.raises(ValueError, match="calibrate"):
        build_model(ModelConfig(bert=BertConfig.tiny(), fold_bn=True,
                                quantize_int8=True), "cpu")


# the micro trainer of tests/test_torch_loop.py, folded
LOOP_MODEL = dict(enc_layers=1, dec_layers=1, dim_feedforward=32,
                  hidden_dim=32, nheads=4, aux_loss=False, dtype="float32",
                  fold_bn=True)
LOOP_DATA = dict(dataset="synthetic", train_split="train",
                 test_splits=("val",), img_size=32, max_img_size=32,
                 max_query_len=12, batch_size=8, num_workers=2,
                 synthetic_n=16)


def loop_config(out_dir, model=None, **train) -> RefTRConfig:
    return RefTRConfig(
        model=ModelConfig(bert=BertConfig.tiny(),
                          **dict(LOOP_MODEL, **(model or {}))),
        data=DataConfig(**LOOP_DATA),
        train=TrainConfig(**dict(dict(lr=1e-3, warm_up_epoch=1,
                                      lr_schedule="CosineWarmupLR", seed=0,
                                      epochs=1, output_dir=str(out_dir)),
                                 **train)))


@pytest.mark.parametrize("flags,train,match", [
    (dict(quantize_int8=True), {}, "serving/eval"),
    (dict(quantize_int8=True, fold_bn=False), dict(eval_only=True),
     "requires --fold_bn"),
])
def test_run_training_refuses_int8_as_jax(tmp_path, flags, train, match):
    """tests/test_quantize.py:227: training with --quantize_int8 raises
    JAX's error, and so does int8 eval without --fold_bn
    (reftr_tpu/train/loop.py:186-195)."""
    with pytest.raises(ValueError, match=match):
        run_training(loop_config(tmp_path, flags, **train), device="cpu")


def test_eval_quantize_int8_through_run_training(tmp_path, capsys):
    """--eval --quantize_int8 end to end (tests/test_quantize.py:199): one
    fp epoch, then its checkpoint evaluated fp and int8 (calibrated on the
    first val batches): the loss within 5 % and mIoU within 0.03."""
    run_training(loop_config(tmp_path / "train"), device="cpu")
    ckpt = str(tmp_path / "train" / "checkpoint")
    fp = run_training(loop_config(tmp_path / "fp", eval_only=True,
                                  resume=ckpt), device="cpu")["test"]["val"]
    q = run_training(loop_config(tmp_path / "q", dict(quantize_int8=True),
                                 eval_only=True, resume=ckpt,
                                 quant_calib_batches=2),
                     device="cpu")["test"]["val"]
    out = capsys.readouterr().out
    assert "int8 PTQ: calibrated on 2 batches" in out
    assert np.isfinite(q["loss"])
    assert abs(q["loss"] - fp["loss"]) / fp["loss"] < 0.05, (fp, q)
    assert abs(q["miou"] - fp["miou"]) < 0.03, (fp, q)


@pytest.fixture(scope="module")
def prefix_run(tmp_path_factory):
    """One --quantize_train_prefix --fold_bn epoch of the micro trainer,
    calibrated on its first train batch: (config, output directory,
    history, what it printed)."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("prefix")
    cfg = loop_config(out, dict(quantize_train_prefix=True),
                      quant_calib_batches=1)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        hist = run_training(cfg, device="cpu")["history"]
    return cfg, out, hist, printed.getvalue()


def test_train_prefix_through_run_training(prefix_run):
    """--quantize_train_prefix --fold_bn: calibrated on the first train
    batch, the run trains with layer1 in int8, its checkpoint holds the
    int8 layer1 and resumes."""
    _, out, hist, printed = prefix_run
    assert "int8 train-prefix: calibrated layer1 on 1 batches" in printed
    assert np.isfinite(hist[0]["train_loss"])
    payload = torch.load(out / "checkpoint", weights_only=False)
    assert payload["model"]["img_backbone.layer1.0.conv2.kernel_q"].dtype \
        == torch.int8
    assert "img_backbone.layer2.0.conv2.weight" in payload["model"]
    again = run_training(loop_config(out, dict(
        quantize_train_prefix=True), epochs=2, auto_resume=True),
        device="cpu")["history"]
    assert [h["epoch"] for h in again] == [1]


def test_export_serves_a_prefix_trained_checkpoint(prefix_run, tmp_path):
    """A --quantize_train_prefix run's checkpoint exported as
    ``export_model --quantize_train_prefix --resume`` exports it
    (``export_with_config``; JAX builds the prefix model and loads the
    checkpoint into it, reftr_tpu/tools/export_model.py:155-173): the live
    model holds the checkpoint's int8 layer1, the program its 10 int8
    products and the boxes of the live model (--selfcheck's 1e-5);
    without --resume it is refused."""
    from reftr_torch.core.checkpoint import load_checkpoint
    from reftr_torch.serve import serving_module
    from reftr_torch.tools import export_model

    cfg, out, _, _ = prefix_run
    ckpt = str(out / "checkpoint")
    model, _, manifest = export_model.export_with_config(
        cfg, ckpt, str(tmp_path), 2, ("cpu",), print_fn=lambda *a: None)
    assert "reftr_torch.kernels.quant" in manifest["requires"]
    call, _ = export_model.load_exported(str(tmp_path))
    program = torch.export.load(str(tmp_path / export_model.ARTIFACT_NAME))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("reftr.int8_conv.default") == 10
    spec = export_model.serving_batch_spec(cfg, 2)
    assert export_model.selfcheck(call, model, spec, torch.device("cpu")) \
        <= export_model.SELFCHECK_TOL
    saved = load_checkpoint(ckpt)["model"]
    for name, buf in model.img_backbone.layer1.named_buffers():
        if name.endswith(("kernel_q", "in_scale")):
            assert torch.equal(buf, saved[f"img_backbone.layer1.{name}"])
    with pytest.raises(ValueError, match="pass --resume"):
        serving_module(cfg, "cpu")


def test_int8_ops_fake_and_opcheck():
    """The ops' fake implementations give the CPU ones' shapes and dtypes
    (an exported program's), and opcheck passes."""
    rng = np.random.default_rng(3)
    x = t(rng.normal(size=(2, 7, 9, 64)).astype(np.float32))
    s = torch.tensor(0.05)
    xq = kquant.quantize_int8(x, s)
    w = torch.randint(-127, 128, (10, 9 * 64), dtype=torch.int8)
    ws, bias = torch.rand(10) * 0.01, torch.randn(10)
    args = (xq, w, ws, s, bias, 3, 2, 2, torch.bfloat16)
    for op, a in ((torch.ops.reftr.quantize_int8.default, (x, s)),
                  (torch.ops.reftr.int8_conv.default, args)):
        torch.library.opcheck(op, a)
    y = kquant.int8_conv(*args)
    assert y.shape == (2, 4, 5, 10) and y.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="w must be int8"):
        kquant.int8_conv(xq, w[:, :10], ws, s)


def test_int8_export_serves_as_the_live_model(tmp_path):
    """The int8 export on the CPU (export_with_config with calibration
    batches): ServingModel(exported_dir=), as ``serve --exported`` loads
    it, gives the live int8 model's boxes (JAX's --selfcheck limit, 1e-5)
    at the manifest's batch size. (Its bytes against the fp program's:
    tests/test_torch_export.py::test_export_cli_quantize_int8.)"""
    from reftr_torch.serve import ServingModel
    from reftr_torch.tools import export_model

    cfg = RefTRConfig(
        model=ModelConfig(bert=BertConfig.tiny(), enc_layers=1, dec_layers=1,
                          dim_feedforward=64, hidden_dim=64, nheads=4,
                          aux_loss=False, fold_bn=True, quantize_int8=True),
        data=DataConfig(img_size=64, max_img_size=64))
    spec = export_model.serving_batch_spec(cfg, 2)
    calib = [(export_model.random_batch(spec, seed=i), None)
             for i in range(2)]
    model, _, manifest = export_model.export_with_config(
        cfg, "", str(tmp_path), 2, ("cpu",), calib_batches=calib,
        print_fn=lambda *a: None)
    assert manifest["model"]["quantize_int8"] is True
    served = ServingModel(cfg, 8, device="cpu", exported_dir=str(tmp_path))
    assert served.batch_size == 2
    batch = export_model.random_batch(spec, seed=5)
    got = served(batch)["pred_boxes"]
    with torch.no_grad():
        want = model(tensors(batch))["pred_boxes"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
