"""int8 RES: the port's int8 RefTRSeg (``masks`` with ``quantize_int8``,
bench.py's ``seg_int8``) against reftr_tpu's, on the CPU.

JAX's int8 RefTRSeg at the seg tests' micro width (bert tiny, ResNet-50 at
64 px, 2+2 VL layers, d=128 and 8 heads for GroupNorm's 8 groups; folded,
at JAX's default scope: backbone, bert, vl; the mask head stays float):
the calibration tree under RefTRSeg has JAX's names and values (to
tests/test_torch_quant.py's CALIB_RTOL), the port's rewrite equals JAX's
carried through ``convert.from_flax`` tensor for tensor, and the port's
int8 model on JAX's int8 params gives pred_boxes and pred_masks within
NOISE_SHARE (0.75) of JAX's own int8-against-fp distance, as
tests/test_torch_quant.py::test_micro_int8_model_matches_jax holds REC.
Then the entry point's ``--eval --quantize_int8 --fold_bn --masks`` at
JAX's bars against the fp eval (tests/test_quantize.py:211-213: the loss
within 5 %, mIoU within 0.03, which this test also asks of seg_miou), and
the int8 RES model served (``serve.serving_module(calib_batches=)``) and
exported, the exported program giving the live model's boxes and mask
logits.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import RefTRConfig as JaxRefTRConfig
from reftr_tpu.models.build import build_model as jax_build_model
from reftr_tpu.nn import quant as jax_quant
from reftr_torch.cli import main as cli
from reftr_torch.convert import build_model, from_flax, model_class
from reftr_torch.core.config import (BertConfig, DataConfig, ModelConfig,
                                     RefTRConfig)
from reftr_torch.nn import quant
from reftr_torch.serve import serving_module
from reftr_torch.tools import export_model
from test_torch_model import tiny_batch
from test_torch_quant import CALIB_RTOL, NOISE_SHARE, leaves
from torch_parity_utils import load_port, random_flax_params, t

torch.set_num_threads(1)
SEG8 = dict(enc_layers=2, dec_layers=2, dim_feedforward=64, hidden_dim=128,
            nheads=8, aux_loss=False, masks=True, fold_bn=True, dropout=0.0)
# the products of the micro RefTRSeg: ResNet-50's 52 bottleneck convs,
# BERT-tiny's 2 layers of 6 denses, the encoder's 2 of 6, the decoder's
# 2 of 10; the mask head's convolutions stay float
PRODUCTS = 52 + 2 * 6 + 2 * 6 + 2 * 10
# the entry point's RES eval: the smoke preset with --masks at d=128
RES_ARGV = ["--preset", "synthetic_smoke", "--masks", "--hidden_dim", "128",
            "--nheads", "8", "--device", "cpu", "--synthetic_n", "8",
            "--batch_size", "4", "--num_workers", "2", "--fold_bn", "--eval"]


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def seg8():
    """JAX's fp micro RefTRSeg and seeded params, its calib collection,
    its int8 params and outputs; the port's fp twin and calibration."""
    jb, pb = JaxBertConfig.tiny(), BertConfig.tiny()
    for c in (jb, pb):
        c.hidden_dropout = c.attention_dropout = 0.0
    jmc, pmc = JaxModelConfig(bert=jb, **SEG8), ModelConfig(bert=pb, **SEG8)
    batch = tiny_batch()
    jfp, _ = jax_build_model(JaxRefTRConfig(model=jmc))
    params = random_flax_params(jfp, batch)
    jcal, _ = jax_build_model(JaxRefTRConfig(model=dataclasses.replace(
        jmc, quant_calibrate=True)))
    out_fp, var = jax.jit(lambda p, b: jcal.apply(
        {"params": p}, b, mutable=["calib"]))(params, batch)
    calib = jax.device_get(var["calib"])
    qparams = jax_quant.quantize_params(params, calib,
                                        scope=jmc.quantize_scope)
    jq, _ = jax_build_model(JaxRefTRConfig(model=dataclasses.replace(
        jmc, quantize_int8=True)))
    out_q = jax.jit(lambda p, b: jq.apply({"params": p}, b))(qparams, batch)
    port_fp = load_port(model_class(pmc)(pmc), params).eval()
    pmc_q = dataclasses.replace(pmc, quantize_int8=True)
    cal = quant.Calibrator(port_fp, quant.quant_targets(model_class(pmc_q),
                                                        pmc_q))
    with cal.recording(), torch.no_grad():
        port_fp({k: t(v) for k, v in batch.items()})
    return {"pmc": pmc, "pmc_q": pmc_q, "batch": batch, "calib": calib,
            "qparams": qparams, "jax_fp": out_fp, "jax_q": out_q,
            "port_fp": port_fp, "port_calib": cal.tree()}


def test_seg_calibration_and_rewrite_match_jax(seg8):
    """The calibration tree under RefTRSeg: every product's leaf, named
    as JAX's, none of the mask head's; the port's rewrite of its fp
    weights on JAX's tree equals JAX's carried through from_flax, the
    mask head's weights float32 and untouched."""
    want, got = leaves(seg8["calib"]), leaves(seg8["port_calib"])
    assert set(got) == set(want) and len(got) == PRODUCTS
    assert not any(k.startswith(("mask_head", "bbox_attention"))
                   for k in got)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=CALIB_RTOL), k
    carried = from_flax(seg8["qparams"], seg8["pmc_q"])
    mine = quant.quantize_params(seg8["port_fp"].state_dict(),
                                 seg8["calib"], scope=seg8["pmc"].quantize_scope)
    assert set(mine) == set(carried)
    for k, v in carried.items():
        assert mine[k].dtype == v.dtype and torch.equal(mine[k], v), k
    heads = [k for k in mine if k.startswith("mask_head.")]
    assert heads and all(mine[k].dtype == torch.float32 for k in heads)
    assert all(torch.equal(mine[k], seg8["port_fp"].state_dict()[k])
               for k in heads)


def test_micro_int8_seg_model_matches_jax(seg8):
    """The port's int8 RefTRSeg on JAX's int8 params against JAX's int8
    RefTRSeg: boxes and mask logits within NOISE_SHARE of JAX's own int8
    noise (its int8 outputs against its fp ones), in float32."""
    port_q = build_model(seg8["pmc_q"], "cpu", from_flax(
        seg8["qparams"], seg8["pmc_q"])).eval()
    with torch.no_grad():
        got = port_q({k: t(v) for k, v in seg8["batch"].items()})
    for key in ("pred_boxes", "pred_masks"):
        want = f32(seg8["jax_q"][key])
        noise = float(np.abs(want - f32(seg8["jax_fp"][key])).max())
        g = got[key]
        assert g.dtype == torch.float32 and tuple(g.shape) == want.shape
        err = float(np.abs(g.numpy() - want).max())
        print(f"\nint8 RefTRSeg {key}: max |port - JAX| {err:.3g}, JAX's "
              f"int8 noise {noise:.3g}")
        assert np.isfinite(g.numpy()).all()
        assert 0 < noise and err <= NOISE_SHARE * noise, (key, err, noise)


def eval_stats(capsys, argv) -> dict:
    """The [val] line an eval run of the entry point prints."""
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("[val] ")][-1]
    return json.loads(line[len("[val] "):]), out


def test_eval_quantize_int8_res_through_the_entry_point(capsys, tmp_path):
    """``--eval --quantize_int8 --fold_bn --masks`` of the seeded init
    against the same ``--eval`` in fp: JAX's bars, the loss within 5 %
    and mIoU (box and mask) within 0.03."""
    fp, _ = eval_stats(capsys, RES_ARGV + ["--output_dir",
                                           str(tmp_path / "fp")])
    q, out = eval_stats(capsys, RES_ARGV + [
        "--quantize_int8", "--quant_calib_batches", "2", "--output_dir",
        str(tmp_path / "q")])
    assert "int8 PTQ: calibrated on 2 batches; quantizing backbone, bert, " \
           "vl" in out
    assert np.isfinite(q["loss"]) and np.isfinite(q["seg_miou"])
    assert abs(q["loss"] - fp["loss"]) / fp["loss"] < 0.05, (fp, q)
    for key in ("miou", "seg_miou"):
        assert abs(q[key] - fp[key]) < 0.03, (key, fp, q)


def test_int8_seg_serves_and_exports(tmp_path):
    """The int8 RES model of ``serving_module(calib_batches=)`` (the
    server's) and its export: the manifest's model has masks and int8,
    the program its int8 products, and the loaded program gives the live
    int8 model's boxes (--selfcheck's 1e-5) and mask logits (1e-5)."""
    cfg = RefTRConfig(
        model=ModelConfig(bert=BertConfig.tiny(), **dict(
            SEG8, enc_layers=1, dec_layers=1, quantize_int8=True)),
        data=DataConfig(img_size=64, max_img_size=64))
    spec = export_model.serving_batch_spec(cfg, 2)
    calib = [(export_model.random_batch(spec, seed=i), None)
             for i in range(2)]
    served = serving_module(cfg, "cpu", calib_batches=calib,
                            print_fn=lambda *a: None)
    model, _, manifest = export_model.export_with_config(
        cfg, "", str(tmp_path), 2, ("cpu",), calib_batches=calib,
        print_fn=lambda *a: None)
    assert manifest["model"]["masks"] and manifest["model"]["quantize_int8"]
    assert "reftr_torch.kernels.quant" in manifest["requires"]
    assert [o["dtype"] for o in manifest["outputs"]][:2] == ["float32"] * 2
    program = torch.export.load(str(tmp_path / export_model.ARTIFACT_NAME))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    # 52 convs, BERT-tiny's 2 layers of 6 denses, the encoder's 6, the
    # decoder's 10
    assert targets.count("reftr.int8_conv.default") == 52 + 12 + 6 + 10
    call, _ = export_model.load_exported(str(tmp_path))
    batch = {k: torch.from_numpy(v)
             for k, v in export_model.random_batch(spec, seed=5).items()}
    with torch.no_grad():
        got, live, server = call(batch), model(batch), served(batch)
    for key in ("pred_boxes", "pred_masks"):
        assert got[key].dtype == live[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), live[key].numpy(),
                                   atol=1e-5, rtol=0, err_msg=key)
        # the server's model: the same calibration, the same int8 model
        assert torch.equal(server[key], live[key]), key
