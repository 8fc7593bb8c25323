"""The serving export of the port (reftr_torch/tools/export_model.py), K1
as the registered op ``torch.ops.reftr.flash_attention_fwd``, and
``--exported`` serving, on the CPU against the live port model and
against reftr_tpu.

The cases of JAX's tests/test_export.py (roundtrip :65, multi-phrase :94,
masks :119, manifest :167) at its tiny_cfg widths (d=32, 2+2 VL layers,
BERT-tiny, 64 px; RES at d=128, 8 heads), exported with
``--export_platforms cpu`` from a reference ``.pth`` of seeded JAX weights
(``from_flax``, ``nn/convert.save_reference_checkpoint``). Tolerances: the
loaded program against the live port model 1e-6 on pred_boxes (1e-5 on
pred_masks), as JAX's against its live model: the same ATen calls run;
against the JAX model 1e-4, the model tolerance (PERF.md §2). The op
against JAX's fused_attention 1e-5 (float32, the sums in another order),
as tests/test_torch_attention.py.
"""

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import DataConfig as JaxDataConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import RefTRConfig as JaxRefTRConfig
from reftr_tpu.kernels.attention import _xla_attention, fused_attention
from reftr_tpu.models import build_model as jax_build_model
from reftr_tpu.tools import export_model as jax_export
from reftr_torch.cli.presets import preset_config
from reftr_torch.convert import from_flax
from reftr_torch.models.postprocess import segm_masks
from reftr_torch.core.config import (BertConfig, DataConfig, ModelConfig,
                                     RefTRConfig)
from reftr_torch.nn.attention import MultiHeadAttention
from reftr_torch.nn.convert import save_reference_checkpoint
from reftr_torch.serve import ServingModel
from reftr_torch.tools import export_model, serve
from test_torch_serve_http import call, requests
from torch_parity_utils import random_flax_params

torch.set_num_threads(1)
OP = torch.ops.reftr.flash_attention_fwd.default
ATOL = 1e-5
LIVE_TOL = {"pred_boxes": 1e-6, "pred_masks": 1e-5}
JAX_TOL = 1e-4
DATA = dict(img_size=64, max_img_size=64, max_query_len=12,
            max_sentence_len=16, max_num_phrases=4, phrase_seq_len=6)
MODEL = dict(backbone="resnet50", enc_layers=2, dec_layers=2,
             dim_feedforward=64, hidden_dim=32, nheads=4, aux_loss=False,
             dtype="float32")
CASES = {"rec": ({}, False), "multi": ({}, True),
         "masks": (dict(masks=True, nheads=8, hidden_dim=128), False)}


def configs(name):
    """(JAX config, port config) of tests/test_export.py::tiny_cfg."""
    model_kw, multi = CASES[name]
    kw = dict(MODEL, **model_kw)
    data = dict(DATA, multi_phrase=multi)
    return (JaxRefTRConfig(model=JaxModelConfig(bert=JaxBertConfig.tiny(),
                                                **kw),
                           data=JaxDataConfig(**data)),
            RefTRConfig(model=ModelConfig(bert=BertConfig.tiny(), **kw),
                        data=DataConfig(**data)))


def random_batch(spec, seed=0):
    """tests/test_export.py::random_batch on the port's spec."""
    rng = np.random.default_rng(seed)
    batch = {}
    for k, v in spec.items():
        if v.dtype == np.uint8:
            batch[k] = rng.integers(0, 255, size=v.shape).astype(np.uint8)
        elif v.dtype == np.bool_:
            batch[k] = np.ones(v.shape, bool)
        else:
            batch[k] = rng.integers(1, 90, size=v.shape).astype(v.dtype)
    sv = np.zeros(spec["sentence_valid"].shape, np.int32)
    sv[:, :7] = 1
    batch["sentence_valid"] = sv
    if "phrase_valid" in batch:
        pv = np.zeros(spec["phrase_valid"].shape, np.int32)
        pv[:, :, :2] = 1
        pv[:, :2, :5] = 1
        batch["phrase_valid"] = pv
        batch["phrase_pos_l"] = np.ones(spec["phrase_pos_l"].shape, np.int32)
        batch["phrase_pos_r"] = np.full(spec["phrase_pos_r"].shape, 4,
                                        np.int32)
    return batch


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_EXPORTS = {}


def export_case(name, tmp_path_factory):
    """A case's export from a .pth of seeded JAX weights, made once: the
    configs, the JAX model and params, the export's (model, program,
    manifest), the loaded program and manifest, and the artefact's
    directory."""
    if name in _EXPORTS:
        return _EXPORTS[name]
    jcfg, pcfg = configs(name)
    jax_model, _ = jax_build_model(jcfg)
    batch_size = 1 if name == "masks" else 2
    spec = export_model.serving_batch_spec(pcfg, batch_size)
    params = random_flax_params(jax_model, random_batch(spec), seed=3)
    root = tmp_path_factory.mktemp(f"export_{name}")
    pth = save_reference_checkpoint(str(root / "weights.pth"),
                                    from_flax(params, pcfg.model),
                                    pcfg.model)
    out = str(root / "exported")
    model, program, manifest = export_model.export_with_config(
        pcfg, resume=pth, out_dir=out, batch_size=batch_size,
        platforms=("cpu",), print_fn=lambda *a: None)
    call_, loaded = export_model.load_exported(out)
    _EXPORTS[name] = dict(name=name, jcfg=jcfg, pcfg=pcfg,
                          jax_model=jax_model, params=params, model=model,
                          program=program, manifest=manifest, call=call_,
                          loaded=loaded, out=out, spec=spec, pth=pth)
    return _EXPORTS[name]


@pytest.fixture(scope="module")
def rec_export(tmp_path_factory):
    return export_case("rec", tmp_path_factory)


def test_spec_is_jax_spec():
    for name in ("rec", "multi"):
        jcfg, pcfg = configs(name)
        got = export_model.serving_batch_spec(pcfg, 3)
        want = jax_export.serving_batch_spec(jcfg, 3)
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert got[k].dtype == np.dtype(want[k].dtype), k


def check_against_live_and_jax(exported):
    """Roundtrip (:65), multi-phrase with phrase_mask (:94), masks (:119):
    the loaded program against the live port model and against JAX."""
    batch = random_batch(exported["spec"])
    with torch.no_grad():
        got = exported["call"](tensors(batch))
        live = exported["model"](tensors(batch))
    want = jax.device_get(jax.jit(lambda b: exported["jax_model"].apply(
        {"params": exported["params"]}, b))(batch))
    keys = {"pred_boxes", "phrase_mask"} | (
        {"pred_masks"} if exported["name"] == "masks" else set())
    assert set(got) == keys
    for k in keys - {"phrase_mask"}:
        np.testing.assert_allclose(got[k].numpy(), live[k].numpy(),
                                   atol=LIVE_TOL[k], err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=JAX_TOL, err_msg=k)
    np.testing.assert_array_equal(got["phrase_mask"].numpy(),
                                  np.asarray(want["phrase_mask"]))


def check_graph(exported):
    """Every attention of the forward is one reftr.flash_attention_fwd
    node (BERT's twice in multi-phrase: over the sentence and over the
    phrases), every MultiHeadAttention module has one, and none of the
    plain attention's products or softmax run inside those modules."""
    graph = exported["program"].graph
    model = exported["model"]
    mha = {name for name, m in model.named_modules()
           if isinstance(m, MultiHeadAttention)}
    n_bert = sum(1 for name in mha if name.startswith("lang_backbone"))
    ops = [n for n in graph.nodes if n.target is OP]
    per_module = len(mha) + (n_bert if exported["name"] == "multi" else 0)
    assert len(ops) == per_module
    plain_ops = {"softmax", "_softmax", "logsumexp", "einsum", "bmm",
                 "matmul", "exp"}
    seen = set()
    for n in graph.nodes:
        stack = n.meta.get("nn_module_stack", {})
        inside = [path for path, cls in stack.values()
                  if cls is MultiHeadAttention
                  or getattr(cls, "__name__", str(cls)).endswith(
                      "MultiHeadAttention")]
        if not inside or n.op != "call_function":
            continue
        name = str(n.target).split(".")[1] if "." in str(n.target) else ""
        assert name not in plain_ops, (n.target, inside)
        if n.target is OP:
            seen.add(inside[-1])
    assert len(seen) == len(mha)


def check_manifest(exported):
    """Manifest (:167): JAX's keys, torch's version, the signature's
    inputs and outputs, the artefact's size, the op's module."""
    m = exported["loaded"]
    assert m == exported["manifest"]
    b = 1 if exported["name"] == "masks" else 2
    assert m["batch_size"] == b and m["platforms"] == ["cpu"]
    assert m["torch_version"] == torch.__version__
    assert m["format"] == "torch.export.save"
    assert m["requires"] == ["reftr_torch.kernels.attention"]
    assert m["artifact_bytes"] == os.path.getsize(
        os.path.join(exported["out"], export_model.ARTIFACT_NAME))
    n_params = sum(p.numel() for p in exported["model"].parameters())
    assert m["n_parameters"] == n_params
    # the weights are in the artefact (float32 here)
    assert m["artifact_bytes"] > 0.5 * 4 * n_params
    spec = exported["spec"]
    assert m["inputs"] == [{"shape": list(v.shape), "dtype": v.dtype.name}
                           for v in spec.values()]
    assert all(s["shape"][0] == b for s in m["outputs"])
    assert m["model"]["masks"] is (exported["name"] == "masks")
    assert m["resume"] == exported["pth"]
    with open(os.path.join(exported["out"], "manifest.json")) as f:
        assert json.load(f) == m


def test_loaded_program_needs_no_model_code(rec_export, tmp_path):
    """A fresh interpreter loads the artefact with torch, the manifest's
    ``requires`` and nothing else of the package, and gives the boxes of
    the live model."""
    import subprocess
    import sys

    exported = rec_export
    batch = random_batch(exported["spec"], seed=4)
    np.savez(tmp_path / "batch.npz", **batch)
    with torch.no_grad():
        want = exported["model"](tensors(batch))["pred_boxes"].numpy()
    script = f"""
import json, sys, numpy as np, torch
m = json.load(open({os.path.join(exported['out'], 'manifest.json')!r}))
for mod in m["requires"]:
    __import__(mod)
p = torch.export.load({os.path.join(exported['out'],
                                    export_model.ARTIFACT_NAME)!r}).module()
b = dict(np.load({str(tmp_path / 'batch.npz')!r}))
with torch.no_grad():
    out = p({{k: torch.from_numpy(v) for k, v in b.items()}})
np.save({str(tmp_path / 'out.npy')!r}, out["pred_boxes"].numpy())
loaded = sorted(k for k in sys.modules if k.startswith("reftr"))
print(json.dumps(loaded))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "reftr_torch.models.reftr" not in loaded
    assert not any(k.startswith("reftr_tpu") for k in loaded)
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want,
                               atol=LIVE_TOL["pred_boxes"])


def check_serving_model(exported):
    """--selfcheck's reading, and ServingModel(exported_dir=...) on the
    program: the manifest's batch size and masks, the live model's boxes
    and masks (serve.segm_masks)."""
    spec = exported["spec"]
    err = export_model.selfcheck(exported["call"], exported["model"], spec,
                                 torch.device("cpu"))
    assert err <= export_model.SELFCHECK_TOL
    sm = ServingModel(exported["pcfg"], 8, device="cpu",
                      exported_dir=exported["out"])
    assert sm.batch_size == spec["image"].shape[0]
    assert sm.masks is (exported["name"] == "masks")
    batch = random_batch(spec, seed=5)
    got = sm(batch)
    with torch.no_grad():
        live = exported["model"](tensors(batch))
    np.testing.assert_allclose(got["pred_boxes"], live["pred_boxes"].numpy(),
                               atol=LIVE_TOL["pred_boxes"])
    assert ("masks" in got) is sm.masks
    if sm.masks:
        want = segm_masks(live["pred_masks"][:, :1],
                          batch["image"].shape[1:3])[:, 0]
        np.testing.assert_array_equal(got["masks"], want.numpy())


@pytest.mark.parametrize("check", [check_against_live_and_jax, check_graph,
                                   check_manifest, check_serving_model])
def test_rec_export(rec_export, check):
    """The REC case: roundtrip (:65), the graph, manifest (:167),
    --selfcheck and ServingModel."""
    check(rec_export)


@pytest.mark.parametrize("platforms", ["tpu", "cpu,cuda", ("cpu", "tpu")])
def test_export_platforms_refuse_all_but_one_device(platforms):
    with pytest.raises(ValueError, match="tied to the device"):
        export_model.export_device(platforms)


def test_export_cli_quantize_int8(tmp_path, capsys):
    """--quantize_int8, refused before its slice: the command line exports
    the int8 program of the smoke preset's widths (folded, calibrated on
    JAX's synthetic batch), --selfcheck on. Its products are nodes of the
    int8 ops, one quantize before each, its manifest says int8 and names
    the ops' module, and it is under 0.8x the fp program's bytes (JAX's
    bar, tests/test_export.py:155-156)."""
    base = ["--preset", "synthetic_smoke", "--hidden_dim", "64",
            "--dim_feedforward", "64", "--export_batch", "2",
            "--export_platforms", "cpu", "--fold_bn"]
    fp, q = str(tmp_path / "fp"), str(tmp_path / "q")
    assert export_model.main(base + ["--out", fp]) == 0
    assert export_model.main(base + ["--out", q, "--quantize_int8",
                                     "--selfcheck"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(x.startswith("int8 PTQ: calibrated on 1 batches")
               for x in lines)
    assert any(x.startswith("selfcheck: max |exported - live|")
               for x in lines)
    manifest = export_model.read_manifest(q)
    assert manifest["model"]["quantize_int8"] is True
    assert "reftr_torch.kernels.quant" in manifest["requires"]
    assert (manifest["artifact_bytes"]
            < 0.8 * export_model.read_manifest(fp)["artifact_bytes"])
    program = torch.export.load(os.path.join(q, export_model.ARTIFACT_NAME))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    n_conv = targets.count("reftr.int8_conv.default")
    # 52 bottleneck convs, 6 denses a BERT and encoder layer, 10 a decoder
    # layer
    mc = preset_config("synthetic_smoke").model
    assert n_conv == (52 + 6 * (mc.bert.num_hidden_layers + mc.enc_layers)
                      + 10 * mc.dec_layers)
    assert targets.count("reftr.quantize_int8.default") == n_conv


def test_export_cli_refuses_tpu_and_cuda_without_card(tmp_path,
                                                      monkeypatch):
    out = str(tmp_path / "x")
    with pytest.raises(ValueError, match="tied to the device"):
        export_model.main(["--preset", "synthetic_smoke", "--out", out,
                           "--export_platforms", "tpu"])
    with pytest.raises(ValueError, match="disagree"):
        export_model.main(["--preset", "synthetic_smoke", "--out", out,
                           "--export_platforms", "cpu", "--device", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_model.main(["--preset", "synthetic_smoke", "--out", out])


def test_export_cli_with_selfcheck(tmp_path, capsys):
    """The command line on the smoke preset's widths, --selfcheck on."""
    out = str(tmp_path / "cli")
    argv = ["--preset", "synthetic_smoke", "--hidden_dim", "32",
            "--dim_feedforward", "64", "--out", out, "--export_batch", "2",
            "--export_platforms", "cpu", "--selfcheck"]
    assert export_model.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    head = json.loads(next(x for x in lines if x.startswith("{")))
    assert head["platforms"] == ["cpu"] and head["batch_size"] == 2
    assert any(x.startswith("selfcheck: max |exported - live|")
               for x in lines)


def test_served_exported_answers_as_live(rec_export):
    """build_server(exported_dir=...) on the CPU answers as the live server
    of the same .pth does (JAX's tests/test_serve.py:174): the manifest's
    batch size wins over --serve_batch, the same boxes to 1e-3 px (the
    JSON's 0.01); the synthetic fixture's vocabulary for both."""
    pcfg = rec_export["pcfg"]
    cfg = dataclasses.replace(
        pcfg, data=dataclasses.replace(pcfg.data, dataset="synthetic"),
        train=dataclasses.replace(pcfg.train, resume=rec_export["pth"]))
    answers = {}
    for label, kw in (("exported", dict(exported_dir=rec_export["out"])),
                      ("live", {})):
        srv, batcher = serve.build_server(cfg, port=0, serve_batch=8,
                                          device="cpu", **kw)
        assert batcher.model.batch_size == (2 if kw else 8)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            answers[label] = [call(base + "/predict", r)
                              for r in requests()]
            code, health = call(base + "/healthz", method="GET")
            assert code == 200 and health["masks"] is False
        finally:
            srv.shutdown()
            batcher.stop()
            srv.server_close()
            th.join(timeout=10)
    # the third request has 3 phrases, more than the exported batch of 2
    codes = [[c for c, _ in answers[k]] for k in ("exported", "live")]
    assert codes == [[200, 200, 500], [200, 200, 200]]
    for (_, b1), (_, b2) in zip(answers["exported"][:2],
                                answers["live"][:2]):
        for r1, r2 in zip(b1["results"], b2["results"]):
            assert r1["phrase"] == r2["phrase"]
            np.testing.assert_allclose(r1["box_xyxy"], r2["box_xyxy"],
                                       atol=1e-3)


def test_exported_for_another_device_is_refused(rec_export):
    with pytest.raises(ValueError, match="device it was traced on"):
        ServingModel(rec_export["pcfg"], 2, device="meta",
                     exported_dir=rec_export["out"])


# the op


def make_qkv(seed, b, sq, sk, h, d, masked_row=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    lens = rng.integers(1, sk + 1, size=b)
    lens[0] = max(1, (sk * 3) // 5)
    valid = np.arange(sk)[None, :] < lens[:, None]
    if masked_row:
        valid[-1] = False
    return q, k, v, valid


OP_CASES = {"no_mask_d24": ((2, 30, 45, 3, 24), False, False),
            "key_padding_d24": ((2, 30, 45, 3, 24), True, False),
            "masked_row_d24": ((3, 17, 40, 2, 24), True, True),
            "key_padding_d160": ((2, 9, 33, 2, 160), True, False),
            "masked_row_d160": ((3, 1, 20, 2, 160), True, True)}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_jax_fused_attention(case):
    """The op on CPU tensors (dropout 0) against JAX's fused_attention as
    its tests run it on the CPU (interpret mode); a row whose keys are all
    masked against JAX's eager path (the Pallas kernel averages its key
    padding there too, tests/test_torch_attention.py)."""
    shape, masked, masked_row = OP_CASES[case]
    q, k, v, valid = make_qkv(7, *shape, masked_row=masked_row)
    mask = valid if masked else None
    out, lse = OP(*(torch.from_numpy(x) for x in (q, k, v)),
                  None if mask is None else torch.from_numpy(mask), 0.0,
                  None, False)
    assert lse.shape == (0,) and lse.dtype == torch.float32
    if masked_row:
        bias = np.where(valid, 0.0, -1e9).astype(np.float32)
        want = np.asarray(_xla_attention(
            *(x.transpose(0, 2, 1, 3) for x in (q, k, v)), bias)
        ).transpose(0, 2, 1, 3)
    else:
        want = np.asarray(fused_attention(q, k, v, mask, interpret=True))
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)


FAKE_CASES = [
    (torch.float32, 24, True), (torch.float32, 24, False),
    (torch.bfloat16, 32, True), (torch.float64, 160, False),
    (torch.float32, 160, True),
]


@pytest.mark.parametrize("dtype,d,return_lse", FAKE_CASES)
@pytest.mark.parametrize("odd_strides", [False, True])
def test_fake_gives_the_cpu_implementations_outputs(dtype, d, return_lse,
                                                    odd_strides):
    """The fake's outputs have the shape, dtype and strides of the CPU
    implementation's, also for a one-query q whose size-1 dim has another
    stride (a slice of a longer q)."""
    q, k, v, valid = (torch.from_numpy(x) for x in make_qkv(1, 2, 5, 7, 2,
                                                             d))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    if odd_strides:
        q = q[:, 2:3]
        assert q.stride() != (q.shape[2] * d, q.shape[2] * d, d, 1)
    args = (q, k, v, valid, 0.0, None, return_lse)
    real = OP(*args)
    with FakeTensorMode() as mode:
        fake = OP(*(mode.from_tensor(x) if isinstance(x, torch.Tensor)
                    else x for x in args))
    for r, f in zip(real, fake):
        assert (r.shape, r.dtype, r.stride()) == (f.shape, f.dtype,
                                                  f.stride())


@pytest.mark.parametrize("rate,seed,return_lse", [(0.0, None, True),
                                                  (0.2, 11, False)])
def test_opcheck(rate, seed, return_lse):
    q, k, v, valid = (torch.from_numpy(x) for x in make_qkv(3, 2, 6, 9, 2,
                                                             24))
    torch.library.opcheck(OP, (q, k, v, valid, rate, seed, return_lse))
