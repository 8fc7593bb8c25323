"""The port's profiler tools and log/annotation converters on the CPU:
tools/op_profile.py, tools/conv_profile.py, train_one_epoch's
``profile_dir`` (``--profile_dir``), tools/vis_log.py and
tools/convert_annotations.py, each against reftr_tpu's where JAX's can run
here (the converters, the flag's config). Times from these runs are the
CPU's and are checked for sign and order only."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from reftr_tpu.cli import main as jax_main
from reftr_tpu.tools import convert_annotations as jax_convert
from reftr_torch.cli import main as cli
from reftr_torch.core.config import (BertConfig, LossConfig, ModelConfig,
                                     TrainConfig)
from reftr_torch.data import datasets, native
from reftr_torch.models.criterion import weight_dict
from reftr_torch.tools import conv_profile, convert_annotations, op_profile
from reftr_torch.tools import vis_log
from reftr_torch.train.engine import train_one_epoch
from reftr_torch.train.state import TrainState
from reftr_torch.train.steps import make_train_step

torch.set_num_threads(1)
# BERT-tiny's 2 layers, one encoder layer, the decoder's self- and
# cross-attention: the tiny mode's attention calls a forward
TINY_ATTENTIONS = 5


def test_op_profile_tiny_ranks_rows(capsys, tmp_path):
    rows = op_profile.profile("tiny", topk=6, steps=2, device="cpu",
                              trace_dir=str(tmp_path))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("mode=tiny  batch=2  host ops=")
    assert "self ms" in out[1] and "category" in out[1]
    assert len(out) == 2 + 6
    ms = [r["ms"] for r in rows]
    assert ms == sorted(ms, reverse=True) and ms[-1] > 0
    assert abs(sum(r["share"] for r in rows) - 1.0) < 1e-9
    (op,) = [r for r in rows if r["name"] == "reftr::flash_attention_fwd"]
    assert op["category"] == "flash_attention_fwd"
    assert op["calls"] == TINY_ATTENTIONS
    with open(tmp_path / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "reftr::flash_attention_fwd" in names


def test_op_profile_refuses_unknown_modes():
    with pytest.raises(ValueError, match="mode must be one of"):
        op_profile.profile("fast", device="cpu")


def test_op_profile_rec_int8_ranks_the_int8_ops(capsys, monkeypatch):
    """rec_int8, refused before its slice, on the CPU at the tiny mode's
    widths, folded: calibrated on its batch, the int8 model's ops rank
    among the rows, one quantize before each of its products (52
    bottleneck convs, BERT-tiny's 12 denses, the encoder layer's 6 and the
    decoder layer's 10)."""
    tiny = op_profile._config("tiny")
    monkeypatch.setattr(op_profile, "_config", lambda mode, unfolded=False:
                        dataclasses.replace(tiny, model=dataclasses.replace(
                            tiny.model, fold_bn=True, quantize_int8=True)))
    monkeypatch.setitem(op_profile.BATCH, "rec_int8", 2)
    rows = op_profile.profile("rec_int8", topk=40, steps=1, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("int8 PTQ: calibrated on 1 batches")
    assert out[1].startswith("mode=rec_int8  fold_bn fold_normalize  "
                             "quantize_int8  batch=2  host ops=")
    calls = {r["name"]: (r["calls"], r["category"]) for r in rows}
    assert calls["reftr::int8_conv"] == (52 + 12 + 6 + 10, "int8_conv")
    assert calls["reftr::quantize_int8"] == (80, "quantize_int8")


@pytest.mark.parametrize("name,category", [
    ("void flash_fwd_tc_kernel<64, true>(...)", "flash_attn_fwd_tc"),
    ("flash_fwd_dec_kernel<32>", "flash_attn_fwd_dec"),
    ("void flash_fwd_kernel<4, float>", "flash_attn_fwd"),
    ("flash_bwd_dkv_wg_kernel", "flash_attn_bwd_dkv_wg"),
    ("ncclDevKernel_AllReduce", "nccl"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "convolution"),
    ("nvjet_tst_128x64", "gemm"), ("aten::addmm", "gemm"),
    ("reftr::flash_attention_fwd", "flash_attention_fwd"),
    ("void int8_conv_kernel<__nv_bfloat16>(Params)", "int8_conv"),
    ("void int8_conv_wg_kernel<128, 256, __nv_bfloat16>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, Params)", "int8_conv"),
    ("void int8_quantize_kernel<float, true>(...)", "quantize_int8"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("aten::commit", "other"),
])
def test_kernel_category(name, category):
    assert op_profile.kernel_category(name) == category


def test_conv_profile_stage_table(capsys):
    rows = conv_profile.profile(batch=1, hw=64, device="cpu", steps=1,
                                warmup=1)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# cumulative programs, B=1 64px")
    assert [r["program"] for r in rows] == [f"stem+layer1..{k}"
                                            for k in range(1, 5)]
    assert len(out) == 5
    prev = 0.0
    for r in rows:
        assert r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0
        assert abs(r["fwd_ms"] - prev - r["fwd_delta_ms"]) < 1e-9
        prev = r["fwd_ms"]


def test_prefix_sum_is_the_backbone_outputs_sum():
    from reftr_torch.nn.resnet import ResNet

    torch.manual_seed(0)
    net = ResNet("resnet50", return_interm_layers=True).eval()
    x = torch.randn(1, 64, 64, 3)
    with torch.no_grad():
        feats = net(x)
        for k in range(4):
            want = sum(f.float().sum() for f in feats[:k + 1])
            got = conv_profile.prefix_sum(net, x, k)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-3)


def test_train_one_epoch_writes_a_trace(tmp_path):
    """Steps [1, 3) of epoch 0 traced into profile_dir: one Chrome trace
    that holds the attention op; no trace in a later epoch."""
    mc = ModelConfig(enc_layers=1, dec_layers=1, dim_feedforward=64,
                     hidden_dim=32, nheads=4, bert=BertConfig.tiny(),
                     aux_loss=False, dropout=0.0)
    state = TrainState.create(mc, TrainConfig(), 4, device="cpu")
    lc = LossConfig()
    wd = weight_dict(lc, mc.dec_layers, mc.aux_loss)
    step = make_train_step(state.model, wd, lc, device="cpu")
    rng = np.random.default_rng(0)
    batch = op_profile.make_batch(rng, 2, 64, 10, mc.bert.vocab_size)
    targets = {"boxes": np.full((2, 1, 4), 0.4, np.float32),
               "box_valid": np.ones((2, 1), bool)}
    loader = [(batch, targets)] * 4
    quiet = dict(weight_dict=wd, print_fn=lambda *a: None)
    out = tmp_path / "prof"
    state, _ = train_one_epoch(step, state, loader, 0, profile_dir=str(out),
                               profile_steps=(1, 3), **quiet)
    traces = glob.glob(str(out / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "reftr::flash_attention_fwd" in names
    state, _ = train_one_epoch(step, state, loader, 1,
                               profile_dir=str(tmp_path / "later"),
                               profile_steps=(1, 3), **quiet)
    assert not (tmp_path / "later").exists()


def test_profile_dir_parses_to_the_jax_config():
    """--profile_dir, refused before the profiler hook was ported, sets
    what JAX's sets."""
    argv = ["--preset", "refcoco_det", "--profile_dir", "p"]
    got = cli.args_to_config(cli.get_args_parser().parse_args(argv))
    want = jax_main.args_to_config(jax_main.get_args_parser().parse_args(
        argv))
    assert got.train.profile_dir == want.train.profile_dir == "p"


LOG = [
    {"epoch": 0, "train_loss": 3.2, "test_val_accuracy_iou0.5": 0.1,
     "n_parameters": 1000, "note": "text ignored", "train_lr": 1e-4},
    {"epoch": 1, "train_loss": 2.1, "test_val_accuracy_iou0.5": 0.4,
     "n_parameters": 1000, "epoch_time": 12.5, "flag": True},
]


def _scalars(tf, tb_dir):
    """(tag, step, value) of every scalar in a directory's event files,
    written as a tensor (tf.summary) or as a simple value
    (SummaryWriter)."""
    seen = []
    for path in sorted(glob.glob(os.path.join(tb_dir, "*tfevents*"))):
        for e in tf.compat.v1.train.summary_iterator(path):
            for v in e.summary.value:
                val = (tf.make_ndarray(v.tensor) if v.HasField("tensor")
                       else v.simple_value)
                seen.append((v.tag, e.step, float(np.float32(val))))
    return sorted(seen)


def test_vis_log_scalars_equal_jax(tmp_path):
    tf = pytest.importorskip("tensorflow")
    from reftr_tpu.tools.vis_log import convert_from_log as jax_convert_log

    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        with open(tmp_path / name / "log.txt", "w") as f:
            for line in LOG:
                f.write(json.dumps(line) + "\n")
    vis_log.convert_from_log(str(tmp_path / "port"))
    jax_convert_log(str(tmp_path / "jax"))
    got = _scalars(tf, str(tmp_path / "port" / "tb"))
    want = _scalars(tf, str(tmp_path / "jax" / "tb"))
    assert got == want
    assert ("train/train_loss", 1, float(np.float32(2.1))) in got
    assert not any(tag.endswith("/note") for tag, _, _ in got)


def test_vis_log_main_walks_experiment_dirs(tmp_path, capsys):
    pytest.importorskip("tensorboard")
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "log.txt").write_text(json.dumps(LOG[0]) + "\n")
    (tmp_path / "c").mkdir()
    vis_log.main(str(tmp_path))
    assert capsys.readouterr().out.count("converting") == 2
    assert (tmp_path / "a" / "tb").is_dir() and not (tmp_path / "c" / "tb"
                                                      ).exists()


def _write_resc_pth(root, rng):
    """Refcoco-style records (image, ann id, xywh box, phrase, attributes)
    as the reference pickles them, some boxes as a tensor or an ndarray,
    and their PNG images."""
    from PIL import Image

    (root / "unc").mkdir()
    im_dir = root / "images"
    im_dir.mkdir()
    records = []
    for i in range(6):
        name = f"img_{i}.png"
        Image.fromarray(rng.integers(0, 255, (80, 120, 3), np.uint8)).save(
            im_dir / name)
        box = [10, 20, 30 + i, 40]
        if i == 1:
            box = torch.tensor(box)
        elif i == 2:
            box = np.asarray(box, np.int64)
        records.append((name, np.int64(100 + i), box, f"thing {i}", None))
    torch.save(records, root / "unc" / "unc_val.pth")
    return root / "unc" / "unc_val.pth", im_dir


def test_convert_annotations_writes_jax_json_and_loads(tmp_path):
    rng = np.random.default_rng(0)
    pth, im_dir = _write_resc_pth(tmp_path, rng)
    want = jax_convert.convert_file(str(pth), str(tmp_path / "jax.json"))
    got = convert_annotations.convert_file(str(pth))
    assert got == str(tmp_path / "unc" / "unc_val.json")
    with open(got) as f1, open(want) as f2:
        assert f1.read() == f2.read()
    os.remove(pth)  # the dataset must read the JSON
    vocab = datasets.write_synthetic_vocab(str(tmp_path / "vocab.txt"))
    ds = datasets.ReferDatasetResc(str(tmp_path), str(im_dir), "unc", "val",
                                   native.WordPieceTokenizer(vocab),
                                   img_size=64, max_img_size=64,
                                   max_query_len=8)
    assert len(ds) == 6
    sample, target = ds[1]
    assert sample["image"].shape == (64, 64, 3)
    assert target["boxes"].shape == (1, 4)


def test_convert_annotations_main(tmp_path, capsys):
    rng = np.random.default_rng(1)
    _write_resc_pth(tmp_path, rng)
    assert convert_annotations.main([str(tmp_path / "unc")]) == 0
    assert (tmp_path / "unc" / "unc_val.json").is_file()
    assert convert_annotations.main([str(tmp_path / "unc"), "--glob",
                                     "*_train.pth"]) == 1
    assert "no *_train.pth files" in capsys.readouterr().out
