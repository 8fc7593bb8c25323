"""The reference's torch checkpoints in the port (reftr_torch/nn/convert.py,
core/hub.py, train/loop.py::load_pretrained) against reftr_tpu's
(nn/convert.py, core/hub.py, train/loop.py::_load_pretrained), on the CPU.

Each config (tests/test_serve.py::tiny_cfg's widths: d=32, 2+2 VL layers,
BERT-tiny, 64 px; RES at d=128, 8 heads) gets a seeded random JAX param
tree (torch_parity_utils.random_flax_params: every leaf drawn, so a
swapped slice cannot hide). The port's ``reference_state_dict`` of
``convert.from_flax(tree)`` is the reference-named state dict; JAX's own
``convert_reftr`` of it must give the tree back exactly, which proves the
inverse, and the port's ``convert_reftr`` of it must equal
``from_flax(tree)`` bit for bit. Tolerances: names, reports and tensors
exact; the model's boxes 1e-4 (tests/test_torch_model.py's); hub bytes and
digests exact.
"""

import http.server
import os
import re
import threading

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from reftr_tpu.core import checkpoint as jax_ckpt
from reftr_tpu.core import hub as jax_hub
from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import RefTRConfig as JaxRefTRConfig
from reftr_tpu.models.build import build_model as jax_build_model
from reftr_tpu.nn import convert as jax_convert
from reftr_tpu.train import loop as jax_loop
from reftr_torch.cli import main as cli
from reftr_torch.convert import build_model, flax_leaf_to_torch, from_flax
from reftr_torch.core import hub
from reftr_torch.core.config import BertConfig, ModelConfig, RefTRConfig
from reftr_torch.nn import convert
from reftr_torch.train.loop import load_pretrained
from test_torch_model import tiny_batch
from torch_parity_utils import close, random_flax_params, t

torch.set_num_threads(1)
ATOL = 1e-4
BASE = dict(enc_layers=2, dec_layers=2, dim_feedforward=64, hidden_dim=32,
            nheads=4, dropout=0.0)
CONFIGS = {
    "rec": {},
    # two queries a phrase: map_phrase and the query encoder's wider embed
    "multi": dict(num_queries_per_phrase=2),
    # input_proj.1-3: 3x3 stride-2 convolutions, each with its GroupNorm
    "levels4": dict(num_feature_levels=4),
    "res": dict(masks=True, hidden_dim=128, nheads=8, ablation="cem_loss"),
    # the pre-norm encoder's final norm
    "prenorm": dict(normalize_before=True),
}


def configs(name):
    kw = dict(BASE, **CONFIGS[name])
    jb, pb = JaxBertConfig.tiny(), BertConfig.tiny()
    for c in (jb, pb):
        c.hidden_dropout = c.attention_dropout = 0.0
    return (JaxRefTRConfig(model=JaxModelConfig(bert=jb, **kw)),
            RefTRConfig(model=ModelConfig(bert=pb, **kw)))


def depths(mc):
    return (mc.enc_layers, mc.dec_layers, mc.bert.num_hidden_layers,
            mc.backbone, mc.num_feature_levels)


_TREES = {}


def tree_of(name):
    """(JAX model, its seeded random params, JAX config, port config)."""
    if name not in _TREES:
        jcfg, pcfg = configs(name)
        jax_model, _ = jax_build_model(jcfg)
        params = random_flax_params(jax_model, tiny_batch(), seed=7)
        _TREES[name] = (jax_model, params, jcfg, pcfg)
    return _TREES[name]


def reference_sd(params, pcfg):
    """The test's reference-named state dict of a JAX tree: the port's
    inverse map of from_flax."""
    return convert.reference_state_dict(from_flax(params, pcfg.model),
                                        pcfg.model)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_names_round_trip_through_both_converters(name):
    _, params, _, pcfg = tree_of(name)
    sd = reference_sd(params, pcfg)
    back = flatten_dict(jax_convert.convert_reftr(sd, *depths(pcfg.model)))
    want = flatten_dict(params)
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    got = convert.convert_reftr(sd, *depths(pcfg.model))
    ref = from_flax(params, pcfg.model)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_packed_projections_split_in_q_k_v_order():
    _, params, _, pcfg = tree_of("rec")
    sd = reference_sd(params, pcfg)
    w = sd["vl_transformer.encoder.layers.1.self_attn.in_proj_weight"]
    d = w.shape[1]
    got = convert.convert_reftr(sd, *depths(pcfg.model))
    for i, proj in enumerate(("q_proj", "k_proj", "v_proj")):
        assert torch.equal(
            got[f"vl_transformer.encoder.layers.1.self_attn.{proj}.weight"],
            w[i * d:(i + 1) * d])
    kernel = params["vl_transformer"]["encoder"]["layers_1"]["self_attn"][
        "k_proj"]["kernel"]
    np.testing.assert_array_equal(w[d:2 * d].numpy(), kernel.T)


def _jax_report(fn):
    """What JAX's loader logged: {"missing"|"unexpected"|"shape_skipped":
    set of port names} (its keystr paths through flax_leaf_to_torch)."""
    logged = []
    fn(logged.append)
    labels = {"Missing keys": "missing", "Unexpected keys": "unexpected",
              "Shape-mismatched keys skipped": "shape_skipped"}
    out = {v: set() for v in labels.values()}
    for line in logged:
        label, _, rest = line.partition(": ")
        if label not in labels:
            continue
        for keystr in re.findall(r'"([^"]*)"', rest):
            path = tuple(re.findall(r"\['([^']*)'\]", keystr))
            name, _ = flax_leaf_to_torch(path, np.zeros((1, 1)))
            out[labels[label]].add(name)
    return out


def _port_report(report):
    return {k: set(v) for k, v in report.items()}


def _save(path, sd, wrap=True, prefix="module."):
    sd = {prefix + k: v for k, v in sd.items()}
    torch.save({"model": sd, "epoch": 3} if wrap else sd, path)
    return str(path)


def test_missing_and_unexpected_reports_match_jax(tmp_path, monkeypatch):
    """bbox_embed dropped from the file, the encoder's final norm (which a
    post-norm model lacks) and a stray tensor added; ``module.`` prefixes
    and main_vg.py's {"model": ...} wrapper."""
    jax_model, params, jcfg, pcfg = tree_of("rec")
    sd = reference_sd(params, pcfg)
    d = pcfg.model.hidden_dim
    extra = {"vl_transformer.encoder.norm.weight": torch.ones(d),
             "vl_transformer.encoder.norm.bias": torch.zeros(d),
             "stray.weight": torch.ones(3)}
    kept = {k: v for k, v in sd.items() if not k.startswith("bbox_embed.")}
    path = _save(tmp_path / "partial.pth", {**kept, **extra})

    # JAX's convert_reftr needs bbox_embed (a KeyError without it): its
    # merge is held on the same tree with bbox_embed taken out
    def jax_side(log):
        pre = jax_convert.convert_reftr({**sd, **extra},
                                        *depths(pcfg.model))
        pre.pop("bbox_embed")
        jax_ckpt.load_pretrained_nonstrict(params, pre, log=log)

    want = _jax_report(jax_side)
    model = build_model(pcfg.model, "cpu", seed=1)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    got = _port_report(load_pretrained(model, path, pcfg, log=print))
    assert got == want
    assert got["missing"] == {f"bbox_embed.layers.{i}.{p}" for i in range(3)
                              for p in ("weight", "bias")}
    assert got["unexpected"] == {"vl_transformer.encoder.norm.weight",
                                 "vl_transformer.encoder.norm.bias"}
    loaded = from_flax(params, pcfg.model)
    for k, v in model.state_dict().items():
        want_v = init[k] if k.startswith("bbox_embed.") else loaded[k]
        assert torch.equal(v, want_v), k


def test_detr_checkpoint_loads_backbone_and_encoder_as_jax(tmp_path,
                                                           monkeypatch):
    """A DETR checkpoint (any transformer.encoder* key): the backbone from
    backbone.0.body.*, the encoder from transformer.encoder.*, everything
    else at its init and reported missing, as JAX's branch
    (reftr_tpu/train/loop.py:128-139) reports it."""
    jax_model, params, jcfg, pcfg = tree_of("rec")
    sd = reference_sd(params, pcfg)
    detr = {}
    for k, v in sd.items():
        if k.startswith("img_backbone.0.body."):
            detr[k.removeprefix("img_")] = v
        elif k.startswith("vl_transformer.encoder."):
            detr["transformer." + k.removeprefix("vl_transformer.")] = v
    detr["transformer.decoder.layers.0.linear1.weight"] = torch.ones(2, 2)
    detr["class_embed.weight"] = torch.ones(92, pcfg.model.hidden_dim)
    path = _save(tmp_path / "detr-r50.pth", detr, prefix="")

    def jax_side(log):
        monkeypatch.setattr(jax_loop, "master_print", log)
        jax_loop._load_pretrained(params, path, jcfg)

    want = _jax_report(jax_side)
    model = build_model(pcfg.model, "cpu", seed=1)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    got = _port_report(load_pretrained(model, path, pcfg, log=print))
    assert got == want
    assert got["unexpected"] == set() and got["shape_skipped"] == set()
    loaded = from_flax(params, pcfg.model)
    for k, v in model.state_dict().items():
        from_file = (k.startswith("img_backbone.")
                     or k.startswith("vl_transformer.encoder."))
        assert torch.equal(v, loaded[k] if from_file else init[k]), k
        assert (k in got["missing"]) != from_file, k


@pytest.mark.parametrize("name", ["rec", "res"])
def test_model_from_the_pth_matches_jax(tmp_path, name):
    """JAX's model on convert_reftr's tree and the port's model loaded
    from the same .pth (save_reference_checkpoint: the reference's
    wrapper, module.-prefixed), on one seeded batch: boxes at 1e-4."""
    jax_model, params, jcfg, pcfg = tree_of(name)
    path = convert.save_reference_checkpoint(
        str(tmp_path / f"{name}.pth"), from_flax(params, pcfg.model),
        pcfg.model)
    jax_sd = jax_convert.load_torch_checkpoint(path)
    assert all(k.startswith("module.") for k in jax_sd)
    jax_params = jax_convert.convert_reftr(jax_sd, *depths(pcfg.model))
    batch = tiny_batch(seed=5)
    want = jax.jit(jax_model.apply)({"params": jax_params}, batch)
    model = build_model(pcfg.model, "cpu", seed=1)
    report = load_pretrained(model, path, pcfg, log=print)
    assert report == {"missing": [], "unexpected": [], "shape_skipped": []}
    with torch.no_grad():
        got = model.eval()({k: t(v) for k, v in batch.items()})
    close(got["pred_boxes"], want["pred_boxes"], ATOL)
    if name == "res":
        close(got["pred_masks"], want["pred_masks"], ATOL)


class _Files(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture
def file_server(tmp_path):
    """A http.server on 127.0.0.1 over a directory; (root dir, base URL,
    list of the paths it was asked for)."""
    root = tmp_path / "www"
    root.mkdir()
    asked = []

    class Handler(_Files):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(root), **kw)

        def do_GET(self):
            asked.append(self.path)
            super().do_GET()

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield root, f"http://127.0.0.1:{srv.server_address[1]}", asked
    srv.shutdown()
    srv.server_close()


def test_hub_caches_and_checks_embedded_hashes(file_server, tmp_path,
                                               monkeypatch):
    root, base, asked = file_server
    monkeypatch.setenv("REFTR_CACHE_DIR", str(tmp_path / "cache"))
    payload = os.urandom(3000)
    (root / "plain.pth").write_bytes(payload)
    logged = []
    first = hub.download_checkpoint(f"{base}/plain.pth", logged.append)
    assert open(first, "rb").read() == payload
    assert hub.download_checkpoint(f"{base}/plain.pth", logged.append) == first
    assert asked == ["/plain.pth"]  # the second call hit the cache

    digest = hub._sha256(first)
    good = f"ckpt-{digest[:10]}.pth"
    (root / good).write_bytes(payload)
    path = hub.download_checkpoint(f"{base}/{good}", logged.append)
    assert open(path, "rb").read() == payload
    # a corrupt cached entry of a hash-named file is fetched again
    with open(path, "r+b") as f:
        f.write(b"corrupt")
    assert hub.download_checkpoint(f"{base}/{good}", logged.append) == path
    assert open(path, "rb").read() == payload
    assert asked.count(f"/{good}") == 2

    (root / "bad-deadbeef00.pth").write_bytes(payload)
    with pytest.raises(IOError, match="integrity"):
        hub.download_checkpoint(f"{base}/bad-deadbeef00.pth", logged.append)
    assert sorted(os.listdir(tmp_path / "cache")) == sorted(
        os.path.basename(p) for p in {first, path})
    assert any("hash mismatch for bad-deadbeef00.pth" in m for m in logged)


def test_hub_downloads_as_jax_does(file_server, tmp_path, monkeypatch):
    root, base, _ = file_server
    (root / "same.pth").write_bytes(os.urandom(5000))
    runs = {}
    for label, mod in (("jax", jax_hub), ("port", hub)):
        monkeypatch.setenv("REFTR_CACHE_DIR", str(tmp_path / label))
        logged = []
        path = mod.download_checkpoint(f"{base}/same.pth", logged.append)
        runs[label] = (open(path, "rb").read(), os.path.basename(path),
                       [m for m in logged if "sha256" in m])
    assert runs["jax"] == runs["port"]
    assert len(runs["port"][2]) == 1


CLI_MODEL = ["--preset", "synthetic_smoke", "--hidden_dim", "32",
             "--dim_feedforward", "64", "--synthetic_n", "16",
             "--batch_size", "8", "--num_workers", "0", "--device", "cpu"]


def cli_pth(tmp_path):
    """A .pth of seeded random weights of CLI_MODEL's config, and the
    port's tensors it holds."""
    args = cli.get_args_parser().parse_args(CLI_MODEL)
    cli.apply_preset(args, "synthetic_smoke", CLI_MODEL)
    mc = cli.args_to_config(args).model
    jb = JaxBertConfig.tiny()
    jcfg = JaxRefTRConfig(model=JaxModelConfig(
        bert=jb, **{f: getattr(mc, f) for f in (
            "enc_layers", "dec_layers", "dim_feedforward", "hidden_dim",
            "nheads", "aux_loss")}))
    jax_model, _ = jax_build_model(jcfg)
    sd = from_flax(random_flax_params(jax_model, tiny_batch(), seed=9), mc)
    return convert.save_reference_checkpoint(str(tmp_path / "ref.pth"), sd,
                                             mc), sd


def _eval_stats(out):
    return [line for line in out.splitlines() if line.startswith("[val] ")]


def test_cli_takes_pretrained_pth_and_url_resume(file_server, tmp_path,
                                                 monkeypatch, capsys):
    """--pretrained_model <.pth> trains from the file's weights (at lr 0
    the checkpoint after the epoch holds them bit for bit, so every step
    ran on them), and --eval --resume http://... evaluates them: the same
    stats as --eval --pretrained_model of the same file."""
    root, base, asked = file_server
    monkeypatch.setenv("REFTR_CACHE_DIR", str(tmp_path / "cache"))
    path, sd = cli_pth(tmp_path)
    os.link(path, root / "ref.pth")

    out = tmp_path / "train"
    assert cli.main(CLI_MODEL + ["--pretrained_model", path, "--epochs", "1",
                                 "--lr", "0", "--lr_backbone", "0",
                                 "--output_dir", str(out)]) == 0
    text = capsys.readouterr().out
    assert "Missing keys" not in text and "Unexpected keys" not in text
    saved = torch.load(out / "checkpoint", weights_only=False)["model"]
    assert set(saved) == set(sd)
    for k, v in sd.items():
        assert torch.equal(saved[k], v), k

    assert cli.main(CLI_MODEL + ["--eval", "--resume",
                                 f"{base}/ref.pth"]) == 0
    by_url = capsys.readouterr().out
    assert f"Resumed model weights from URL {base}/ref.pth" in by_url
    assert asked == ["/ref.pth"]
    assert cli.main(CLI_MODEL + ["--eval", "--pretrained_model", path]) == 0
    by_path = capsys.readouterr().out
    assert _eval_stats(by_url) == _eval_stats(by_path) != []
