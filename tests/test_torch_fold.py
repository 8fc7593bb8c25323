"""reftr_torch's backbone reparameterisations (nn/fold.py, nn/resnet.py)
against reftr_tpu's, on the CPU in float32.

Each fold is held twice, at the JAX package's tolerance of 2e-4
(tests/test_resnet.py:211-420): the port's folded ResNet, on weights the
port folded, against JAX's folded ResNet on weights JAX folded; and the
port's folded ResNet against the port's standard one. The port's folded
weights equal JAX's folded tree carried through ``convert.from_flax``
(the same float32 products; sums of the normalisation fold in float64 may
part in the last float32 ulp, so 1e-6 relative). ``fold_normalize`` is
not exact on the outermost output ring (its zero padding taps mean zero
in normalised space), so against the standard model only layer1's
interior is held, as JAX's test holds it.

Model level: a reference ``.pth`` loaded into the folded port model
(``train.loop.load_pretrained``) equals JAX's ``convert_reftr`` +
``optimize_backbone_in_tree`` carried through ``from_flax``, and their
boxes agree at 1e-4; ``from_flax`` takes every folded tree; the trainer
initialises the standard backbone and folds it; the folded export and the
server take uint8 canvases and refuse float images.
"""

import os

import jax
import numpy as np
import pytest
import torch

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import RefTRConfig as JaxRefTRConfig
from reftr_tpu.models.build import build_model as jax_build_model
from reftr_tpu.nn import convert as jax_convert
from reftr_tpu.nn import fold as jax_fold
from reftr_tpu.nn.resnet import ResNet as JaxResNet
from reftr_tpu.ops.image import normalize_images as jax_normalize
from reftr_torch.convert import (build_model, flax_state_dict, from_flax,
                                  model_class)
from reftr_torch.core import checkpoint as ckpt_lib
from reftr_torch.core.config import (BertConfig, DataConfig, ModelConfig,
                                     RefTRConfig, TrainConfig)
from reftr_torch.nn import convert
from reftr_torch.nn import fold
from reftr_torch.nn.resnet import ResNet, space_to_depth
from reftr_torch.ops.image import normalize_images
from reftr_torch.train.loop import load_pretrained
from test_torch_model import tiny_batch
from torch_parity_utils import close, random_flax_params, t

torch.set_num_threads(1)
TOL = 2e-4  # tests/test_resnet.py's fold equivalences
TREE_RTOL = 1e-6
HALO = 6  # layer1 pixels the stem's border reaches (tests/test_resnet.py)


@pytest.fixture(scope="module")
def base():
    """A JAX ResNet-50's seeded params (every FrozenBN statistic drawn, so
    the folds are not trivial), an input, JAX's standard outputs, and the
    port's standard ResNet on the same weights with its outputs."""
    x = np.random.default_rng(0).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    jnet = JaxResNet("resnet50", return_interm_layers=True)
    params = random_flax_params(jnet, x)
    want = [np.asarray(f) for f in jnet.apply({"params": params}, x)]
    port = ResNet("resnet50", return_interm_layers=True)
    port.load_state_dict(flax_state_dict(params, port.state_dict()))
    with torch.no_grad():
        got = port.eval()(t(x))
    return {"x": x, "params": params, "want": want, "port": port,
            "got": got}


def port_net(state, **kw) -> ResNet:
    """The port's ResNet of ``kw`` with the folded ``state``."""
    net = ResNet("resnet50", return_interm_layers=True, **kw)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return net.eval()


def check_fold(base, x, kw, fold_kw, want_std, got_std, interior=False):
    """The port's fold of the standard weights against JAX's fold, tree and
    outputs, and against the standard port model."""
    params = base["params"]
    jparams = jax_fold.optimize_resnet_params(params, **fold_kw)
    jnet = JaxResNet("resnet50", return_interm_layers=True, **kw)
    want = [np.asarray(f) for f in jnet.apply({"params": jparams}, x)]
    state = fold.optimize_resnet_params(base["port"].state_dict(), **fold_kw)
    net = port_net(state, **kw)
    carried = flax_state_dict(jparams, net.state_dict())
    assert set(carried) == set(state)
    for k, v in carried.items():
        np.testing.assert_allclose(state[k], v.numpy(), rtol=TREE_RTOL,
                                   atol=1e-7, err_msg=k)
    with torch.no_grad():
        got = net(t(x))
    for g, w, gs in zip(got, want, got_std):
        assert tuple(g.shape) == w.shape
        close(g, w, TOL, TOL)
        if interior:
            continue
        close(g, gs, TOL, TOL)
    if interior:
        a = got[0][:, HALO:-HALO, HALO:-HALO]
        b = got_std[0][:, HALO:-HALO, HALO:-HALO]
        close(a, b, TOL, TOL)
        assert all(torch.isfinite(g).all() for g in got)
    for w, ws in zip(want, want_std):
        assert w.shape == ws.shape


@pytest.mark.parametrize("s2d,fold_bn", [(True, False), (False, True),
                                         (True, True)])
def test_space_to_depth_and_fold_bn_match_jax(base, s2d, fold_bn):
    """tests/test_resnet.py:211: the s2d stem and folded FrozenBN."""
    kw = dict(space_to_depth=s2d, fold_bn=fold_bn)
    check_fold(base, base["x"], kw, kw, base["want"], base["got"])


@pytest.mark.parametrize("s2d", [False, True])
def test_fold_normalize_matches_jax(base, s2d):
    """tests/test_resnet.py:248: raw uint8 through the folded stem against
    JAX's everywhere, against the standard model on normalised input
    inside layer1's edge ring."""
    img = np.random.default_rng(1).integers(0, 256, (1, 96, 96, 3)).astype(
        np.uint8)
    x_norm = np.asarray(jax_normalize(img))
    np.testing.assert_allclose(normalize_images(t(img)).numpy(), x_norm,
                               atol=1e-6)
    jnet = JaxResNet("resnet50", return_interm_layers=True)
    want_std = [np.asarray(f) for f in jnet.apply(
        {"params": base["params"]}, x_norm)]
    with torch.no_grad():
        got_std = base["port"](t(x_norm))
    kw = dict(space_to_depth=s2d, fold_bn=True)
    check_fold(base, img.astype(np.float32), kw,
               dict(kw, fold_normalize=True), want_std, got_std,
               interior=True)
    with pytest.raises(AssertionError, match="fold_bn"):
        fold.optimize_resnet_params(base["port"].state_dict(),
                                    fold_normalize=True)


@pytest.mark.parametrize("fold_bn", [False, True])
def test_pad_width_matches_jax(base, fold_bn):
    """tests/test_resnet.py:291: inner widths zero-padded to 128."""
    kw = dict(fold_bn=fold_bn, min_inner_width=128)
    check_fold(base, base["x"], kw, kw, base["want"], base["got"])
    state = fold.optimize_resnet_params(base["port"].state_dict(), **kw)
    assert state["layer1.0.conv2.weight"].shape == (128, 128, 3, 3)
    assert state["layer3.0.conv2.weight"].shape == (256, 256, 3, 3)


@pytest.mark.parametrize("kw", [dict(block_layer1=True),
                                dict(block_layer1=True, space_to_depth=True,
                                     fold_bn=True)],
                         ids=["alone", "with_s2d_fold_bn"])
def test_block_layer1_matches_jax(base, kw):
    """tests/test_resnet.py:382: layer1 on the 2x2 space-to-depth grid,
    alone and with the stem and BN folds."""
    check_fold(base, base["x"], kw, kw, base["want"], base["got"])
    with pytest.raises(ValueError, match="exclusive"):
        ResNet("resnet50", block_layer1=True, min_inner_width=128)


def test_s2d_stem_of_a_torch_kernel_is_the_strided_conv():
    """tests/test_resnet.py:354's stem check in the port's layout: a
    torch 7x7/stride-2 kernel, folded (OIHW), through the port's
    space-to-depth stem conv, is F.conv2d(stride 2, padding 3); and the
    port's fold of the kernel is JAX's fold of its converted HWIO kernel."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 3, 7, 7, generator=g)
    x = torch.randn(1, 32, 32, 3, generator=g)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, stride=2,
                                      padding=3)
    k = fold.fold_conv1_to_s2d(w.numpy())
    jk = jax_fold.fold_conv1_to_s2d(jax_convert.conv({"c.weight": w},
                                                     "c")["kernel"])
    np.testing.assert_array_equal(k, jk.transpose(3, 2, 0, 1))
    net = ResNet("resnet50", space_to_depth=True)
    with torch.no_grad():
        net.conv1_s2d.weight.copy_(torch.from_numpy(k))
        y = space_to_depth(torch.nn.functional.pad(x, (0, 0, 4, 4, 4, 4)))
        got = net.conv1_s2d(y.permute(0, 3, 1, 2))[:, :, :16, :16]
    close(got, want.numpy(), 1e-4, 1e-4)


# the whole model: BERT-tiny, ResNet-50, one VL layer each side, d=32
MODEL = dict(enc_layers=1, dec_layers=1, dim_feedforward=64, hidden_dim=32,
             nheads=4, dropout=0.0)
FLAGS = {
    "s2d": dict(space_to_depth_stem=True),
    "fold_bn": dict(fold_bn=True),
    "fold_normalize": dict(fold_bn=True, fold_normalize=True),
    "s2d_fold_normalize": dict(space_to_depth_stem=True, fold_bn=True,
                               fold_normalize=True),
    "pad_width": dict(fold_bn=True, backbone_pad_width=128),
    "block_layer1": dict(block_layer1=True, space_to_depth_stem=True,
                         fold_bn=True),
}


def configs(**flags):
    jb, pb = JaxBertConfig.tiny(), BertConfig.tiny()
    for c in (jb, pb):
        c.hidden_dropout = c.attention_dropout = 0.0
    return (JaxModelConfig(bert=jb, **MODEL, **flags),
            ModelConfig(bert=pb, **MODEL, **flags))


@pytest.fixture(scope="module")
def standard():
    """JAX's standard tiny RefTR and its seeded params."""
    jcfg, _ = configs()
    jax_model, _ = jax_build_model(JaxRefTRConfig(model=jcfg))
    return jax_model, random_flax_params(jax_model, tiny_batch(), seed=7)


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_from_flax_takes_every_folded_tree(name):
    """JAX's model of each flag set, initialised as it is (its folded
    tree), maps onto the port's model of the same flags, every leaf used
    and every tensor filled."""
    jcfg, pcfg = configs(**FLAGS[name])
    jax_model, _ = jax_build_model(JaxRefTRConfig(model=jcfg))
    params = random_flax_params(jax_model, tiny_batch(), seed=3)
    sd = from_flax(params, pcfg)
    backbone = {k for k in sd if k.startswith("img_backbone.")}
    if pcfg.space_to_depth_stem:
        assert tuple(sd["img_backbone.conv1_s2d.weight"].shape) == (
            64, 12, 4, 4)
    if pcfg.fold_bn:
        assert "img_backbone.bn1.bias" in backbone
        assert not any(k.endswith("running_var") for k in backbone)
    if pcfg.block_layer1:
        assert tuple(sd["img_backbone.layer1.0.conv2.weight"].shape) == (
            256, 256, 3, 3)
        assert tuple(sd["img_backbone.layer1.0.conv1.weight"].shape) == (
            256, 256, 1, 1)


@pytest.mark.parametrize("name", ["s2d_fold_normalize", "pad_width",
                                  "block_layer1"])
def test_a_pth_folded_at_load_matches_jax(standard, tmp_path, name):
    """A reference .pth of the standard weights, loaded into the folded
    port model, equals JAX's convert_reftr + optimize_backbone_in_tree
    carried through from_flax, and the two models' boxes agree at
    1e-4."""
    jax_std, params = standard
    jcfg, pcfg = configs(**FLAGS[name])
    std_cfg = configs()[1]
    path = convert.save_reference_checkpoint(
        str(tmp_path / "ref.pth"), from_flax(params, std_cfg), std_cfg)
    jax_sd = jax_convert.load_torch_checkpoint(path)
    tree = jax_convert.convert_reftr(
        jax_sd, pcfg.enc_layers, pcfg.dec_layers,
        pcfg.bert.num_hidden_layers, pcfg.backbone, pcfg.num_feature_levels)
    tree = jax_fold.optimize_backbone_in_tree(tree, jcfg)
    want_sd = from_flax(tree, pcfg)
    model = build_model(pcfg, "cpu", seed=1)
    report = load_pretrained(model, path, RefTRConfig(model=pcfg),
                             log=print)
    assert report == {"missing": [], "unexpected": [], "shape_skipped": []}
    got_sd = model.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                   rtol=TREE_RTOL, atol=1e-7, err_msg=k)
    jax_model, _ = jax_build_model(JaxRefTRConfig(model=jcfg))
    batch = tiny_batch(seed=5)
    want = jax.jit(jax_model.apply)({"params": tree}, batch)
    with torch.no_grad():
        got = model.eval()({k: t(v) for k, v in batch.items()})
    close(got["pred_boxes"], want["pred_boxes"], 1e-4)


def test_model_checks_follow_jax():
    """The JAX factory's refusals (reftr_tpu/models/build.py:25-31), and
    the uint8-only input under fold_normalize (models/reftr.py:182-193)."""
    _, group = configs(backbone_norm="group", fold_bn=True)
    with pytest.raises(ValueError, match="no frozen statistics"):
        model_class(group)
    _, alone = configs(fold_normalize=True)
    with pytest.raises(ValueError, match="requires fold_bn"):
        model_class(alone)
    _, pcfg = configs(**FLAGS["fold_normalize"])
    model = build_model(pcfg, "cpu", seed=0).eval()
    batch = {k: t(v) for k, v in tiny_batch().items()}
    with torch.no_grad():
        model(batch)
        with pytest.raises(ValueError, match="expects uint8"):
            model(dict(batch, image=batch["image"].float()))


def test_seeded_init_is_the_standard_init_folded():
    """With backbone folds and no weights, build_model folds the standard
    model's seeded init (JAX's run_training, loop.py:206-226): the same
    function on uint8 inside the edge ring, the rest of the model equal."""
    _, pcfg = configs(**FLAGS["s2d_fold_normalize"])
    folded = build_model(pcfg, "cpu", seed=4)
    std = build_model(configs()[1], "cpu", seed=4)
    want = fold.optimize_backbone_in_tree(std.state_dict(), pcfg)
    got = folded.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the 1/(255 std) input scale: below a fiftieth of the standard stem
    stem = got["img_backbone.conv1_s2d.weight"].abs().max()
    assert stem < std.state_dict()["img_backbone.conv1.weight"].abs().max(
        ) / 50


# the trainer from scratch with the folds (tests/test_loop.py:37-60)
DATA = dict(dataset="synthetic", train_split="train", test_splits=("val",),
            img_size=32, max_img_size=32, max_query_len=12, batch_size=8,
            num_workers=2, synthetic_n=16)


def test_run_training_from_scratch_with_folds(tmp_path, capsys):
    """run_training with the s2d stem, fold_bn and fold_normalize from
    scratch initialises the standard backbone and folds it: finite
    losses that fall, and a stem kernel that carries the 1/(255 std)
    input scale, two orders below the standard init's (JAX's bound)."""
    from reftr_torch.train.loop import run_training

    out = str(tmp_path)
    cfg = RefTRConfig(
        model=ModelConfig(enc_layers=1, dec_layers=1, dim_feedforward=32,
                          hidden_dim=32, nheads=4, bert=BertConfig.tiny(),
                          aux_loss=False, space_to_depth_stem=True,
                          fold_bn=True, fold_normalize=True),
        data=DataConfig(**DATA),
        train=TrainConfig(lr=1e-3, epochs=2, warm_up_epoch=1,
                          lr_schedule="CosineWarmupLR", output_dir=out,
                          seed=0))
    result = run_training(cfg, device="cpu")
    assert "--fold_normalize degrades TRAINING" in capsys.readouterr().out
    losses = [h["train_loss"] for h in result["history"]]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    payload = ckpt_lib.load_checkpoint(os.path.join(out, "checkpoint"))
    k = payload["model"]["img_backbone.conv1_s2d.weight"]
    assert float(k.abs().max()) < 0.02, float(k.abs().max())
    assert "img_backbone.bn1.weight" not in payload["model"]


def test_folded_export_round_trip(tmp_path):
    """The export with --fold_bn --fold_normalize: the manifest's fold
    keys, the program's boxes on uint8 canvases equal to the live folded
    model's, and a folded ServingModel and the HTTP front end refusing a
    float image."""
    from reftr_torch.cli.presets import preset_config
    from reftr_torch.serve import ServingModel
    from reftr_torch.tools import export_model
    from reftr_torch.tools.serve import Frontend
    from reftr_torch.train.loop import build_tokenizer

    out = str(tmp_path / "exp")
    argv = ["--preset", "synthetic_smoke", "--hidden_dim", "32",
            "--dim_feedforward", "64", "--out", out, "--export_batch", "2",
            "--export_platforms", "cpu", "--fold_bn", "--fold_normalize",
            "--selfcheck"]
    assert export_model.main(argv) == 0
    manifest = export_model.read_manifest(out)
    assert manifest["model"]["fold_bn"] is True
    assert manifest["model"]["fold_normalize"] is True
    assert manifest["model"]["quantize_int8"] is False
    cfg = preset_config("synthetic_smoke", hidden_dim=32, dim_feedforward=64,
                        fold_bn=True, fold_normalize=True)
    exported = ServingModel(cfg, 2, device="cpu", exported_dir=out)
    live = ServingModel(cfg, 2, device="cpu")
    assert live.model.img_backbone.bn1.folded
    spec = export_model.serving_batch_spec(cfg, 2)
    batch = export_model.random_batch(spec, seed=3)
    np.testing.assert_allclose(exported(batch)["pred_boxes"],
                               live(batch)["pred_boxes"], atol=1e-5)
    with pytest.raises(ValueError, match="expects uint8"):
        live(dict(batch, image=batch["image"].astype(np.float32)))
    fe = Frontend(cfg, build_tokenizer(cfg))
    img = np.zeros((40, 50, 3), np.uint8)
    req = fe.rows(img, ["the red box"])
    assert req.rows["image"].dtype == np.uint8
    with pytest.raises(ValueError, match="uint8"):
        fe.rows(img.astype(np.float32), ["the red box"])
