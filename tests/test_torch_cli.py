"""reftr_torch's command line against reftr_tpu's, on the CPU: the same
flags parse to the same config values, presets agree, a flag of a feature
the port does not have yet raises, and ``main`` trains the synthetic smoke
preset for an epoch on the CPU, for REC and with ``--masks`` for RES, and
the flickr preset at smoke sizes on the multi-phrase fixture and on a
Flickr30k written here."""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from reftr_tpu.cli import main as jax_main
from reftr_tpu.cli import presets as jax_presets
from reftr_torch.cli import main as cli
from reftr_torch.cli import presets

torch.set_num_threads(1)


def parse(module, argv):
    args = module.get_args_parser().parse_args(argv)
    if args.preset:
        (presets if module is cli else jax_presets).apply_preset(
            args, args.preset, argv)
    return args


def test_every_preset_key_is_a_parser_dest():
    dests = {a.dest for a in cli.get_args_parser()._actions}
    for name, p in presets.PRESETS.items():
        assert set(p) <= dests, (name, set(p) - dests)


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_presets_are_the_jax_presets(name):
    assert presets.PRESETS[name] == jax_presets.PRESETS[name]


def test_the_presets_table_is_the_jax_table():
    assert presets.PRESETS == jax_presets.PRESETS
    assert len(presets.PRESETS) == 22


def test_parsers_have_the_same_flags_and_defaults():
    ours = {a.dest: a.default for a in cli.get_args_parser()._actions}
    theirs = {a.dest: a.default for a in jax_main.get_args_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs


ARGVS = [
    ["--preset", "refcoco_det"],
    ["--preset", "refcoco_det", "--dataset", "synthetic", "--test_split",
     "val", "--synthetic_n", "64", "--batch_size", "8", "--epochs", "2",
     "--run_epoch", "1", "--auto_resume", "--num_workers", "4",
     "--output_dir", "out", "--dtype", "float32"],
    ["--preset", "synthetic_smoke", "--lr", "2e-4", "--epochs", "3"],
    ["--preset", "referit_101", "--lr_backbone", "0", "--freeze_bert",
     "--pre_norm", "--position_embedding", "learned", "--sgd",
     "--lr_schedule", "MultiStepWarmupLR", "--lr_drop_epochs", "3", "5",
     "--test_split", "val", "testB", "--cache_mode", "--seed", "7"],
    ["--preset", "refcocog_det", "--lr_bert", "3e-5", "--eval", "--resume",
     "ck", "--resume_model_only", "--start_epoch", "4", "--ckpt_cycle", "5",
     "--pretrained_model", "pre", "--bbox_loss_coef", "5",
     "--giou_loss_coef", "2", "--dilation", "--freeze_backbone",
     "--synthetic_box_frac", "0.25", "0.5", "--data_root", "d",
     "--use_pallas_attention", "auto"],
    ["--num_feature_levels", "1", "--dataset", "refcoco_unc", "--bert_size",
     "tiny", "--lr_backbone_names", "a", "b", "--lr_mask_branch_proj", "3",
     "--num_queries_per_phrase", "2", "--max_img_size", "512"],
    ["--preset", "refcoco_seg", "--dataset", "synthetic", "--test_split",
     "val", "--pretrained_model", "det/checkpoint"],
    ["--preset", "refcocog_seg_101", "--freeze_reftr", "--ablation",
     "cem_loss", "--mask_loss_coef", "2", "--dice_loss_coef", "3",
     "--focal_alpha", "0.5", "--lr_mask_branch_names", "mask_head"],
    ["--preset", "synthetic_smoke", "--masks", "--nheads", "8",
     "--hidden_dim", "128"],
    # the JAX command line's defaults: multi-phrase flickr30k, 4 levels
    [],
    ["--preset", "flickr"],
    ["--preset", "flickr_roberta", "--freeze_bert", "--test_split", "val"],
    ["--preset", "flickr_roberta", "--bert_size", "tiny"],
    ["--preset", "flickr_pt_101", "--set_cost_class", "2",
     "--set_cost_bbox", "3", "--set_cost_giou", "4"],
    ["--preset", "vg_pretrain", "--num_queries_per_phrase", "3"],
    ["--preset", "referit_pt_101", "--resume", "vg/checkpoint"],
    ["--preset", "refcoco_det", "--num_feature_levels", "4"],
    ["--preset", "refcoco_det", "--num_feature_levels", "2",
     "--reftr_type", "transformer_multi"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_args_to_config_agrees_with_jax(argv):
    """Every field of the port's config that the JAX config has takes the
    same value from the same flags."""
    got = cli.args_to_config(parse(cli, argv))
    want = jax_main.args_to_config(parse(jax_main, argv))
    n = 0
    for section in ("model", "loss", "data", "train"):
        ours, theirs = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(ours):
            if f.name == "bert":
                a, b = dataclasses.asdict(ours.bert), dataclasses.asdict(
                    theirs.bert)
                assert a == {k: b[k] for k in a}
            else:
                assert getattr(ours, f.name) == getattr(theirs, f.name), (
                    section, f.name)
            n += 1
    assert n > 60


@pytest.mark.parametrize("name", ["refcoco_det", "referit_101",
                                  "synthetic_smoke"])
def test_preset_config_is_the_cli_config(name):
    """preset_config gives what the CLI gives for the preset. A preset
    without a dtype takes the CLI's default there, bfloat16 (as in the JAX
    package), and ModelConfig's, float32, from preset_config."""
    want = cli.args_to_config(parse(cli, ["--preset", name]))
    assert presets.preset_config(name).model.dtype == presets.PRESETS[
        name].get("dtype", "float32")
    assert presets.preset_config(name, dtype=want.model.dtype) == want


NOT_PORTED_ARGVS = {
    "mesh_model": ["--mesh_model", "2"],
    "mesh_model_spans_processes": ["--mesh_model_spans_processes"],
    "quantize_int8": ["--quantize_int8"],
    "quantize_train_prefix": ["--quantize_train_prefix"],
    "quant_calib_batches": ["--quant_calib_batches", "2"],
    "quantize_scope": ["--quantize_scope", "bert"],
}


def test_every_not_ported_flag_is_tested():
    assert set(NOT_PORTED_ARGVS) == set(cli.NOT_PORTED)


# the JAX step's knobs, refused before their slice: flag -> (argv, the
# config field it sets, its value there)
KNOB_ARGVS = {
    "fold_bn": (["--fold_bn"], "model.fold_bn", True),
    "space_to_depth_stem": (["--space_to_depth_stem"],
                            "model.space_to_depth_stem", True),
    "fold_normalize": (["--fold_bn", "--fold_normalize"],
                       "model.fold_normalize", True),
    "block_layer1": (["--block_layer1"], "model.block_layer1", True),
    "backbone_pad_width": (["--backbone_pad_width", "128"],
                           "model.backbone_pad_width", 128),
    "remat": (["--remat"], "model.remat", True),
    "backbone_remat": (["--backbone_remat"], "model.backbone_remat", True),
    "backbone_remat_stages": (["--backbone_remat_stages", "1", "2"],
                              "model.backbone_remat_stages", (1, 2)),
    "use_pallas_attention_on": (["--use_pallas_attention", "on"],
                                "model.use_pallas_attention", True),
    "use_pallas_attention_off": (["--use_pallas_attention", "off"],
                                 "model.use_pallas_attention", False),
    "use_pallas_attention_auto": (["--use_pallas_attention", "auto"],
                                  "model.use_pallas_attention", None),
    "no_donate_state": (["--no_donate_state"], "train.donate_state", False),
}


@pytest.mark.parametrize("dest", sorted(KNOB_ARGVS))
def test_a_knob_parses_to_the_jax_config_and_builds(dest):
    """Each of the JAX step's knobs maps onto the config as reftr_tpu's
    args_to_config maps it (cli/main.py:249-261, 317), leaves NOT_PORTED,
    and the refcoco_det model it names builds (on the meta device)."""
    flags, field, value = KNOB_ARGVS[dest]
    argv = ["--preset", "refcoco_det"] + flags
    got = cli.args_to_config(parse(cli, argv))
    want = jax_main.args_to_config(parse(jax_main, argv))
    for section in ("model", "train"):
        ours, theirs = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(ours):
            if f.name != "bert":
                assert getattr(ours, f.name) == getattr(theirs, f.name), (
                    section, f.name)
    section, name = field.split(".")
    assert getattr(getattr(got, section), name) == value
    assert dest.removesuffix("_on").removesuffix("_off").removesuffix(
        "_auto") not in cli.NOT_PORTED
    from reftr_torch.convert import model_class

    with torch.device("meta"):
        model = model_class(got.model)(got.model)
    if got.model.fold_bn:
        assert model.img_backbone.bn1.folded


def test_the_jax_cli_mapping_test_parses_and_builds():
    """tests/test_cli.py:62-72's flags on refcoco_seg: the same config
    values as JAX's, and the RES model with the s2d stem, the folds, the
    padded widths and the recomputed bottlenecks builds."""
    argv = ["--preset", "refcoco_seg", "--dtype", "bfloat16",
            "--space_to_depth_stem", "--fold_bn", "--fold_normalize",
            "--backbone_pad_width", "128", "--backbone_remat",
            "--lr_bert_names", "a", "b"]
    got = cli.args_to_config(parse(cli, argv))
    want = jax_main.args_to_config(parse(jax_main, argv))
    for section in ("model", "loss", "data", "train"):
        ours, theirs = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(ours):
            if f.name != "bert":
                assert getattr(ours, f.name) == getattr(theirs, f.name), (
                    section, f.name)
    from reftr_torch.convert import model_class

    with torch.device("meta"):
        model = model_class(got.model)(got.model)
    backbone = model.img_backbone
    assert backbone.space_to_depth and backbone.remat_stages == {1, 2, 3, 4}
    assert backbone.layer1[0].conv2.weight.shape == (128, 128, 3, 3)


def test_debug_nans_turns_the_step_checks_on(monkeypatch):
    """main's --debug_nans sets the steps' switch before training, as
    JAX's main sets jax_debug_nans (cli/main.py:333-336)."""
    from reftr_torch.train import loop, steps

    seen = {}
    monkeypatch.setattr(loop, "run_training", lambda cfg, device: seen.update(
        on=steps._DEBUG_NANS) or {})
    try:
        assert cli.main(["--preset", "synthetic_smoke", "--device", "cpu",
                         "--debug_nans"]) == 0
    finally:
        steps.set_debug_nans(False)
    assert seen == {"on": True}


def test_visualize_parses_to_the_jax_config():
    """--visualize, refused before the visual dump was ported, sets what
    JAX's sets (tests/test_torch_serve_http.py runs the dump)."""
    argv = ["--preset", "refcoco_det", "--eval", "--visualize"]
    got = cli.args_to_config(parse(cli, argv))
    want = jax_main.args_to_config(parse(jax_main, argv))
    assert got.train.visualize is want.train.visualize is True
    assert got.train.eval_only is want.train.eval_only is True


RES_ARGVS = {
    "masks": ["--masks"], "freeze_reftr": ["--masks", "--freeze_reftr"],
    "mask_loss_coef": ["--mask_loss_coef", "2"],
    "dice_loss_coef": ["--dice_loss_coef", "2"],
    "ablation": ["--ablation", "cem_loss"],
    "focal_alpha": ["--focal_alpha", "0.5"],
}


@pytest.mark.parametrize("dest", sorted(RES_ARGVS))
def test_a_res_flag_parses_to_the_jax_config(dest):
    """The RES flags, which the port refused before it ran RES, parse to
    JAX's values; focal_alpha is the mask loss's, not only the
    matcher's."""
    argv = ["--preset", "refcoco_det"] + RES_ARGVS[dest]
    got = cli.args_to_config(parse(cli, argv))
    want = jax_main.args_to_config(parse(jax_main, argv))
    for section in ("model", "loss"):
        ours, theirs = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(ours):
            if f.name != "bert":
                assert getattr(ours, f.name) == getattr(theirs, f.name)
    assert dest not in cli.NOT_PORTED


# flag: (argv, the config field it sets, its value there)
SCRATCH_ARGVS = {
    "train_stem": (["--train_stem"], "model.train_stem", True),
    "backbone_norm": (["--backbone_norm", "group"], "model.backbone_norm",
                      "group"),
    "vision_aux_loss": (["--vision_aux_loss"], "model.vision_aux", True),
    "vision_aux_loss_coef": (["--vision_aux_loss_coef", "2"],
                             "loss.vision_aux_coef", 2.0),
    "img_pos_in_stream": (["--img_pos_in_stream"], "model.img_pos_in_stream",
                          True),
    "decoder_pos_in_value": (["--decoder_pos_in_value"],
                             "model.decoder_pos_in_value", True),
    "heatmap_box": (["--vision_aux_loss", "--heatmap_box"],
                    "model.heatmap_box", True),
}
# the JAX mapping's two rules: a frozen backbone keeps the stem frozen, and
# RES turns the vision probe off
SCRATCH_RULES = {
    "train_stem_frozen_backbone": (["--train_stem", "--freeze_backbone"],
                                   "model.train_stem", False),
    "train_stem_lr_backbone_0": (["--train_stem", "--lr_backbone", "0"],
                                 "model.train_stem", False),
    "vision_aux_loss_masks": (["--vision_aux_loss", "--masks"],
                              "model.vision_aux", False),
}


@pytest.mark.parametrize("dest", sorted(SCRATCH_ARGVS) + sorted(
    SCRATCH_RULES))
def test_a_from_scratch_flag_parses_to_the_jax_config(dest):
    """The from-scratch flags, which the port refused before their slice,
    map onto the model and loss configs as reftr_tpu's args_to_config maps
    them (cli/main.py:232-267), and leave NOT_PORTED."""
    flags, field, value = {**SCRATCH_ARGVS, **SCRATCH_RULES}[dest]
    argv = ["--preset", "refcoco_det"] + flags
    got = cli.args_to_config(parse(cli, argv))
    want = jax_main.args_to_config(parse(jax_main, argv))
    for section in ("model", "loss"):
        ours, theirs = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(ours):
            if f.name != "bert":
                assert getattr(ours, f.name) == getattr(theirs, f.name), (
                    section, f.name)
    section, name = field.split(".")
    assert getattr(getattr(got, section), name) == value
    assert dest not in cli.NOT_PORTED


@pytest.mark.parametrize("argv", [["--fold_bn"], ["--quantize_int8"]])
def test_group_norm_refuses_folding_as_jax(argv):
    """--backbone_norm group with a flag that folds or quantizes FrozenBN's
    statistics raises the JAX factory's ValueError (for int8, before the
    flag's own refusal; reftr_tpu/models/build.py:25-31)."""
    args = parse(cli, ["--preset", "refcoco_det", "--backbone_norm",
                       "group"] + argv)
    with pytest.raises(ValueError, match="no frozen statistics"):
        cli.args_to_config(args)


@pytest.mark.parametrize("dest", sorted(NOT_PORTED_ARGVS))
def test_a_flag_of_a_missing_feature_raises(dest):
    args = parse(cli, ["--preset", "refcoco_det"] + NOT_PORTED_ARGVS[dest])
    with pytest.raises(NotImplementedError,
                       match=f"--{dest} .*ROADMAP.md queue 1 item"):
        cli.args_to_config(args)


@pytest.mark.parametrize("argv", [["--mesh_model", "2"],
                                  ["--mesh_model_spans_processes"]])
def test_tensor_parallelism_is_refused_under_its_item(argv):
    """The model axis stays refused (the reference has DDP only), naming
    its own ROADMAP item, not multi-GPU's."""
    args = parse(cli, ["--preset", "refcoco_det", "--mesh_data", "-1"]
                 + argv)
    with pytest.raises(NotImplementedError,
                       match=r"tensor parallelism \(ROADMAP.md queue 1 "
                             r"item 12\) is not ported"):
        cli.args_to_config(args)


RANK_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
             "SLURM_PROCID", "SLURM_NTASKS")


@pytest.mark.parametrize("world,mesh_data", [(1, "-1"), (1, "1"),
                                             (2, "-1"), (2, "2")])
def test_mesh_data_is_all_or_the_world(monkeypatch, world, mesh_data):
    """--mesh_data is accepted as -1 or the world size the launcher set,
    and parses to the JAX config's mesh.data."""
    for k in RANK_VARS:
        monkeypatch.delenv(k, raising=False)
    if world > 1:
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", str(world))
    argv = ["--preset", "refcoco_det", "--mesh_data", mesh_data]
    got = cli.args_to_config(parse(cli, argv))
    want = jax_main.args_to_config(parse(jax_main, argv))
    assert got.mesh.data == want.mesh.data == int(mesh_data)
    assert "mesh_data" not in cli.NOT_PORTED


@pytest.mark.parametrize("world,mesh_data", [(2, "3"), (2, "1"), (1, "2")])
def test_mesh_data_off_the_world_raises(monkeypatch, world, mesh_data):
    for k in RANK_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", str(world))
    argv = ["--preset", "refcoco_det", "--mesh_data", mesh_data]
    with pytest.raises(ValueError, match=f"--mesh_data {mesh_data} does "
                                         f"not match the {world} processes"):
        cli.args_to_config(parse(cli, argv))


@pytest.mark.parametrize("argv,item", [
    (["--preset", "refcoco_det", "--no_decoder"], "no_decoder")])
def test_other_missing_features_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.args_to_config(parse(cli, argv))


@pytest.mark.parametrize("reftr_type", ["transformer_multi", "lstm"])
def test_reftr_type_agrees_with_jax(reftr_type):
    """Any type that starts with "transformer" builds RefTR in both
    packages; another is refused by both model factories, with JAX's
    message."""
    from reftr_tpu.models.build import build_model as jax_build_model
    from reftr_torch.convert import model_class
    from reftr_torch.models.reftr import RefTR

    argv = ["--preset", "refcoco_det", "--reftr_type", reftr_type]
    got = cli.args_to_config(parse(cli, argv))
    want = jax_main.args_to_config(parse(jax_main, argv))
    assert got.model.reftr_type == want.model.reftr_type == reftr_type
    if reftr_type.startswith("transformer"):
        assert model_class(got.model) is RefTR
        assert type(jax_build_model(want)[0]).__name__ == "RefTR"
        return
    message = f"reftr_type {reftr_type!r} is not implemented"
    with pytest.raises(NotImplementedError) as theirs:
        jax_build_model(want)
    with pytest.raises(NotImplementedError) as ours:
        model_class(got.model)
    assert str(ours.value) == str(theirs.value) == message


def test_synthetic_multi_is_a_multi_phrase_dataset():
    """--dataset synthetic_multi (the port's name of the JAX package's
    multi-phrase fixture) parses as JAX parses it but for multi_phrase."""
    argv = ["--preset", "flickr", "--dataset", "synthetic_multi"]
    got = cli.args_to_config(parse(cli, argv))
    want = jax_main.args_to_config(parse(jax_main, argv))
    assert got.data.multi_phrase and not want.data.multi_phrase
    got.data.multi_phrase = False
    assert dataclasses.asdict(got.data) == {
        k: v for k, v in dataclasses.asdict(want.data).items()
        if k in dataclasses.asdict(got.data)}


def test_main_trains_the_smoke_preset_on_the_cpu(tmp_path, capsys):
    argv = ["--preset", "synthetic_smoke", "--device", "cpu", "--epochs",
            "1", "--synthetic_n", "16", "--batch_size", "8", "--num_workers",
            "2", "--output_dir", str(tmp_path)]
    assert cli.main(argv) == 0
    with open(tmp_path / "log.txt") as f:
        (entry,) = [json.loads(x) for x in f]
    assert entry["epoch"] == 0 and entry["train_loss"] > 0
    assert "test_val_accuracy_iou0.5" in entry
    out = capsys.readouterr().out
    assert "Steps per training epoch: 2" in out
    assert "best accuracy_iou0.5:" in out


def test_main_trains_res_on_the_synthetic_fixture_on_the_cpu(tmp_path,
                                                            capsys):
    """--masks on the smoke preset (d=128 and 8 heads, so GroupNorm's 8
    groups divide 2d + heads and d/16): an epoch of RES with box-shaped
    masks, an eval with seg_miou, then --freeze_reftr --ablation cem_loss
    from that checkpoint as a pretrained model."""
    base = ["--preset", "synthetic_smoke", "--masks", "--hidden_dim", "128",
            "--nheads", "8", "--device", "cpu", "--epochs", "1",
            "--synthetic_n", "8", "--batch_size", "4", "--num_workers", "2"]
    assert cli.main(base + ["--output_dir", str(tmp_path / "a")]) == 0
    with open(tmp_path / "a" / "log.txt") as f:
        (entry,) = [json.loads(x) for x in f]
    assert entry["train_loss_mask"] > 0 and entry["train_loss_dice"] > 0
    assert 0.0 <= entry["test_val_seg_miou"] <= 1.0
    out = capsys.readouterr().out
    assert '"seg_miou": ' in out
    assert cli.main(base + [
        "--freeze_reftr", "--ablation", "cem_loss", "--pretrained_model",
        str(tmp_path / "a" / "checkpoint"), "--output_dir",
        str(tmp_path / "b")]) == 0
    with open(tmp_path / "b" / "log.txt") as f:
        (entry,) = [json.loads(x) for x in f]
    assert entry["train_loss_cem"] > 0
    out = capsys.readouterr().out
    assert "Missing keys: ['cem_block." in out
    assert "Unexpected keys" not in out


def test_main_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--preset", "synthetic_smoke", "--output_dir",
                  str(tmp_path)])


SMOKE_FLICKR = ["--preset", "flickr", "--device", "cpu", "--bert_size",
                "tiny", "--enc_layers", "1", "--dec_layers", "2",
                "--hidden_dim", "64", "--nheads", "4", "--dim_feedforward",
                "64", "--img_size", "64", "--max_img_size", "64",
                "--epochs", "1", "--batch_size", "4", "--num_workers", "2",
                "--test_split", "val"]


def test_main_trains_flickr_on_the_multi_phrase_fixture(tmp_path, capsys):
    """The flickr preset at smoke sizes on synthetic_multi: an epoch of
    multi-phrase training (16 phrase slots of 22 tokens, 90 sentence
    tokens), an eval, then --eval --resume, whose accuracy is the log's."""
    base = SMOKE_FLICKR + ["--dataset", "synthetic_multi", "--synthetic_n",
                           "8"]
    out_dir = tmp_path / "out"
    assert cli.main(base + ["--output_dir", str(out_dir)]) == 0
    with open(out_dir / "log.txt") as f:
        (entry,) = [json.loads(x) for x in f]
    assert entry["train_loss"] > 0 and entry["test_val_loss_giou"] > 0
    out = capsys.readouterr().out
    assert "Steps per training epoch: 2" in out
    assert cli.main(base + ["--eval", "--resume",
                            str(out_dir / "checkpoint")]) == 0
    (line,) = [json.loads(x) for x in re.findall(
        r"^\[val\] (\{.*\})$", capsys.readouterr().out, re.M)]
    assert line["accuracy_iou0.5"] == entry["test_val_accuracy_iou0.5"]
    with open(out_dir / "synthetic_multi_val_result.json") as f:
        boxes = json.load(f)
    assert len(boxes) == 64 and all(len(b) == 2 for b in boxes.values())


def test_main_trains_flickr_on_flickr30k_files(tmp_path):
    """--dataset flickr30k (the preset's) on annotations and PNGs written
    here, with the tokenizer's vocabulary given as a file."""
    from PIL import Image

    from test_torch_data import WORDPIECE_VOCAB, write_lines

    root = tmp_path / "data"
    im_dir = root / "flickr30k" / "f30k_images"
    ann = root / "annotations" / "flickr30k_entities"
    im_dir.mkdir(parents=True)
    ann.mkdir(parents=True)
    rng = np.random.default_rng(0)
    records = []
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (60, 48 + 4 * i, 3),
                                     dtype=np.uint8)).save(im_dir / f"{i}.png")
        records.append([f"{i}.png", [0, 11], [[2, 3, 30, 20],
                                              [10, 12, 40, 44]],
                        ["the man", "the red shirt"], None,
                        "the man in the red shirt is walking"])
    for split in ("trainval", "val"):
        (ann / f"flickr30k_entities_{split}.json").write_text(
            json.dumps(records))
    vocab = write_lines(tmp_path / "vocab.txt", WORDPIECE_VOCAB)
    argv = SMOKE_FLICKR + ["--data_root", str(root), "--bert_model", vocab,
                           "--output_dir", str(tmp_path / "out")]
    assert cli.main(argv) == 0
    with open(tmp_path / "out" / "log.txt") as f:
        (entry,) = [json.loads(x) for x in f]
    assert entry["train_loss"] > 0
    with open(tmp_path / "out" / "flickr30k_val_result.json") as f:
        assert len(json.load(f)) == 4
