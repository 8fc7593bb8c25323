"""Named presets (port of reftr_tpu/cli/presets.py:1-123).

Each preset is a dict of command-line overrides, the JAX package's table
key for key: the single-phrase REC detection presets
(reftr_tpu/cli/presets.py:14-18, :33-37, :59-64, :65-69, :70-76), the RES
presets (:19-32, :38-44), which fine-tune REC+RES from a detection
checkpoint (stage 2 of the reference's configs), the multi-phrase
Flickr30k presets with BERT and RoBERTa (:45-57), the Visual Genome
pre-training and the fine-tunes from it (:64-69, :78-92), the ``_101``
variants (:94-98) and ``synthetic_smoke`` (:101-109). ``apply_preset``
sets them on parsed arguments (flags given explicitly win);
``preset_config`` gives a preset's RefTRConfig directly.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict

from reftr_torch.core.config import (BertConfig, DataConfig, LossConfig,
                                     ModelConfig, RefTRConfig, TrainConfig)

_REC = dict(num_feature_levels=1, dec_layers=6, aux_loss=True, img_size=640,
            max_img_size=640, epochs=90, lr_drop=60)
_RES = dict(_REC, masks=True, lr=1e-5, lr_mask_branch_proj=10.0, epochs=40,
            lr_drop=30)
_FLICKR = dict(num_feature_levels=1, dataset="flickr30k", dec_layers=6,
               img_size=640, max_img_size=640, batch_size=16, epochs=60,
               warm_up_epoch=5, lr_schedule="CosineWarmupLR", aux_loss=True)

PRESETS: Dict[str, Dict] = {
    # configs/refcoco/RefTR_refcoco.sh stage 1 (REC detection)
    "refcoco_det": dict(_REC, dataset="refcoco_unc", train_split="train",
                        test_split=["val", "testA", "testB"]),
    # configs/refcoco/RefTR_refcoco.sh stage 2 (REC+RES fine-tune)
    "refcoco_seg": dict(_RES, dataset="refcoco_unc", train_split="train",
                        test_split=["val", "testA", "testB"]),
    # configs/refcoco+/RefTR_SEG_refcoco+.sh
    "refcoco_plus_seg": dict(_RES, num_queries_per_phrase=1,
                             dataset="refcoco+_unc", train_split="train",
                             test_split=["testA", "testB"]),
    # configs/refcoco+/RefTR_refcoco+.sh (REC detection)
    "refcoco_plus_det": dict(_REC, num_queries_per_phrase=1,
                             dataset="refcoco+_unc", train_split="train",
                             test_split=["val", "testA", "testB"]),
    # configs/refcocog/RefTR_refcocog.sh (umd split)
    "refcocog_det": dict(_REC, dataset="refcocog_umd", train_split="train",
                         test_split=["val"]),
    "refcocog_seg": dict(_RES, dataset="refcocog_umd", train_split="train",
                         test_split=["val"]),
    # configs/referit/RefTR_referit.sh
    "referit": dict(_REC, dataset="referit", train_split="trainval",
                    test_split=["test"]),
    # configs/flickr30k/RefTR_flickr.sh (multi-phrase)
    "flickr": _FLICKR,
    # configs/flickr30k/RefTR_flickr_roberta.sh
    "flickr_roberta": dict(_FLICKR, bert_model="roberta-base"),
    # configs/flickr30k/Ref_flickr_pt.sh (VG pretraining)
    "vg_pretrain": dict(_REC, dataset="vg", train_split="all",
                        test_split=["val"], epochs=6, lr_drop=4),
    # configs/referit/RefTR_referit_PT.sh: fine-tune from a VG-pretrained
    # checkpoint (--resume)
    "referit_pt": dict(_REC, num_queries_per_phrase=1, dataset="referit",
                       train_split="trainval", test_split=["test"],
                       ckpt_cycle=90, resume_model_only=True),
    # configs/flickr30k/Ref_flickr_pt.sh: the flickr fine-tune from VG
    # pretraining (--resume)
    "flickr_pt": dict(num_feature_levels=1, num_queries_per_phrase=1,
                      dataset="flickr30k", dec_layers=6, aux_loss=True,
                      img_size=640, max_img_size=640, epochs=40, lr_drop=30,
                      resume_model_only=True),
}
# ResNet-101 variants (configs/**/*_101.sh differ only in --backbone)
for _name in ("refcoco_det", "refcoco_seg", "refcoco_plus_det",
              "refcoco_plus_seg", "refcocog_det", "refcocog_seg",
              "referit", "referit_pt", "flickr_pt"):
    PRESETS[f"{_name}_101"] = dict(PRESETS[_name], backbone="resnet101")

PRESETS.update({
    # the smoke preset on the synthetic fixture (no data needed)
    "synthetic_smoke": dict(
        dataset="synthetic", train_split="train", test_split=["val"],
        img_size=64, max_img_size=64, batch_size=16, epochs=2,
        enc_layers=2, dec_layers=2, dim_feedforward=128, hidden_dim=64,
        nheads=4, lr=3e-4, lr_backbone=3e-4, lr_schedule="CosineWarmupLR",
        warm_up_epoch=1, aux_loss=True, dtype="float32", num_workers=4,
        bert_size="tiny", num_feature_levels=1,
    ),
})


def apply_preset(args, name: str, argv=None) -> None:
    """Set a preset's values on parsed ``args``, but for the flags given
    explicitly in ``argv`` (the reference's ``config.sh ${PY_ARGS}``
    order)."""
    argv = argv if argv is not None else sys.argv[1:]
    explicit = {a.split("=")[0].lstrip("-") for a in argv
                if a.startswith("--")}
    for k, v in PRESETS[name].items():
        if k not in explicit:
            setattr(args, k, v)


def preset_config(name: str, **overrides) -> RefTRConfig:
    """The RefTRConfig of a preset over the configs' defaults; keyword
    overrides win, as explicit flags win over a preset. Keys are config
    fields, plus the preset keys ``test_split`` (data.test_splits) and
    ``bert_size`` ("tiny": BertConfig.tiny()); a roberta-* ``bert_model``
    takes BertConfig.roberta_base(); lr_bert follows lr_backbone unless it
    is given, as on the command line."""
    values = dict(PRESETS[name], **overrides)
    if "lr_backbone" in values:
        values.setdefault("lr_bert", values["lr_backbone"])
    sections = {"model": ModelConfig, "loss": LossConfig, "data": DataConfig,
                "train": TrainConfig}
    kwargs: Dict[str, Dict] = {s: {} for s in sections}
    if "test_split" in values:
        values["test_splits"] = tuple(values.pop("test_split"))
    roberta = values.get("bert_model", "").split("-")[0] == "roberta"
    if values.pop("bert_size", "base") == "tiny":
        kwargs["model"]["bert"] = BertConfig.tiny()
    elif roberta:
        kwargs["model"]["bert"] = BertConfig.roberta_base()
    if "bert" in kwargs["model"]:
        kwargs["model"]["bert"].is_roberta = roberta
    for key, value in values.items():
        owner = [s for s, tp in sections.items()
                 if key in {f.name for f in dataclasses.fields(tp)}]
        if not owner:
            raise KeyError(f"preset key {key!r} is no config field")
        kwargs[owner[0]][key] = value
    return RefTRConfig(**{s: tp(**kwargs[s]) for s, tp in sections.items()})
