"""Dataset registry of the single-phrase REC and RES paths (port of
reftr_tpu/data/build.py:1-134).

Maps --dataset names to datasets with the reference's directory layout
under ``data_root`` (datasets/__init__.py:17-132 of the reference RefTR):

  referit          -> resc 'referit'
  refcoco_unc / refcoco+_unc / refcocog_google / refcocog_umd -> resc
  vg               -> visual genome (split 'all'), other splits -> referit
  flickr30k_resc   -> single-phrase flickr
  flickr30k_refcoco-> flickr_resc, plus refcoco trainval for train
  synthetic        -> the in-memory fixture (train: synthetic_n items,
                      every other split: 64), with box-shaped masks
                      under masks
  masks            -> the segmentation dataset over refcoco's annotations
                      (<data_root>/refcoco/anns, masks under
                      <data_root>/refcoco/masks)

flickr30k (multi-phrase) raises NotImplementedError: it is ROADMAP.md
queue 1 item 4.
"""

from __future__ import annotations

import os.path as osp

from reftr_torch.core.config import DataConfig
from reftr_torch.data.datasets import (ReferDatasetResc, ReferSegDataset,
                                       SyntheticGroundingDataset)

REFCOCO_VERSIONS = {
    "refcoco_unc": "unc",
    "refcoco+_unc": "unc+",
    "refcocog_google": "gref",
    "refcocog_umd": "gref_umd",
}
SYNTHETIC_EVAL_N = 64


class ConcatDataset:
    """GeneralReferDataset (refer_resc.py:7-24)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = []
        total = 0
        for d in self.datasets:
            self._offsets.append(total)
            total += len(d)
        self._total = total

    def __len__(self):
        return self._total

    def __getitem__(self, idx):
        for d, off in zip(reversed(self.datasets), reversed(self._offsets)):
            if idx >= off:
                return d[idx - off]
        raise IndexError(idx)


def build_refer_dataset(split: str, cfg: DataConfig, tokenizer, train: bool,
                        masks: bool = False, seed: int = 0):
    if cfg.dataset == "flickr30k" or cfg.multi_phrase:
        raise NotImplementedError(
            "multi-phrase flickr30k is not ported yet: ROADMAP.md queue 1 "
            "item 4")
    if cfg.dataset == "synthetic":
        return SyntheticGroundingDataset(
            tokenizer, n=cfg.synthetic_n if train else SYNTHETIC_EVAL_N,
            img_size=cfg.img_size, canvas=cfg.max_img_size,
            max_query_len=cfg.max_query_len, with_masks=masks, seed=seed,
            box_frac=tuple(cfg.synthetic_box_frac))

    root = cfg.data_root
    common = dict(img_size=cfg.img_size, max_img_size=cfg.max_img_size,
                  max_query_len=cfg.max_query_len, train=train,
                  hsv_fraction=cfg.hsv_jitter, seed=seed)
    if masks:
        return ReferSegDataset(
            osp.join(root, "refcoco", "anns"),
            osp.join(root, "refcoco", "images", "train2014"),
            REFCOCO_VERSIONS.get(cfg.dataset, cfg.dataset), split, tokenizer,
            mask_dir=osp.join(root, "refcoco", "masks"), **common)
    anns = osp.join(root, "annotations_resc")
    images = {
        "referit": osp.join(root, "referit", "images"),
        "refcoco": osp.join(root, "refcoco", "images", "train2014"),
        "vg": osp.join(root, "visualgenome", "VG_100K"),
        "flickr": osp.join(root, "flickr30k", "f30k_images"),
    }

    def resc(im_dir: str, version: str, split_: str) -> ReferDatasetResc:
        return ReferDatasetResc(anns, im_dir, version, split_, tokenizer,
                                **common)

    if cfg.dataset == "referit":
        return resc(images["referit"], "referit", split)
    if cfg.dataset in REFCOCO_VERSIONS:
        return resc(images["refcoco"], REFCOCO_VERSIONS[cfg.dataset], split)
    if cfg.dataset == "vg":
        if split != "all":
            return resc(images["referit"], "referit", split)
        return resc(images["vg"], "vg", "all")
    if cfg.dataset == "flickr30k_resc":
        return resc(images["flickr"], "flickr", split)
    if cfg.dataset == "flickr30k_refcoco":
        f30k = resc(images["flickr"], "flickr", split)
        if not split.startswith("train"):
            return f30k
        return ConcatDataset([f30k, resc(images["refcoco"], "unc",
                                         "trainval")])
    raise NotImplementedError(cfg.dataset)
