"""Grounding datasets of the single-phrase REC and RES paths (port of
reftr_tpu/data/datasets.py:27-172, 310-482).

  * ReferDatasetResc: single-phrase REC over resc-format annotations
    (resc_refer_dataset.py of the reference RefTR): refcoco/+/g (boxes
    xywh -> xyxy), referit, flickr single-phrase, visual genome.
  * ReferSegDataset: REC + RES over refcoco's segmentation annotations,
    each mask a .npy file under ``mask_dir`` (refer_dataset.py:213-318).
  * SyntheticGroundingDataset: an in-memory fixture (no files) of coloured
    rectangles and template phrases, made from the item's index; with
    ``with_masks`` each mask is its box's rectangle.

Every item is a pair of numpy dicts of static shapes, ready to stack:
image [S, S, 3] uint8, image_valid [S, S] bool, sentence and
sentence_valid [L] int32; boxes [1, 4] normalised cxcywh, box_valid [1],
orig_size [2], size [2], image_id; with masks, masks [S, S] float32 {0, 1}
and mask_valid (a bool scalar). The multi-phrase dataset comes with a
later slice (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List, Optional, Tuple

import numpy as np

from reftr_torch.data.native import WordPieceTokenizer
from reftr_torch.data.transforms import transform_sample

# split tables: resc_refer_dataset.py:58-78
SUPPORTED_DATASETS = {
    "referit": {"splits": ("train", "val", "trainval", "test")},
    "unc": {"splits": ("train", "val", "trainval", "testA", "testB")},
    "unc+": {"splits": ("train", "val", "trainval", "testA", "testB")},
    "gref": {"splits": ("train", "val")},
    "gref_umd": {"splits": ("train", "val", "test")},
    "flickr": {"splits": ("train", "val", "test")},
    "vg": {"splits": ("all",)},
}


def load_annotations(data_root: str, dataset: str,
                     split: str) -> List[tuple]:
    """The {dataset}_{split} annotations (resc_refer_dataset.py:110-116);
    trainval is train + val but for referit. A .json file is read first,
    else the reference's .pth pickle by torch.load."""
    path = osp.join(data_root, dataset)
    if split not in SUPPORTED_DATASETS[dataset]["splits"]:
        raise ValueError(f"{dataset} has no split {split}")
    splits = [split]
    if dataset != "referit" and split == "trainval":
        splits = ["train", "val"]
    images: List[tuple] = []
    for s in splits:
        json_path = osp.join(path, f"{dataset}_{s}.json")
        if osp.exists(json_path):
            with open(json_path) as f:
                images += [tuple(r) for r in json.load(f)]
        else:
            import torch

            images += torch.load(osp.join(path, f"{dataset}_{s}.pth"),
                                 weights_only=False)
    return images


def _load_image(path: str) -> np.ndarray:
    """RGB uint8 HWC, grayscale repeated over 3 channels
    (resc_refer_dataset.py:134-140): by cv2, else by PIL."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3 and img.shape[-1] == 3:
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return np.stack([img.squeeze()] * 3, axis=-1)


def _single_phrase_item(ts, ids, mask, canvas: int, idx: int):
    """The (sample, target) dicts of one transformed single-phrase item,
    with its mask when the transform made one."""
    oh, ow = ts.valid_hw
    valid = np.zeros((canvas, canvas), bool)
    valid[:oh, :ow] = True
    sample = {"image": ts.canvas, "image_valid": valid, "sentence": ids,
              "sentence_valid": mask}
    target = {"boxes": ts.boxes_cxcywh,  # [1, 4]
              "box_valid": np.ones(1, bool),
              "orig_size": np.array(ts.orig_hw, np.int32),
              "size": np.array(ts.valid_hw, np.int32),
              "image_id": np.asarray(idx, np.int32)}
    if ts.mask_canvas is not None:
        target["masks"] = ts.mask_canvas
        target["mask_valid"] = np.asarray(True)
    return sample, target


class ReferDatasetResc:
    """Single-phrase REC over resc-format annotations."""

    def __init__(self, data_root: str, im_dir: str, dataset: str, split: str,
                 tokenizer: WordPieceTokenizer, img_size: int = 640,
                 max_img_size: int = 640, max_query_len: int = 40,
                 train: bool = False, hsv_fraction: float = 0.5,
                 seed: int = 0):
        self.records = load_annotations(data_root, dataset, split)
        self.dataset = dataset
        self.im_dir = im_dir
        self.tokenizer = tokenizer
        self.img_size = img_size
        self.max_img_size = max_img_size
        self.max_query_len = max_query_len
        self.train = train
        self.hsv_fraction = hsv_fraction
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _rng(self, idx: int) -> np.random.Generator:
        # a generator per call: safe under the loader's threads and the
        # same for a (seed, epoch, item)
        return np.random.default_rng((self.seed, self.epoch, idx))

    def __len__(self):
        return len(self.records)

    def pull_item(self, idx: int):
        """(image uint8 HWC, phrase, box xyxy, file name), the formats
        fixed as in resc_refer_dataset.py:121-140."""
        rec = self.records[idx]
        if self.dataset in ("flickr", "vg"):
            img_file, bbox, phrase = rec[:3]
        else:
            img_file, _, bbox, phrase = rec[:4]
        bbox = np.array(bbox, dtype=np.int64).astype(np.float32)
        if self.dataset not in ("referit", "flickr"):
            bbox[2] += bbox[0]
            bbox[3] += bbox[1]
        img = _load_image(osp.join(self.im_dir, img_file))
        return img, str(phrase), bbox, img_file

    def __getitem__(self, idx: int) -> Tuple[Dict, Dict]:
        img, phrase, bbox, _ = self.pull_item(idx)
        ts = transform_sample(img, bbox[None], self.img_size,
                              self.max_img_size, self.train, self._rng(idx),
                              self.hsv_fraction)
        ids, mask, _ = self.tokenizer.encode(phrase.lower(),
                                             self.max_query_len)
        return _single_phrase_item(ts, ids, mask, self.max_img_size, idx)


class ReferSegDataset(ReferDatasetResc):
    """REC + RES: each record (img_file, seg_file, bbox xyxy, phrase) adds
    the mask in <mask_dir>/<seg_file>, a .npy array over the image."""

    def __init__(self, *args, mask_dir: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mask_dir = mask_dir

    def pull_item(self, idx: int):
        img_file, seg_file, bbox, phrase = self.records[idx][:4]
        img = _load_image(osp.join(self.im_dir, img_file))
        bbox = np.array(bbox, np.float32)
        return img, str(phrase), bbox, img_file, str(seg_file)

    def __getitem__(self, idx: int) -> Tuple[Dict, Dict]:
        img, phrase, bbox, _, seg_file = self.pull_item(idx)
        mask = np.load(osp.join(self.mask_dir, seg_file), allow_pickle=True)
        mask = (np.asarray(mask) > 0).astype(np.float32)
        ts = transform_sample(img, bbox[None], self.img_size,
                              self.max_img_size, self.train, self._rng(idx),
                              self.hsv_fraction, seg_mask=mask)
        ids, tmask, _ = self.tokenizer.encode(phrase.lower(),
                                              self.max_query_len)
        return _single_phrase_item(ts, ids, tmask, self.max_img_size, idx)


# ---------------------------------------------------------------------------
# synthetic fixture
# ---------------------------------------------------------------------------

_COLORS = {
    "red": (200, 40, 40), "green": (40, 180, 60), "blue": (40, 70, 200),
}
_SHAPES = ("box", "block")


class SyntheticGroundingDataset:
    """Coloured-rectangle grounding: phrase '<colour> <shape> on the
    <left|right>', box that rectangle, beside a distractor of another
    colour on the other side. Learnable end to end; no files. Item i is a
    function of i alone (``seed`` is accepted for the builders' signature
    and unused), made when it is read, so n can be large."""

    def __init__(self, tokenizer: WordPieceTokenizer, n: int = 128,
                 img_size: int = 64, max_query_len: int = 12,
                 with_masks: bool = False, seed: int = 0,
                 canvas: Optional[int] = None,
                 box_frac: Tuple[float, float] = (1 / 6, 1 / 3)):
        del seed
        self.tokenizer = tokenizer
        self.n = n
        self.img_size = img_size
        self.canvas = canvas or img_size
        self.max_query_len = max_query_len
        self.with_masks = with_masks
        # the rectangles' side range as a fraction of img_size
        self.box_frac = box_frac
        self._paths: Optional[List[str]] = None

    def export_images(self, out_dir: str) -> List[str]:
        """Write the fixture's images as JPEG files and have __getitem__
        decode them from disk (decode, resize and pack: a loader workload
        like a real dataset's). Needs PIL."""
        from PIL import Image

        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i in range(self.n):
            p = osp.join(out_dir, f"synth_{i:05d}.jpg")
            if not osp.exists(p):
                Image.fromarray(self._make(i)[0]).save(p, quality=95)
            paths.append(p)
        self._paths = paths
        return paths

    def _make(self, i):
        rng = np.random.default_rng(1000 + i)
        s = self.img_size
        img = np.full((s, s, 3), 128, np.uint8)
        img += rng.integers(-20, 20, size=img.shape).astype(np.uint8)
        color = list(_COLORS)[rng.integers(len(_COLORS))]
        side = "left" if rng.random() < 0.5 else "right"
        lo, hi = (max(2, int(s * f)) for f in self.box_frac)
        w = int(rng.integers(lo, hi))
        h = int(rng.integers(lo, hi))
        x0 = int(rng.integers(0, s // 2 - w)) if side == "left" else int(
            rng.integers(s // 2, s - w))
        y0 = int(rng.integers(0, s - h))
        img[y0:y0 + h, x0:x0 + w] = _COLORS[color]
        # a distractor of another colour on the other side
        other = [c for c in _COLORS if c != color][rng.integers(2)]
        ox = int(rng.integers(s // 2, s - w)) if side == "left" else int(
            rng.integers(0, s // 2 - w))
        oy = int(rng.integers(0, s - h))
        img[oy:oy + h, ox:ox + w] = _COLORS[other]
        phrase = f"the {color} {_SHAPES[int(rng.integers(2))]} on the {side}"
        box = np.array([x0, y0, x0 + w, y0 + h], np.float32)
        mask = None
        if self.with_masks:
            mask = np.zeros((s, s), np.float32)
            mask[y0:y0 + h, x0:x0 + w] = 1.0
        return img, phrase, box, mask

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        img, phrase, box, mask = self._make(idx)
        if self._paths is not None:
            img = _load_image(self._paths[idx])
        ts = transform_sample(img, box[None], self.img_size, self.canvas,
                              False, np.random.default_rng(idx),
                              seg_mask=mask)
        ids, tmask, _ = self.tokenizer.encode(phrase, self.max_query_len)
        return _single_phrase_item(ts, ids, tmask, self.canvas, idx)


SYNTHETIC_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]",
    "the", "red", "green", "blue", "box", "block", "on", "left", "right",
]


def write_synthetic_vocab(path: str) -> str:
    """A vocabulary file of SyntheticGroundingDataset's phrase templates."""
    with open(path, "w") as f:
        f.write("\n".join(SYNTHETIC_VOCAB) + "\n")
    return path
