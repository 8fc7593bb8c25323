"""Image and target transforms on the host (port of
reftr_tpu/data/transforms.py:1-169).

The reference's pipelines (datasets/refer_resc.py:100-119 and
datasets/transforms.py of the reference RefTR) with static-shape outputs:

  train: RandomIntensitySaturation -> aspect-preserving resize (long side
         capped at max_img_size) -> pack onto a fixed canvas -> boxes
         xyxy -> cxcywh normalised by the resized (h, w)
  test:  the same without the colour jitter.

The resize target follows transforms.py:82-110; boxes are normalised by
the resized image, not the canvas (transforms.py:247-263), whose padding
is masked; masks are resized by nearest neighbour and thresholded at 0.5
(transforms.py:133-135). Images stay uint8; the /255 and ImageNet
normalisation runs on the device (reftr_torch/ops/image.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from reftr_torch.data import native


def crop(image: np.ndarray, boxes_xyxy: np.ndarray,
         region: Tuple[int, int, int, int],
         masks: Optional[np.ndarray] = None):
    """Paired crop with DETR's semantics (transforms.py:21-61).

    region = (top, left, h, w). Boxes are translated and clamped to the
    crop, and those whose clamped box is empty are dropped, with their
    masks ([N, H, W]). Returns (image, boxes, keep[, masks]). No live
    pipeline of the reference uses it (make_refer_transforms adds no
    RandomCrop)."""
    i, j, h, w = region
    out_img = image[i:i + h, j:j + w]
    boxes = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4).copy()
    boxes -= np.array([j, i, j, i], np.float32)
    boxes = np.minimum(boxes.reshape(-1, 2, 2),
                       np.array([w, h], np.float32))
    boxes = np.clip(boxes, 0, None)
    keep = np.all(boxes[:, 1, :] > boxes[:, 0, :], axis=1)
    boxes = boxes.reshape(-1, 4)[keep]
    if masks is not None:
        out_masks = masks[..., i:i + h, j:j + w]
        if out_masks.ndim == 3:
            out_masks = out_masks[keep]
        return out_img, boxes, keep, out_masks
    return out_img, boxes, keep


def hflip(image: np.ndarray, boxes_xyxy: np.ndarray,
          masks: Optional[np.ndarray] = None):
    """Paired horizontal flip (transforms.py:64-78)."""
    out_img = image[:, ::-1].copy()
    w = image.shape[1]
    boxes = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4)
    boxes = (boxes[:, [2, 1, 0, 3]] * np.array([-1, 1, -1, 1], np.float32)
             + np.array([w, 0, w, 0], np.float32))
    if masks is not None:
        return out_img, boxes, np.flip(masks, axis=-1).copy()
    return out_img, boxes


def center_crop_region(h: int, w: int, crop_h: int,
                       crop_w: int) -> Tuple[int, int, int, int]:
    """CenterCrop's region (transforms.py:174-183)."""
    top = int(round((h - crop_h) / 2.0))
    left = int(round((w - crop_w) / 2.0))
    return top, left, crop_h, crop_w


def random_crop_region(h: int, w: int, crop_h: int, crop_w: int,
                       rng: np.random.Generator):
    """torchvision's RandomCrop.get_params (transforms.py:158)."""
    if h == crop_h and w == crop_w:
        return 0, 0, h, w
    top = int(rng.integers(0, h - crop_h + 1))
    left = int(rng.integers(0, w - crop_w + 1))
    return top, left, crop_h, crop_w


def resize_target_hw(h: int, w: int, size: int,
                     max_size: Optional[int]) -> Tuple[int, int]:
    """The (h, w) of the reference's aspect-preserving resize."""
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


@dataclasses.dataclass
class TransformedSample:
    canvas: np.ndarray  # [S, S, 3] uint8
    valid_hw: Tuple[int, int]  # the resized image's extent on the canvas
    boxes_cxcywh: np.ndarray  # [N, 4] normalised by valid_hw
    mask_canvas: Optional[np.ndarray] = None  # [S, S] float {0, 1}
    orig_hw: Tuple[int, int] = (0, 0)


def transform_sample(
    image: np.ndarray,  # [H, W, 3] uint8 RGB
    boxes_xyxy: np.ndarray,  # [N, 4] pixels of the original image
    img_size: int,
    max_img_size: int,
    train: bool,
    rng: Optional[np.random.Generator] = None,
    hsv_fraction: float = 0.5,
    seg_mask: Optional[np.ndarray] = None,  # [H, W] binary
) -> TransformedSample:
    h, w = image.shape[:2]
    if train:
        if rng is None:
            raise ValueError("a train transform needs rng")
        # NB the reference's RandomIntensitySaturation draws a saturation
        # factor but never multiplies it into S (transforms.py:272-275 only
        # clips) — the live behavior is VALUE-only jitter. We draw both
        # factors (same rng stream shape) but apply s=1.0 to match.
        _s_unused = float((rng.random() * 2 - 1) * hsv_fraction + 1)
        v = float((rng.random() * 2 - 1) * hsv_fraction + 1)
        image = native.hsv_jitter(image, 1.0, v)

    oh, ow = resize_target_hw(h, w, img_size, max_img_size)
    resized = native.resize_bilinear(image, (oh, ow))
    canvas = native.pack_canvas(resized, (max_img_size, max_img_size))

    boxes = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4).copy()
    rw, rh = ow / w, oh / h
    boxes *= np.array([rw, rh, rw, rh], np.float32)
    # xyxy -> cxcywh normalised by the resized extent
    cx = (boxes[:, 0] + boxes[:, 2]) / 2 / ow
    cy = (boxes[:, 1] + boxes[:, 3]) / 2 / oh
    bw = (boxes[:, 2] - boxes[:, 0]) / ow
    bh = (boxes[:, 3] - boxes[:, 1]) / oh
    out_boxes = np.stack([cx, cy, bw, bh], axis=1).astype(np.float32)

    mask_canvas = None
    if seg_mask is not None:
        # nearest resize and > 0.5 (the mask is binary)
        ys = np.floor(np.arange(oh) * (h / oh)).astype(np.int64)
        xs = np.floor(np.arange(ow) * (w / ow)).astype(np.int64)
        mres = (seg_mask[ys][:, xs] > 0.5).astype(np.float32)
        mask_canvas = np.zeros((max_img_size, max_img_size), np.float32)
        mask_canvas[:oh, :ow] = mres

    return TransformedSample(
        canvas=canvas, valid_hw=(oh, ow), boxes_cxcywh=out_boxes,
        mask_canvas=mask_canvas, orig_hw=(h, w))
