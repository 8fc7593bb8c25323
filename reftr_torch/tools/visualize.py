"""Qualitative eval dumps: predicted and true boxes, masks, attention maps
(port of reftr_tpu/tools/visualize.py, which rebuilds the reference's
--eval visualisation, engine_vg.py:86-95, 156-197, with PIL instead of
matplotlib). PIL is imported by each function that draws.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _to_pil(img: np.ndarray):
    from PIL import Image

    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return Image.fromarray(img)


def draw_boxes(image: np.ndarray, boxes_xyxy: np.ndarray,
               colors: Optional[Sequence[str]] = None, width: int = 2):
    """image: [H, W, 3] uint8; boxes in pixels. Returns a PIL image."""
    from PIL import ImageDraw

    im = _to_pil(image.copy())
    draw = ImageDraw.Draw(im)
    colors = colors or ["red", "lime", "blue", "yellow", "cyan", "magenta"]
    for i, b in enumerate(np.asarray(boxes_xyxy).reshape(-1, 4)):
        draw.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])],
                       outline=colors[i % len(colors)], width=width)
    return im


def heatmap_image(att: np.ndarray):
    """[h, w] attention map -> viridis-ish PIL image."""
    a = np.asarray(att, np.float32)
    a = (a - a.min()) / (a.max() - a.min() + 1e-8)
    # simple 3-stop colormap (dark blue -> green -> yellow)
    r = np.clip(2 * a - 1, 0, 1)
    g = np.clip(2 * a, 0, 1) * 0.9
    b = np.clip(1 - 2 * a, 0, 1) * 0.6 + 0.2 * (1 - a)
    rgb = np.stack([r, g, b], axis=-1)
    return _to_pil((rgb * 255).astype(np.uint8))


def dump_eval_visuals(
    output_dir: str,
    sample_id: int,
    image_u8: np.ndarray,  # [H, W, 3] canvas
    pred_box_xyxy: np.ndarray,  # pixels on the canvas
    gt_box_xyxy: np.ndarray,
    pred_mask: Optional[np.ndarray] = None,  # [H, W] bool
    gt_mask: Optional[np.ndarray] = None,
    attention: Optional[np.ndarray] = None,  # [heads, h, w]
) -> None:
    """Writes <output_dir>/vis/{boxes,mask,gt_mask,att}/NNNNN*.jpg."""
    vis = os.path.join(output_dir, "vis")
    for sub in ("boxes", "mask", "gt_mask", "att"):
        os.makedirs(os.path.join(vis, sub), exist_ok=True)
    both = np.stack([pred_box_xyxy, gt_box_xyxy]).reshape(-1, 4)
    draw_boxes(image_u8, both).save(
        os.path.join(vis, "boxes", f"{sample_id:05d}.jpg"))
    if pred_mask is not None:
        _to_pil((pred_mask.astype(np.uint8)) * 255).save(
            os.path.join(vis, "mask", f"{sample_id:05d}.jpg"))
    if gt_mask is not None:
        _to_pil((np.asarray(gt_mask) > 0.5).astype(np.uint8) * 255).save(
            os.path.join(vis, "gt_mask", f"{sample_id:05d}.jpg"))
    if attention is not None:
        for h in range(attention.shape[0]):
            heatmap_image(attention[h]).save(
                os.path.join(vis, "att", f"{sample_id:05d}_h{h}.jpg"))
