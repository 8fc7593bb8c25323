"""Affine augmentation and letterbox (port of reftr_tpu/data/affine.py,
the reference's util/transforms.py:16-117).

As in the JAX package (and the reference, whose live pipelines leave them
out), these are opt-in: ``letterbox`` resizes to a padded square, and
``random_affine`` warps by shear @ translate @ (rotate + scale) onto a
square canvas of the long side with an ImageNet-mean border, its boxes
re-fitted by warping their corners, taking the bounding box, shrinking
w and h by sqrt(max(|sin a|, |cos a|)) and clipping to the canvas. Both
import cv2 when called (the card's machine has none; nothing of the port
calls them there).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

IMAGENET_BORDER = (123.7, 116.3, 103.5)


def letterbox(img: np.ndarray, mask: Optional[np.ndarray], height: int,
              color=IMAGENET_BORDER):
    """Resize to a padded square of side `height`; returns
    (img, mask, ratio, dw, dh) like the reference."""
    import cv2

    shape = img.shape[:2]
    ratio = float(height) / max(shape)
    new_shape = (round(shape[1] * ratio), round(shape[0] * ratio))
    dw = (height - new_shape[0]) / 2
    dh = (height - new_shape[1]) / 2
    top, bottom = round(dh - 0.1), round(dh + 0.1)
    left, right = round(dw - 0.1), round(dw + 0.1)
    img = cv2.resize(img, new_shape, interpolation=cv2.INTER_AREA)
    img = cv2.copyMakeBorder(img, top, bottom, left, right,
                             cv2.BORDER_CONSTANT, value=color)
    if mask is not None:
        mask = cv2.resize(mask, new_shape, interpolation=cv2.INTER_NEAREST)
        mask = cv2.copyMakeBorder(mask, top, bottom, left, right,
                                  cv2.BORDER_CONSTANT, value=255)
    return img, mask, ratio, dw, dh


def _affine_matrix(shape_hw: Tuple[int, int], rng: np.random.Generator,
                   degrees, translate, scale, shear):
    h, w = shape_hw
    a = rng.random() * (degrees[1] - degrees[0]) + degrees[0]
    s = rng.random() * (scale[1] - scale[0]) + scale[0]
    rad = math.radians(a)  # cv2.getRotationMatrix2D convention (CCW-positive)
    cx, cy = w / 2, h / 2
    alpha, beta = s * math.cos(rad), s * math.sin(rad)
    R = np.array([
        [alpha, beta, (1 - alpha) * cx - beta * cy],
        [-beta, alpha, beta * cx + (1 - alpha) * cy],
        [0, 0, 1],
    ])
    T = np.eye(3)
    T[0, 2] = (rng.random() * 2 - 1) * translate[0] * h
    T[1, 2] = (rng.random() * 2 - 1) * translate[1] * w
    S = np.eye(3)
    S[0, 1] = math.tan(math.radians(
        rng.random() * (shear[1] - shear[0]) + shear[0]))
    S[1, 0] = math.tan(math.radians(
        rng.random() * (shear[1] - shear[0]) + shear[0]))
    return S @ T @ R, a


def wrap_points(box_xyxy: np.ndarray, M: np.ndarray, height: int,
                angle_deg: float) -> np.ndarray:
    """Warp a box through M: corner AABB + angle-based shrink + clip
    (util/transforms.py:78-117)."""
    p = np.asarray(box_xyxy, np.float64)
    xy = np.ones((4, 3))
    xy[:, :2] = p[[0, 1, 2, 3, 0, 3, 2, 1]].reshape(4, 2)
    xy = (xy @ M.T)[:, :2]
    x, y = xy[:, 0], xy[:, 1]
    x0, y0, x1, y1 = x.min(), y.min(), x.max(), y.max()
    reduction = max(abs(math.sin(math.radians(angle_deg))),
                    abs(math.cos(math.radians(angle_deg)))) ** 0.5
    cx, cy = (x1 + x0) / 2, (y1 + y0) / 2
    w = (x1 - x0) * reduction
    h = (y1 - y0) * reduction
    out = np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
    return np.clip(out, 0, height).astype(np.float32)


def random_affine(
    img: np.ndarray,
    mask: Optional[np.ndarray],
    boxes_xyxy: np.ndarray,  # [N, 4] pixels
    rng: np.random.Generator,
    degrees=(-10, 10),
    translate=(0.1, 0.1),
    scale=(0.9, 1.1),
    shear=(-2, 2),
    border_value=IMAGENET_BORDER,
):
    """Returns (warped img [S,S,3], warped mask or None, boxes [N,4])."""
    import cv2

    height = max(img.shape[0], img.shape[1])
    M, a = _affine_matrix(img.shape[:2], rng, degrees, translate, scale,
                          shear)
    imw = cv2.warpPerspective(img, M, dsize=(height, height),
                              flags=cv2.INTER_LINEAR,
                              borderValue=border_value)
    maskw = None
    if mask is not None:
        maskw = cv2.warpPerspective(mask, M, dsize=(height, height),
                                    flags=cv2.INTER_NEAREST, borderValue=255)
    boxes = np.stack([wrap_points(b, M, height, a)
                      for b in np.asarray(boxes_xyxy).reshape(-1, 4)])
    return imw, maskw, boxes
