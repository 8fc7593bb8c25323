"""Bounding-box utilities (port of reftr_tpu/ops/boxes.py:19-67).

All functions take arbitrary leading dimensions; IoU and GIoU are aligned
(elementwise), as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] (cx, cy, w, h) -> (x0, y0, x1, y1)."""
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x0, y0, x1, y1) -> (cx, cy, w, h)."""
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5,
                        x1 - x0, y1 - y0], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """[..., 4] xyxy -> [...] area."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise IoU of aligned xyxy boxes; returns (iou, union)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter / union, union


def generalized_box_iou_aligned(boxes1: torch.Tensor,
                                boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU of aligned xyxy boxes -> [...]."""
    iou, union = box_iou_aligned(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area
