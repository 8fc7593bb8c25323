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


def valid_cell_centres(valid: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """valid [B, h, w] bool -> the cell centres (xs [B, w], ys [B, h]) in
    the boxes' normalised frame, the valid extent of each image: (j + 0.5)
    over its count of valid columns (rows), at least 1. Cells past the
    extent get centres above 1. The JAX package's frame of the vision
    probe's target and of the heatmap box (reftr_tpu/models/criterion.py:
    103-107, models/reftr.py:283-286), whose centres skew where the valid
    extent is not a whole number of cells (a quirk kept as it is)."""
    _, h, w = valid.shape
    ncol = valid.any(1).sum(-1).clamp(min=1).float()
    nrow = valid.any(2).sum(-1).clamp(min=1).float()
    xs = ((torch.arange(w, dtype=torch.float32, device=valid.device) + 0.5)
          [None] / ncol[:, None])
    ys = ((torch.arange(h, dtype=torch.float32, device=valid.device) + 0.5)
          [None] / nrow[:, None])
    return xs, ys
