"""Output decoding and REC metrics (port of
reftr_tpu/models/postprocess.py:22-62).

P@0.5 and mIoU are computed in normalised cxcywh -> xyxy space, as in the
reference's evaluation; boxes are scaled to pixels only on request.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from reftr_torch.ops.boxes import box_cxcywh_to_xyxy, box_iou_aligned


def decode_boxes(pred_boxes: torch.Tensor,
                 target_sizes: Optional[torch.Tensor] = None,
                 scale_to_original_shape: bool = False) -> torch.Tensor:
    """Query 0 of each phrase as xyxy, optionally scaled by (h, w).
    pred_boxes [B, P, k, 4] -> [B, P, 4]."""
    boxes = box_cxcywh_to_xyxy(pred_boxes[:, :, 0, :])
    if scale_to_original_shape:
        if target_sizes is None:
            raise ValueError("scale_to_original_shape needs target_sizes")
        h, w = target_sizes[:, 0], target_sizes[:, 1]
        scale = torch.stack([w, h, w, h], dim=1).to(boxes.dtype)
        boxes = boxes * scale[:, None, :]
    return boxes


def rec_metrics(pred_boxes: torch.Tensor, target_boxes: torch.Tensor,
                box_valid: torch.Tensor,
                iou_threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """Sums for P@0.5 and mIoU: sum_accu, sum_iou and cnt (scalars).
    pred_boxes [B, P, k, 4]; target_boxes [B, P, 4] cxcywh; box_valid
    [B, P] bool."""
    pred = decode_boxes(pred_boxes)
    tgt = box_cxcywh_to_xyxy(target_boxes)
    iou, _ = box_iou_aligned(pred, tgt)
    v = box_valid.to(torch.float32)
    iou = torch.nan_to_num(iou, nan=0.0) * v
    return {
        "sum_accu": ((iou > iou_threshold).to(torch.float32) * v).sum(),
        "sum_iou": iou.sum(),
        "cnt": v.sum(),
    }
