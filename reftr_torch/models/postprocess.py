"""Output decoding, REC metrics and RES masks (port of
reftr_tpu/models/postprocess.py:22-108).

P@0.5 and mIoU are computed in normalised cxcywh -> xyxy space, as in the
reference's evaluation; boxes are scaled to pixels only on request. Mask
logits are upsampled bilinearly (align_corners=False) before the sigmoid
is thresholded, in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


def _upsample(logits: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear, align_corners=False, in float32 whatever autocast says."""
    with torch.autocast(logits.device.type, enabled=False):
        return F.interpolate(logits.float(), size=tuple(out_hw),
                             mode="bilinear", align_corners=False)


def segm_metrics(pred_mask_logits: torch.Tensor, target_masks: torch.Tensor,
                 image_valid: torch.Tensor, threshold: float = 0.5,
                 mask_valid: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Sums for the seg mIoU (engine_vg.py:144-155): sum_seg_iou and
    cnt_seg. pred_mask_logits [B, k, h, w], upsampled to the canvas;
    target_masks [B, H, W]; image_valid [B, H, W] (the crop to the
    image's extent); mask_valid [B] (batch padding)."""
    b = pred_mask_logits.shape[0]
    up = _upsample(pred_mask_logits, target_masks.shape[1:])
    valid = image_valid.bool()
    pred = (torch.sigmoid(up[:, 0]) > threshold) & valid
    tgt = (target_masks > 0.5) & valid
    inter = (pred & tgt).sum((1, 2)).to(torch.float32)
    union = (pred | tgt).sum((1, 2)).to(torch.float32)
    iou = torch.where(union > 0, inter / union.clamp(min=1.0),
                      torch.zeros_like(union))
    if mask_valid is None:
        w = torch.ones(b, dtype=torch.float32, device=iou.device)
    else:
        w = mask_valid.to(torch.float32)
    return {"sum_seg_iou": (iou * w).sum(), "cnt_seg": w.sum()}


def segm_masks(pred_mask_logits: torch.Tensor, out_size: Tuple[int, int],
               threshold: float = 0.5) -> torch.Tensor:
    """The logits upsampled to ``out_size``, then sigmoid > threshold
    (reftr_segmentation.py:282-302: upsample first). Returns [B, k, H, W]
    bool."""
    return torch.sigmoid(_upsample(pred_mask_logits, out_size)) > threshold
