"""Training losses of the REC path (port of reftr_tpu/models/criterion.py:
34-52, 125-185).

L1 and GIoU box losses over padded phrases weighted by their validity,
normalised by the batch's box count clamped at one, with the
auxiliary decoder layers' losses under ``_<i>`` suffixes. The matcher is
not on this path: with one query per phrase the criterion is matcher-free
(reftr_tpu/core/config.py:244-248).

Targets: boxes [B, P, 4] normalised cxcywh, box_valid [B, P] bool.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from reftr_torch.core.config import LossConfig
from reftr_torch.ops.boxes import (box_cxcywh_to_xyxy,
                                   generalized_box_iou_aligned)


def loss_boxes(pred_boxes: torch.Tensor, phrase_mask: torch.Tensor,
               target_boxes: torch.Tensor, num_boxes: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """pred_boxes [B, P, k, 4] cxcywh; phrase_mask [B, P*k] bool;
    target_boxes [B, P, 4] cxcywh; num_boxes the box count (a scalar)."""
    b, p, k, _ = pred_boxes.shape
    valid = phrase_mask.reshape(b, p, k).to(pred_boxes.dtype)
    tgt = target_boxes[:, :, None, :].expand_as(pred_boxes)
    l1 = (pred_boxes - tgt).abs().sum(-1) * valid
    giou = 1.0 - generalized_box_iou_aligned(box_cxcywh_to_xyxy(pred_boxes),
                                             box_cxcywh_to_xyxy(tgt))
    giou = giou * valid
    denom = num_boxes * k
    return {"loss_bbox": l1.sum() / denom, "loss_giou": giou.sum() / denom}


def loss_masks(*args, **kwargs):
    raise NotImplementedError("the RES mask losses come with a later slice")


def loss_vision(*args, **kwargs):
    raise NotImplementedError("vision_aux comes with a later slice")


def compute_num_boxes(box_valid: torch.Tensor) -> torch.Tensor:
    """The batch's box count, clamped at 1 as the reference clamps it."""
    return box_valid.to(torch.float32).sum().clamp(min=1.0)


def criterion(outputs: Dict[str, Any], targets: Dict[str, torch.Tensor],
              cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """The unweighted loss dict (weights are applied by ``weight_dict``)."""
    num_boxes = compute_num_boxes(targets["box_valid"])
    losses = loss_boxes(outputs["pred_boxes"], outputs["phrase_mask"],
                        targets["boxes"], num_boxes)
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        aux_losses = loss_boxes(aux["pred_boxes"], aux["phrase_mask"],
                                targets["boxes"], num_boxes)
        losses.update({f"{k}_{i}": v for k, v in aux_losses.items()})
    return losses


def weight_dict(cfg: LossConfig, dec_layers: int,
                aux_loss: bool) -> Dict[str, float]:
    """Loss weights (reftr_transformer.py:320-329), aux layers included."""
    wd = {"loss_giou": cfg.giou_loss_coef, "loss_bbox": cfg.bbox_loss_coef}
    if aux_loss:
        base = dict(wd)
        for i in range(dec_layers - 1):
            wd.update({f"{k}_{i}": v for k, v in base.items()})
    return wd


def total_loss(losses: Dict[str, torch.Tensor],
               wd: Dict[str, float]) -> torch.Tensor:
    """Weighted sum over the losses present in the weight dict
    (engine_vg.py:44)."""
    return sum(losses[k] * wd[k] for k in losses if k in wd)
