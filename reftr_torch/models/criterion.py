"""Training losses of REC and RES (port of reftr_tpu/models/criterion.py:
34-185).

L1 and GIoU box losses over padded phrases weighted by their validity,
normalised by the box count (``compute_num_boxes``: under DDP the global
count over the world size, clamped at one), with the
auxiliary decoder layers' losses under ``_<i>`` suffixes; with masks, the
focal and DICE mask losses on logits upsampled to the target, and the CEM
loss when the model gives one; with the vision probe's logits
(``vision_aux``), ``loss_vision``. The matcher is not on this path: with one
query per phrase the criterion is matcher-free
(reftr_tpu/core/config.py:244-248).

Targets: boxes [B, P, 4] normalised cxcywh, box_valid [B, P] bool; RES
adds masks [B, Hm, Wm] binary and mask_valid [B] bool.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from reftr_torch.core import distributed
from reftr_torch.core.config import LossConfig
from reftr_torch.ops.boxes import (box_cxcywh_to_xyxy,
                                   generalized_box_iou_aligned,
                                   valid_cell_centres)
from reftr_torch.ops.losses import dice_loss, sigmoid_focal_loss


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


def loss_masks(pred_masks: torch.Tensor, target_masks: torch.Tensor,
               mask_valid: torch.Tensor, cfg: LossConfig
               ) -> Dict[str, torch.Tensor]:
    """Focal and DICE losses (reftr_segmentation.py:314-337 of the
    reference). pred_masks [B, k, h, w] logits, bilinearly upsampled
    (align_corners=False, as jax.image.resize "linear" samples) to the
    target's size; target_masks [B, Hm, Wm], shared by the k queries;
    mask_valid [B]. The denominator is b * k (:332-333)."""
    b, k = pred_masks.shape[:2]
    if pred_masks.shape[2:] != target_masks.shape[1:]:
        pred_masks = F.interpolate(pred_masks, size=target_masks.shape[1:],
                                   mode="bilinear", align_corners=False)
    src = pred_masks.reshape(b * k, -1)
    tgt = target_masks[:, None].expand_as(pred_masks).reshape(b * k, -1)
    tgt = tgt.to(src.dtype)
    w = mask_valid.to(src.dtype).repeat_interleave(k)
    denom = float(b * k)
    return {
        "loss_mask": sigmoid_focal_loss(src, tgt, denom, cfg.focal_alpha,
                                        cfg.focal_gamma, weights=w),
        "loss_dice": dice_loss(src, tgt, denom, weights=w),
    }


def loss_vision(outputs: Dict[str, Any], targets: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The vision probe's in-box BCE (vision_aux; port of
    reftr_tpu/models/criterion.py:86-122): a cell is positive where its
    centre (``valid_cell_centres``, the boxes' frame) lies inside any valid
    target box, edges included; the BCE of the logits, in float32, is
    averaged over the valid cells of each level, then over the levels."""
    boxes = targets["boxes"].float()  # [B, P, 4] cxcywh
    bval = targets["box_valid"].bool()  # [B, P]
    total = 0.0
    levels = outputs["vision_logits"]
    for logits, valid in zip(levels, outputs["vision_valid"]):
        cx, cy = valid_cell_centres(valid)
        inx = ((cx[:, None] - boxes[..., 0:1]).abs()
               <= boxes[..., 2:3] / 2)  # [B, P, w]
        iny = ((cy[:, None] - boxes[..., 1:2]).abs()
               <= boxes[..., 3:4] / 2)  # [B, P, h]
        inside = (iny[:, :, :, None] & inx[:, :, None, :]
                  & bval[:, :, None, None]).any(1)  # [B, h, w]
        lg = logits.float()
        bce = (lg.clamp(min=0.0) - lg * inside.float()
               + torch.log1p(torch.exp(-lg.abs())))
        vw = valid.float()
        total = total + (bce * vw).sum() / vw.sum().clamp(min=1.0)
    return {"loss_vision": total / len(levels)}


def compute_num_boxes(box_valid: torch.Tensor) -> torch.Tensor:
    """The count each rank divides its box losses by: the reference's DDP
    count, the batch's boxes summed over the ranks (all_reduce), divided
    by the world size and clamped at 1; one process: the batch's count,
    clamped at 1.

    DDP averages the ranks' gradients, so a rank's loss over this count
    gives the gradient of the global batch's loss over max(global count,
    world size), which is JAX's ``compute_num_boxes(box_valid, world_size)``
    (reftr_tpu/models/criterion.py:125-128) over the global batch. A rank
    that divided by its own count would be wrong by the spread of the
    counts across ranks."""
    n = box_valid.to(torch.float32).sum()
    world = distributed.world_size()
    if world > 1:
        dist.all_reduce(n)
        n = n / world
    return n.clamp(min=1.0)


def criterion(outputs: Dict[str, Any], targets: Dict[str, torch.Tensor],
              cfg: LossConfig, with_masks: bool = False
              ) -> Dict[str, torch.Tensor]:
    """The unweighted loss dict (weights are applied by ``weight_dict``)."""
    num_boxes = compute_num_boxes(targets["box_valid"])
    losses = loss_boxes(outputs["pred_boxes"], outputs["phrase_mask"],
                        targets["boxes"], num_boxes)
    if "vision_logits" in outputs:
        losses.update(loss_vision(outputs, targets))
    if with_masks and "pred_masks" in outputs:
        losses.update(loss_masks(outputs["pred_masks"], targets["masks"],
                                 targets["mask_valid"], cfg))
        if "cem_loss" in outputs:
            losses["loss_cem"] = outputs["cem_loss"]
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        aux_losses = loss_boxes(aux["pred_boxes"], aux["phrase_mask"],
                                targets["boxes"], num_boxes)
        losses.update({f"{k}_{i}": v for k, v in aux_losses.items()})
    return losses


def weight_dict(cfg: LossConfig, dec_layers: int, aux_loss: bool,
                with_masks: bool = False, vision_aux: bool = False,
                heatmap_box: bool = False) -> Dict[str, float]:
    """Loss weights (reftr_transformer.py:320-329, reftr_segmentation.py:
    349-360), aux layers included; the mask terms and loss_vision get no
    aux copies. With heatmap_box the decoder's last layer is one more aux
    entry (``RefTR.forward``). A model's are those of its config's
    ``masks``, ``vision_aux`` and ``heatmap_box``, as the JAX factory
    passes them (reftr_tpu/models/build.py:60-63)."""
    wd = {"loss_giou": cfg.giou_loss_coef, "loss_bbox": cfg.bbox_loss_coef}
    if vision_aux:
        wd["loss_vision"] = cfg.vision_aux_coef
    if with_masks:
        wd.update({"loss_dice": cfg.dice_loss_coef,
                   "loss_mask": cfg.mask_loss_coef,
                   "loss_cem": cfg.cem_loss_coef})
    if aux_loss:
        base = {k: v for k, v in wd.items()
                if k in ("loss_giou", "loss_bbox")}
        n_aux = dec_layers if vision_aux and heatmap_box else dec_layers - 1
        for i in range(n_aux):
            wd.update({f"{k}_{i}": v for k, v in base.items()})
    return wd


def total_loss(losses: Dict[str, torch.Tensor],
               wd: Dict[str, float]) -> torch.Tensor:
    """Weighted sum over the losses present in the weight dict
    (engine_vg.py:44)."""
    return sum(losses[k] * wd[k] for k in losses if k in wd)
