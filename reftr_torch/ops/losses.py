"""Segmentation losses (port of reftr_tpu/ops/losses.py:17-63).

DICE and sigmoid focal loss over flattened masks, with optional
per-sample weights so that padded batch rows count zero.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor,
              num_boxes: Union[torch.Tensor, float],
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs [N, L] logits; targets [N, L] binary; weights optional [N]
    (1 for live samples, 0 for padding)."""
    probs = torch.sigmoid(inputs)
    numerator = 2.0 * (probs * targets).sum(1)
    denominator = probs.sum(-1) + targets.sum(-1)
    loss = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    if weights is not None:
        loss = loss * weights
    return loss.sum() / num_boxes


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor,
                       num_boxes: Union[torch.Tensor, float],
                       alpha: float = 0.25, gamma: float = 2.0,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """RetinaNet's focal loss: the mean over the last axis, then the sum
    over samples over ``num_boxes``. inputs [N, L] logits; targets [N, L]
    in {0, 1}."""
    prob = torch.sigmoid(inputs)
    # binary cross-entropy with logits in its stable form
    ce_loss = (inputs.clamp(min=0) - inputs * targets
               + torch.log1p(torch.exp(-inputs.abs())))
    p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
    loss = ce_loss * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    loss = loss.mean(1)
    if weights is not None:
        loss = loss * weights
    return loss.sum() / num_boxes
