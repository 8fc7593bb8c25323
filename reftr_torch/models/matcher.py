"""Set-prediction matchers (port of reftr_tpu/models/matcher.py:28-80).

The reference's HungarianMatcher (focal class, L1 and GIoU costs, then a
linear sum assignment) and OnetoAllMatcher (the top-k queries of a single
target). Kept for capability: with one query per phrase neither criterion
calls a matcher (reftr_tpu/core/config.py:244-248), but the --set_cost_*
flags set its costs. The costs are torch ops on the caller's device; the
assignment runs on the host through the data pipeline's native
Jonker-Volgenant solver (``data/native.py::lsap``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from reftr_torch.data.native import lsap
from reftr_torch.ops.boxes import (box_cxcywh_to_xyxy,
                                   generalized_box_iou_aligned)


def focal_class_cost(out_prob: torch.Tensor, tgt_ids: torch.Tensor,
                     alpha: float = 0.25, gamma: float = 2.0
                     ) -> torch.Tensor:
    """[Q, C] sigmoid probabilities and [N] target class ids -> [Q, N]
    focal cost (matcher.py:127-132 of the reference)."""
    neg = (1 - alpha) * out_prob ** gamma * -torch.log(1 - out_prob + 1e-8)
    pos = alpha * (1 - out_prob) ** gamma * -torch.log(out_prob + 1e-8)
    return pos[:, tgt_ids] - neg[:, tgt_ids]


def match_cost(pred_boxes: torch.Tensor, tgt_boxes: torch.Tensor,
               pred_logits: Optional[torch.Tensor] = None,
               tgt_ids: Optional[torch.Tensor] = None,
               set_cost_class: float = 1.0, set_cost_bbox: float = 5.0,
               set_cost_giou: float = 2.0, focal_alpha: float = 0.25
               ) -> torch.Tensor:
    """[Q, N] assignment cost of [Q, 4] predicted and [N, 4] target cxcywh
    boxes, with the class cost when logits [Q, C] and target ids are given
    (matcher.py:117-145)."""
    cost_bbox = (pred_boxes[:, None, :] - tgt_boxes[None, :, :]).abs().sum(-1)
    cost_giou = -generalized_box_iou_aligned(
        box_cxcywh_to_xyxy(pred_boxes)[:, None, :],
        box_cxcywh_to_xyxy(tgt_boxes)[None, :, :])
    cost = set_cost_bbox * cost_bbox + set_cost_giou * cost_giou
    if pred_logits is not None and tgt_ids is not None:
        cost = cost + set_cost_class * focal_class_cost(
            torch.sigmoid(pred_logits), tgt_ids, alpha=focal_alpha)
    return cost


def hungarian_match(cost) -> Tuple[np.ndarray, np.ndarray]:
    """(query indices, target indices) of the least total cost of a [Q, N]
    cost (a tensor or an array): each target gets a query when N <= Q,
    else each query a target."""
    if isinstance(cost, torch.Tensor):
        cost = cost.detach().cpu().numpy()
    cost = np.asarray(cost, np.float64)
    q, n = cost.shape
    if n <= q:
        return lsap(cost.T), np.arange(n)
    return np.arange(q), lsap(cost)


def one_to_all_match(cost, topk: int) -> np.ndarray:
    """The ``topk`` queries of least cost for a single target
    (matcher.py:19-84): cost [Q, 1] -> [topk] query indices."""
    if isinstance(cost, torch.Tensor):
        cost = cost.detach().cpu().numpy()
    return np.argsort(np.asarray(cost).reshape(-1))[:topk]
