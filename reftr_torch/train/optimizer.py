"""Optimizer with the reference's parameter groups (port of
reftr_tpu/train/optimizer.py:42-90, 93-146).

  base        : everything else                        @ lr
  backbone    : trainable ResNet convolutions          @ lr_backbone
  bert        : the language backbone                  @ lr_bert
  mask_branch : bbox_attention + mask_head             @ lr * lr_mask_branch_proj
  frozen      : never updated: left out of the optimizer

Groups are chosen by substring rules on parameter names, as ``label_fn``
does on Flax paths. Frozen are the ResNet stem and layer1 unless
train_stem (then they train in the backbone group), the backbone when
lr_backbone <= 0 or with freeze_backbone, BERT with freeze_bert, and with
freeze_reftr the rest of the REC trunk; cem_block then stays at the base
LR (reftr_tpu/train/optimizer.py:80-84). FrozenBN statistics are buffers
in the port, so no rule is needed for them (JAX's ``_FROZEN_BN_LEAVES``,
:39), and so is a folded FrozenBN's bias (``fold_bn``): it never trains,
while the conv kernel that holds its scale trains where its stage
trains; the space-to-depth stem's ``conv1_s2d`` is the stem. Under
backbone_norm="group" the GroupNorms' affines are parameters of the
backbone group.

What gets no gradient at all is the model's to decide (``RefTR`` sets
requires_grad=False on the stem and layer1, on the backbone with
freeze_backbone and on BERT with freeze_bert, and runs them without a
graph; ``RefTRSeg`` does so for the whole trunk with freeze_reftr); the
groups hold only parameters that require a gradient. The backbone at
lr_backbone <= 0 still gets its gradient, as in the JAX step, and stays
out of the optimizer and so out of the clip. Under freeze_reftr the
labels keep the backbone's layer2-4 and BERT in their own groups, as
``label_fn`` does; they require no gradient, so they stay out of the
optimizer. In the JAX package AdamW's decoupled decay still moves them,
by lr_backbone * weight_decay (1e-9 at the defaults) of each value, which
is below float32's rounding, so neither side changes them.

AdamW (betas 0.9/0.999, eps 1e-8, weight decay on every parameter of a
trainable group) or SGD with momentum; ``clip_by_global_norm`` clips the
trainable gradients as optax does, before the update.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from reftr_torch.core.config import ModelConfig, TrainConfig


def param_label(name: str, model_cfg: ModelConfig,
                train_cfg: TrainConfig) -> str:
    """The group of the parameter called ``name`` (a state_dict name)."""
    train_backbone = (train_cfg.lr_backbone > 0
                      and not model_cfg.freeze_backbone)
    parts = name.split(".")
    if "img_backbone" in parts and not model_cfg.train_stem:
        # the stem (the module directly under img_backbone, not a
        # bottleneck's conv1) and layer1 train with train_stem only
        child = parts[parts.index("img_backbone") + 1]
        if child in ("conv1", "conv1_s2d", "bn1", "layer1"):
            return "frozen"
    if any(k in name for k in train_cfg.lr_backbone_names):
        return "backbone" if train_backbone else "frozen"
    if any(k in name for k in train_cfg.lr_bert_names):
        return "frozen" if model_cfg.freeze_bert else "bert"
    if any(k in name for k in train_cfg.lr_mask_branch_names):
        return "mask_branch"
    if model_cfg.freeze_reftr:
        # the reference freezes the trunk before it builds the mask branch
        # and the CEM block (reftr_segmentation.py:52-63)
        return "base" if "cem_block" in parts else "frozen"
    return "base"


def param_groups(model: nn.Module, model_cfg: ModelConfig,
                 train_cfg: TrainConfig) -> List[Dict]:
    """Optimizer groups of ``model``'s parameters that require a gradient
    and are not labelled frozen, each group with its base ``lr`` and its
    ``name``."""
    base_lr = {
        "base": train_cfg.lr,
        "backbone": train_cfg.lr_backbone,
        "bert": train_cfg.lr_bert,
        "mask_branch": train_cfg.lr * train_cfg.lr_mask_branch_proj,
    }
    grouped: Dict[str, List[nn.Parameter]] = {g: [] for g in base_lr}
    for name, p in model.named_parameters():
        label = param_label(name, model_cfg, train_cfg)
        if p.requires_grad and label != "frozen":
            grouped[label].append(p)
    return [{"params": ps, "lr": base_lr[g], "name": g}
            for g, ps in grouped.items() if ps]


def build_optimizer(model: nn.Module, model_cfg: ModelConfig,
                    train_cfg: TrainConfig) -> torch.optim.Optimizer:
    groups = param_groups(model, model_cfg, train_cfg)
    if train_cfg.sgd:
        # torch SGD adds wd * param to the gradient before the momentum,
        # as optax.add_decayed_weights before optax.sgd does
        return torch.optim.SGD(groups, lr=train_cfg.lr,
                               momentum=train_cfg.momentum,
                               weight_decay=train_cfg.weight_decay)
    return torch.optim.AdamW(groups, lr=train_cfg.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=train_cfg.weight_decay)


def clip_by_global_norm(params: List[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by
    max_norm / max(norm, max_norm), norm being their global L2 norm, which
    is returned (a device scalar: nothing waits for it). This is optax's
    clip_by_global_norm; torch's clip_grad_norm_ adds 1e-6 to the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    if max_norm > 0:
        torch._foreach_mul_(grads, max_norm / norm.clamp(min=max_norm))
    return norm
