"""Train state: the model, optimizer, LR scheduler, step count and dropout
generator (port of reftr_tpu/train/state.py:13-36)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Union

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR

from reftr_torch.convert import build_model
from reftr_torch.core.config import ModelConfig, TrainConfig
from reftr_torch.train.optimizer import build_optimizer
from reftr_torch.train.schedules import lr_scheduler


@dataclass
class TrainState:
    """``generator`` is the host generator the train step draws every
    dropout seed from, so two runs from one seed draw the same masks (the
    counterpart of the JAX state's rng). ``clip_max_norm`` is the global
    gradient-norm clip the step applies (0: none)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: LambdaLR
    generator: torch.Generator
    clip_max_norm: float
    step: int = 0

    @classmethod
    def create(cls, model_cfg: ModelConfig, train_cfg: TrainConfig,
               steps_per_epoch: int,
               device: Union[str, torch.device] = "cuda",
               state_dict: Optional[Mapping[str, torch.Tensor]] = None,
               seed: int = 0) -> "TrainState":
        """The model built on ``device`` ("cuda" unless the caller passes
        the CPU) with the weights of ``state_dict`` or a seeded init
        (``convert.build_model``), float32 parameters, and its optimizer
        and schedule."""
        model = build_model(model_cfg, device, state_dict, seed)
        optimizer = build_optimizer(model, model_cfg, train_cfg)
        generator = torch.Generator()
        generator.manual_seed(train_cfg.seed)
        return cls(model=model, optimizer=optimizer,
                   scheduler=lr_scheduler(optimizer, train_cfg,
                                          steps_per_epoch),
                   generator=generator,
                   clip_max_norm=train_cfg.clip_max_norm)

    def trainable(self):
        """The parameters the optimizer updates."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]
