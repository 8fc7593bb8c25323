"""Step-based learning-rate schedules (port of reftr_tpu/train/schedules.py:
30-79).

The reference's three schedules as multipliers of each group's base LR,
stepped every optimizer step: StepLR, MultiStepWarmupLR (linear warm-up,
then 0.1 per milestone passed, floored at 0.01) and CosineWarmupLR (linear
warm-up, then a half cosine to 0, floored at 0.01). ``lr_scheduler``
puts one behind ``torch.optim.lr_scheduler.LambdaLR``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

from torch.optim import Optimizer
from torch.optim.lr_scheduler import LambdaLR

from reftr_torch.core.config import TrainConfig

Schedule = Callable[[int], float]


def step_lr(step_size: int, gamma: float = 0.1) -> Schedule:
    return lambda step: gamma ** math.floor(step / step_size)


def multistep_warmup_lr(lr_milestones: Sequence[int], warm_up_steps: int,
                        decay_rate: float = 0.1,
                        min_decay_rate: float = 0.01) -> Schedule:
    milestones = list(lr_milestones)

    def fn(step: int) -> float:
        if step < warm_up_steps:
            rate = (step + 1.0) / warm_up_steps
        else:
            rate = decay_rate ** sum(m <= step for m in milestones)
        return max(rate, min_decay_rate)

    return fn


def cosine_warmup_lr(max_t: int, warm_up_steps: int,
                     min_decay_rate: float = 0.01) -> Schedule:
    span = max_t - warm_up_steps

    def fn(step: int) -> float:
        if step < warm_up_steps:
            rate = (step + 1.0) / warm_up_steps
        else:
            # with no step after the warm-up (epochs == warm_up_epoch) JAX
            # gives 0/0 = NaN here, at a step that never runs; LambdaLR
            # reads it after the last step, so it must not raise
            frac = (step - warm_up_steps) / span if span else 1.0
            rate = 0.5 * (math.cos(frac * math.pi) + 1.0)
        return max(rate, min_decay_rate)

    return fn


def build_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    if cfg.lr_schedule == "StepLR":
        return step_lr(steps_per_epoch * cfg.lr_drop)
    if cfg.lr_schedule == "MultiStepWarmupLR":
        milestones = [steps_per_epoch * e for e in (cfg.lr_drop_epochs or ())]
        return multistep_warmup_lr(milestones,
                                   steps_per_epoch * cfg.warm_up_epoch,
                                   decay_rate=cfg.lr_decay)
    if cfg.lr_schedule == "CosineWarmupLR":
        return cosine_warmup_lr(steps_per_epoch * cfg.epochs,
                                steps_per_epoch * cfg.warm_up_epoch)
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def lr_scheduler(optimizer: Optimizer, cfg: TrainConfig,
                 steps_per_epoch: int) -> LambdaLR:
    """Every group's LR is its base LR times the schedule at the number of
    optimizer steps taken so far."""
    return LambdaLR(optimizer, build_schedule(cfg, steps_per_epoch))
