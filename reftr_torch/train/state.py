"""Train state: the model, optimizer, LR scheduler, step count and dropout
generator (port of reftr_tpu/train/state.py:13-36), and the mesh whose
model axis the model is split over (tensor parallelism,
``parallel/tensor_parallel.py``).

Under tensor parallelism a rank holds slices of the sharded parameters
and of their optimizer moments; ``full_model_state`` and
``full_optimizer_state`` gather one process's (collective over the model
group), ``load_model_state`` and ``restore`` take one process's and keep
this rank's slices, so a checkpoint is the same at any ``--mesh_model``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR

from reftr_torch.convert import build_model
from reftr_torch.core.config import ModelConfig, TrainConfig
from reftr_torch.parallel.context import Mesh
from reftr_torch.parallel.sharding import (gather_optimizer_state,
                                           gather_state_dict,
                                           shard_optimizer_state,
                                           shard_state_dict)
from reftr_torch.parallel.tensor_parallel import shard_model
from reftr_torch.train.optimizer import build_optimizer
from reftr_torch.train.schedules import lr_scheduler


@dataclass
class TrainState:
    """``generator`` is the host generator the train step draws every
    dropout seed from, so two runs from one seed draw the same masks (the
    counterpart of the JAX state's rng). ``clip_max_norm`` is the global
    gradient-norm clip the step applies (0: none). ``base_lr`` is the
    config's LR, which the step logs times the schedule, as JAX's
    ``lr_fn`` (reftr_tpu/train/loop.py:301): a run may have no parameter
    in the "base" group (RES under ``freeze_reftr`` without the CEM
    block)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: LambdaLR
    generator: torch.Generator
    clip_max_norm: float
    base_lr: float
    step: int = 0
    mesh: Optional[Mesh] = None

    @classmethod
    def create(cls, model_cfg: ModelConfig, train_cfg: TrainConfig,
               steps_per_epoch: int,
               device: Union[str, torch.device] = "cuda",
               state_dict: Optional[Mapping[str, torch.Tensor]] = None,
               seed: int = 0, mesh: Optional[Mesh] = None) -> "TrainState":
        """The model built on ``device`` ("cuda" unless the caller passes
        the CPU) with the weights of ``state_dict`` or a seeded init
        (``convert.build_model``; one process's, the same on every rank),
        split over ``mesh``'s model axis when it has one, float32
        parameters, and its optimizer and schedule."""
        model = build_model(model_cfg, device, state_dict, seed)
        if mesh is not None:
            shard_model(model, mesh)
        optimizer = build_optimizer(model, model_cfg, train_cfg)
        generator = torch.Generator()
        generator.manual_seed(train_cfg.seed)
        return cls(model=model, optimizer=optimizer,
                   scheduler=lr_scheduler(optimizer, train_cfg,
                                          steps_per_epoch),
                   generator=generator,
                   clip_max_norm=train_cfg.clip_max_norm,
                   base_lr=train_cfg.lr, mesh=mesh)

    def trainable(self):
        """The parameters the optimizer updates."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def param_names(self):
        """The names of the optimizer's parameters, in its order."""
        name_of = {id(p): n for n, p in self.model.named_parameters()}
        return [name_of[id(p)] for p in self.trainable()]

    def full_model_state(self) -> Dict[str, torch.Tensor]:
        """One process's state dict of the model (gathered over the model
        group under tensor parallelism: every rank of it must call)."""
        return gather_state_dict(self.model.state_dict(), self.mesh)

    def load_model_state(self, state: Mapping[str, torch.Tensor]) -> None:
        """Load one process's state dict (this rank's slices of it)."""
        self.model.load_state_dict(shard_state_dict(state, self.mesh))

    def full_optimizer_state(self) -> Dict[str, Any]:
        """One process's optimizer state_dict (gathered as the model's)."""
        return gather_optimizer_state(self.optimizer.state_dict(),
                                      self.param_names(), self.mesh)

    def restore(self, payload: Mapping[str, Any]) -> None:
        """Continue from a full checkpoint (``core/checkpoint.py``): the
        optimizer's state of each parameter, matched by name (a parameter
        the checkpoint did not train starts afresh), the step and the
        dropout generator. The hyperparameters of each group, the base LR
        first, stay those of this state's config, as the JAX package
        applies the current config's LR on resume
        (reftr_tpu/train/loop.py:301); the schedule then continues at the
        saved step, so the next step's LR is the schedule's value there."""
        saved = shard_optimizer_state(payload["optimizer"]["state"],
                                      payload["optimizer_params"], self.mesh)
        where = {n: i for i, n in enumerate(payload["optimizer_params"])}
        state = {j: saved[where[n]] for j, n in enumerate(self.param_names())
                 if where.get(n) in saved}
        hyper, j = [], 0
        for g in self.optimizer.param_groups:
            n = len(g["params"])
            hyper.append({**{k: v for k, v in g.items() if k != "params"},
                          "params": list(range(j, j + n))})
            j += n
        self.optimizer.load_state_dict({"state": state,
                                        "param_groups": hyper})
        self.step = int(payload["step"])
        self.generator.set_state(payload["generator"].cpu())
        sched, groups = self.scheduler, self.optimizer.param_groups
        sched.last_epoch = self.step
        for g, fn in zip(groups, sched.lr_lambdas):
            g["lr"] = g["initial_lr"] * fn(self.step)
        sched.base_lrs = [g["initial_lr"] for g in groups]
        sched._last_lr = [g["lr"] for g in groups]
