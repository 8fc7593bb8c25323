"""Train and eval steps (port of reftr_tpu/train/steps.py:54-128).

A RES model (``config.masks``) adds the mask losses to both steps and
the seg mIoU sums (``segm_metrics``) to the eval step's.

The train step is the reference's hot loop (engine_vg.py:39-74): forward
in training mode, criterion, weighted total, backward, global-norm clip,
optimizer step and LR-scheduler step. Parameters stay float32; a bfloat16
model config computes under ``torch.autocast``, the counterpart of the JAX
package's bf16 compute dtype over f32 params.

Dropout is seeded from the state's host generator: one draw seeds the
elementwise dropouts (``nn.Dropout``, on a forked global RNG so the
caller's stays as it was) and every attention draws its own seed
(``attention_rng``), the counterpart of
``jax.random.fold_in(state.rng, state.step)`` (:74).

Under a process group (``core/distributed.py``) the train step is DDP's:
the model is wrapped in ``DistributedDataParallel``, each rank runs its
own shard of the global batch, its box losses are divided by the global
count over the world size (``criterion.compute_num_boxes``), and DDP's
average of the gradients is then JAX's gradient of the global batch
(``make_train_step(..., world_size)``). Every rank holds the same
generator and folds its rank into each draw, the elementwise dropouts'
seed included (``kernels/attention.py::shard_seed``): the ranks drop
different elements, rank 0 as one process would. The logged losses are
the rank's; their mean over the ranks, which ``MetricLogger`` takes at
the end of an epoch, is the global batch's.

Under a mesh with a model axis (``--mesh_model``, ``parallel/``) the model
is split over the ranks of each model group (``TrainState.create(...,
mesh=)``), DDP runs over the data group only (not at all at one data
row), the loss's box count and the eval's sums reduce over the data
group (``parallel/context.py::data_axis``, installed by the step), and
the clip's norm sums the sharded gradients' squares over the model group.
The ranks of a model group hold one batch, so the elementwise dropouts'
seed is folded with the data index, the same on all of them, and the
replicated activations drop the same elements: the replicated parameters
stay bit-identical across the group. Attention and a sharded FFN
hidden block fold the mesh's ``shard`` (data_index * model +
model_index) into their seeds and draw their own masks. At model 1 the
data index and the shard are the rank, as under DDP.

The step returns ``StepMetrics``: every loss term, ``loss``, ``grad_norm``
and ``lr``, copied to the host without waiting, so a loop can read step
i-1's while step i runs. ``grad_norm`` is the norm the clip sees, over the
trainable parameters (under DDP of the averaged gradients, so the same on
every rank and that of one process on the global batch); JAX's reported
``grad_norm`` (:87) also counts the FrozenBN leaves of layer2-4, which are
Flax params there and buffers here (ROADMAP.md queue 3, "Differences that
are not port faults").

``set_debug_nans(True)`` (``--debug_nans``, the counterpart of
``jax_debug_nans``, reftr_tpu/cli/main.py:333-336) makes every step raise
at the first non-finite value: ``FloatingPointError`` in the forward,
naming the innermost module whose output holds one; autograd's anomaly
mode's ``RuntimeError`` in the backward, naming the function that
returned a NaN; ``FloatingPointError`` at a gradient that is not finite,
naming its parameter. It synchronises with the device after every
module, so it is a debugging aid.

JAX's step donates the state's buffers (``donate_state``, :37-39, 96):
its update reuses their memory. The port's optimizer updates the
parameters in place at every step, so ``TrainConfig.donate_state`` (and
``--no_donate_state``) changes neither the memory nor a bit.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import (Callable, Dict, Iterator, Mapping, Optional, Tuple,
                    Union)

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from reftr_torch.core import distributed
from reftr_torch.core.config import LossConfig
from reftr_torch.core.device import resolve_device
from reftr_torch.kernels.attention import SEED_BITS, shard_seed
from reftr_torch.models.criterion import criterion, total_loss
from reftr_torch.models.postprocess import rec_metrics, segm_metrics
from reftr_torch.nn.attention import attention_rng
from reftr_torch.parallel.context import Mesh, use_mesh
from reftr_torch.parallel.sharding import create_mesh
from reftr_torch.train.optimizer import clip_by_global_norm
from reftr_torch.train.state import TrainState


_DEBUG_NANS = False


def set_debug_nans(on: bool) -> None:
    """Raise at the first non-finite value in every later step, forward
    or backward (``--debug_nans``)."""
    global _DEBUG_NANS
    _DEBUG_NANS = bool(on)


def _tensors(value) -> Iterator[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, Mapping):
        for v in value.values():
            yield from _tensors(v)


@contextmanager
def nan_checks(model: nn.Module, enabled: bool) -> Iterator[None]:
    """With ``enabled``: a forward hook on every module of ``model`` that
    raises at a non-finite floating output, naming the module, and
    autograd's anomaly mode over the block, which raises at the backward
    function that returns a NaN."""
    if not enabled:
        yield
        return
    names = {id(m): name or type(model).__name__
             for name, m in model.named_modules()}

    def check(mod, _inputs, output):
        for t in _tensors(output):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"debug_nans: a non-finite value in the output of "
                    f"{names[id(mod)]} ({type(mod).__name__})")

    handles = [m.register_forward_hook(check) for m in model.modules()]
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        for h in handles:
            h.remove()


def check_grads_finite(model: nn.Module) -> None:
    """Raise at the first parameter whose gradient is not finite."""
    for name, p in model.named_parameters():
        if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
            raise FloatingPointError(f"debug_nans: a non-finite gradient "
                                     f"of {name}")


def to_device(tree: Mapping[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch's numpy arrays as tensors on ``device``. Under DDP each
    rank's loader yields its own shard of the global batch (the samplers'
    (world size, rank) blocks), so JAX's ``shard_batch``
    (reftr_tpu/train/steps.py:138-157) has no counterpart."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, non_blocking=True) for k, v in tree.items()}


class StepMetrics:
    """One step's metrics. The device scalars are copied to pinned host
    memory behind the step's work; ``get`` waits for this step alone."""

    def __init__(self, values: Dict[str, torch.Tensor],
                 host: Dict[str, float]):
        self._names = list(values)
        vec = torch.stack([v.detach().float() for v in values.values()])
        self._event = None
        if vec.is_cuda:
            self._buf = torch.empty(vec.shape, pin_memory=True)
            self._buf.copy_(vec, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = vec
        self._host = dict(host)

    def get(self) -> Dict[str, float]:
        if self._event is not None:
            self._event.synchronize()
        return {**dict(zip(self._names, self._buf.tolist())), **self._host}


def model_device(model: nn.Module,
                 device: Union[str, torch.device]) -> torch.device:
    """``device`` resolved ("cuda" unless the caller passes the CPU);
    raises if a parameter of ``model`` lies elsewhere."""
    dev = resolve_device(device)
    elsewhere = sorted({str(p.device) for p in model.parameters()
                        if p.device != dev})
    if elsewhere:
        raise ValueError(f"the model is on {', '.join(elsewhere)}, not {dev}:"
                         f" build it there with TrainState.create(..., "
                         f"device=...)")
    return dev


def _autocast(model: nn.Module, device: torch.device):
    dtype = model.dtype
    return torch.autocast(device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


def make_train_step(model: nn.Module, weight_dict: Dict[str, float],
                    loss_cfg: LossConfig,
                    device: Union[str, torch.device] = "cuda",
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Mapping, Mapping],
                                  Tuple[TrainState, StepMetrics]]:
    """step(state, batch, targets) -> (state, metrics) on ``device``
    ("cuda" unless the caller passes the CPU), where ``model`` must lie
    (``TrainState.create`` builds it there); batch and targets are numpy
    dicts. ``mesh`` is the one ``model`` was split over (``state.mesh``);
    without one, the DDP layout of the process group.

    Under a process group at model 1, and over the data group where the
    mesh has a model axis and more than one data row, the forward runs
    through ``DistributedDataParallel`` (on a card with
    ``device_ids=[index]``), with ``broadcast_buffers=False``: the model's
    only buffers are FrozenBatchNorm's statistics, which no forward
    changes. It keeps ``find_unused_parameters`` off: every trainable
    parameter of ``refcoco_det``, ``refcoco_seg`` (with ``freeze_reftr``
    too, whose trunk has requires_grad off) and ``flickr`` receives a
    gradient every step (tests/test_torch_distributed.py)."""
    device = model_device(model, device)
    with_masks = model.config.masks
    rng_devices = [device.index] if device.type == "cuda" else []
    if mesh is None:
        if any(hasattr(p, "model_parallel_dim") for p in model.parameters()):
            raise ValueError("the model is split over a model axis: pass "
                             "its mesh (TrainState.mesh)")
        mesh = create_mesh()
    forward = model
    if distributed.is_initialized() and (mesh.model == 1 or mesh.data > 1):
        forward = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None, broadcast_buffers=False,
            process_group=mesh.data_group)

    def step_fn(state: TrainState, batch: Mapping, targets: Mapping):
        model.train()
        batch = to_device(batch, device)
        targets = to_device(targets, device)
        seed = int(torch.randint(0, 2 ** SEED_BITS - 1, (),
                                 generator=state.generator))
        local = len(batch["image"])
        debug = _DEBUG_NANS
        with nan_checks(model, debug), use_mesh(mesh):
            with torch.random.fork_rng(devices=rng_devices):
                torch.manual_seed(shard_seed(seed, mesh.data_index, local))
                with _autocast(model, device), attention_rng(state.generator,
                                                             mesh.shard):
                    out = forward(batch)
            losses = criterion(out, targets, loss_cfg, with_masks)
            loss = total_loss(losses, weight_dict)
            # the model's, not the optimizer's: a parameter with a
            # gradient may stay out of the optimizer (the backbone at
            # lr_backbone <= 0)
            model.zero_grad(set_to_none=True)
            loss.backward()
        if debug:
            check_grads_finite(model)
        grad_norm = clip_by_global_norm(state.trainable(),
                                        state.clip_max_norm, mesh)
        lr = state.base_lr * state.scheduler.lr_lambdas[0](state.step)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        metrics = StepMetrics({**losses, "loss": loss,
                               "grad_norm": grad_norm}, {"lr": lr})
        return state, metrics

    return step_fn


def make_eval_step(model: nn.Module, loss_cfg: LossConfig,
                   device: Union[str, torch.device] = "cuda"):
    """step(batch, targets) -> (outputs, losses, metric sums): the forward
    in eval mode on ``device`` (as in ``make_train_step``), the losses for
    logging and the P@0.5 / mIoU sums (with masks, the seg mIoU's too), as
    device tensors."""
    device = model_device(model, device)
    with_masks = model.config.masks

    @torch.no_grad()
    def step_fn(batch: Mapping, targets: Mapping):
        model.eval()
        batch = to_device(batch, device)
        targets = to_device(targets, device)
        with nan_checks(model, _DEBUG_NANS), _autocast(model, device):
            out = model(batch)
        losses = criterion(out, targets, loss_cfg, with_masks)
        sums = rec_metrics(out["pred_boxes"], targets["boxes"],
                           targets["box_valid"])
        if with_masks:
            sums.update(segm_metrics(out["pred_masks"], targets["masks"],
                                     batch["image_valid"],
                                     mask_valid=targets.get("mask_valid")))
        return out, losses, sums

    return step_fn
