"""Megatron tensor parallelism over the mesh's model axis, on
``torch.distributed`` process groups (the port of ``--mesh_model``:
reftr_tpu/parallel/sharding.py's ``_TP_RULES``, and the head axis of
``fused_attention_sharded``, reftr_tpu/kernels/attention.py:587-651).

A column-parallel layer holds a block of its output features (q/k/v: a
block of the heads; ``linear1`` / ``intermediate``: of the hidden width)
and runs on the replicated input; a row-parallel layer (``out_proj``,
``linear2`` / ``output``) holds the matching block of its input features,
and the model group sums its partial products. Two region operators carry
the gradients (Shoeybi et al., 2019, §3):

  * ``CopyToModelRegion`` before the column-parallel layers: the
    identity forward, an all_reduce of the input's gradient backward (each
    rank's block contributes to it);
  * ``RowParallelLinear``, the row-parallel layer itself: its product,
    then an all_reduce forward and the identity backward, then its bias,
    once. It is called as a module, so forward hooks on it (int8
    calibration's, ``nn/quant.py::Calibrator``) see this rank's slice of
    its input.

Both use all_reduce only, which gloo has for CUDA tensors too, so two
ranks can share one card. ``shard_model`` turns a model of one process's
weights into this rank's, in place: it slices every parameter that
``parallel/sharding.py::param_spec`` names and tells each attention, FFN
and BERT layer its mesh. A sharded parameter carries ``model_parallel_dim``
(the global-norm clip sums its square over the model group).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch import nn

from reftr_torch.parallel.context import Mesh
from reftr_torch.parallel.sharding import local_slice, shard_dim


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous()
        if out is x:  # summed in place: the product's output, saved by none
            ctx.mark_dirty(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class CopyToModelRegion(nn.Module):
    """Identity forward, all_reduce of the gradient over the model group
    backward: the input of the column-parallel layers."""

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.group = mesh.model_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.group)


class RowParallelLinear(nn.Linear):
    """An ``nn.Linear`` holding a block of its input features: the product
    on this rank's block, summed over the model group (all_reduce forward,
    identity backward), then the bias, once. It takes over ``linear``'s
    parameters, so the names of the state dict stay the same."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__(linear.in_features, linear.out_features,
                         device="meta")
        self.weight, self.bias = linear.weight, linear.bias
        self.group = mesh.model_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _ReduceFromModel.apply(nn.functional.linear(x, self.weight),
                                     self.group)
        return out + self.bias.to(out.dtype)


def split_layer(what: str, n: int, mesh: Mesh, *layers: nn.Module
                ) -> Tuple[int, CopyToModelRegion]:
    """(n / model, the input's region operator) for a layer named ``what``
    whose ``n`` heads or hidden features split over the model axis; the
    caller makes its row-parallel ``layers[-1]`` a ``RowParallelLinear``.
    Raises ValueError naming ``what`` where the model axis does not divide
    n, as ``fused_attention_sharded`` refuses a head count (:617-620), or
    where one of ``layers`` is not a float ``nn.Linear``: no path shards an
    int8 ``QuantDense``. int8 eval under a model axis runs the int8 model
    unsharded on every rank, as JAX replicates its int8 tree over the mesh
    (reftr_tpu/nn/quant.py:346-350); a row-parallel int8 product would be
    a feature JAX lacks."""
    for layer in layers:
        if not isinstance(layer, nn.Linear):
            raise ValueError(f"{what}: {type(layer).__name__} has no "
                             f"tensor-parallel form: int8 eval under "
                             f"--mesh_model runs unsharded, as in JAX")
    if n % mesh.model:
        raise ValueError(f"{what}: {n} does not divide over the model axis "
                         f"of {mesh.model} ranks (--mesh_model)")
    return n // mesh.model, CopyToModelRegion(mesh)


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Make ``model`` (one process's weights, identical on every rank of
    the model group) this rank's tensor-parallel model, in place: each
    module with a ``tensor_parallel(mesh, name)`` method (attention, FFN,
    BERT layer) checks its widths and takes the region operators, then
    every parameter ``param_spec`` names is replaced by this rank's slice.
    Call it before the optimizer is made. The identity at model 1."""
    if mesh.model == 1:
        return model
    for name, mod in model.named_modules():
        if hasattr(mod, "tensor_parallel"):
            mod.tensor_parallel(mesh, name)
    owners = {}
    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            owners[f"{mod_name}.{leaf}" if mod_name else leaf] = (mod, leaf, p)
    for name, (mod, leaf, p) in owners.items():
        dim = shard_dim(name)
        if dim is None:
            continue
        with torch.no_grad():
            local = nn.Parameter(local_slice(p.detach(), dim, mesh),
                                 requires_grad=p.requires_grad)
        local.model_parallel_dim = dim
        setattr(mod, leaf, local)
    return model
