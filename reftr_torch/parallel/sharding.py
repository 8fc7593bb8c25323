"""The (data, model) mesh of ranks and the tensor-parallel layout (port of
reftr_tpu/parallel/sharding.py).

The reference's only strategy is DDP over NCCL (main_vg.py:290-296,
util/misc.py:392-431). The JAX package runs one global program over a
(data, model) device mesh; the port runs one process a card, so its mesh
is a grid of ranks (``context.Mesh``, made by ``create_mesh``):

  * the batch is split over the data axis: each data row loads its own
    shard (``loader_shards``), and DistributedDataParallel averages the
    gradients over the data group (``train/steps.py``);
  * with ``model > 1`` the attention projections and the FFN hidden layers
    are split over the model axis, Megatron-style
    (``parallel/tensor_parallel.py``): q/k/v and ``linear1`` /
    ``intermediate`` column-parallel, ``out_proj`` and ``linear2`` /
    ``output`` row-parallel, as ``_TP_RULES`` (:36-45) lays them out.
    ``param_spec`` is that table on the port's names, and
    ``shard_state_dict`` / ``gather_state_dict`` move a state dict between
    one process's full shapes and a rank's slices;
  * everything else is replicated, identical on every rank of a data row.

int8 runs under a model axis as JAX runs it, not sharded: ``--eval
--quantize_int8`` calibrates the sharded float model and evaluates the
int8 model unsharded on every rank (JAX puts the int8 tree on the mesh
replicated, reftr_tpu/nn/quant.py:346-350, and its ``_TP_RULES`` match
``kernel$``, which ``kernel_q`` does not); ``--quantize_train_prefix``
quantizes layer1, which lies in the replicated backbone
(``train/loop.py``).

JAX's rules also match pairs that are not Megatron pairs: the query
encoder's ``linear1`` and ``linear2`` compute the attended reduce's keys
and queries from one input (reftr_tpu/nn/query_encoder.py:28-29). Under
GSPMD that is a layout only; the port keeps them replicated
(``REPLICATED_COINCIDENCES``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from reftr_torch.core import distributed
from reftr_torch.core.config import MeshConfig
from reftr_torch.parallel.context import Mesh

MODEL_AXIS = "model"

# (pattern on a state_dict name, the axis of each dim of the tensor in the
# port's layout: Linear's weight is [out, in], the transpose of a Flax
# kernel), first match wins
_TP_RULES = [
    # FFN and BERT's intermediate: column-parallel in, row-parallel out
    (re.compile(r"(\.ffn\.linear1|\.intermediate)\.weight$"),
     (MODEL_AXIS, None)),
    (re.compile(r"(\.ffn\.linear2|\.output)\.weight$"), (None, MODEL_AXIS)),
    # attention: head-sharded q/k/v, row-parallel out projection
    (re.compile(r"\.(q_proj|k_proj|v_proj)\.weight$"), (MODEL_AXIS, None)),
    (re.compile(r"\.out_proj\.weight$"), (None, MODEL_AXIS)),
    (re.compile(r"(\.ffn\.linear1|\.intermediate|\.q_proj|\.k_proj"
                r"|\.v_proj)\.bias$"), (MODEL_AXIS,)),
]
# names that JAX's rules shard and the port keeps replicated
REPLICATED_COINCIDENCES = re.compile(r"^query_encoder\.linear[12]\.")


def check_data_axis(mesh_data: int, world: int, model: int = 1) -> None:
    """Refuse a mesh that ``create_mesh`` (:49-70) would refuse: a model
    axis that does not divide the world, or a data axis other than -1
    (all the processes over the model axis) or world / model, one card a
    process."""
    if model < 1 or world % model:
        raise ValueError(f"--mesh_model {model} does not divide the {world} "
                         f"processes (one card each)")
    if mesh_data not in (-1, world // model):
        raise ValueError(f"--mesh_data {mesh_data} does not match the "
                         f"{world} processes (one card each; -1 takes "
                         f"all over --mesh_model {model})")


def mesh_grid(data: int, model: int,
              model_spans_processes: bool = False) -> np.ndarray:
    """[data, model] ranks, as ``create_mesh`` lays out device ids: rank
    d * model + m (a model group is consecutive ranks), or model-major
    under ``model_spans_processes``, JAX's ``reshape(model, data).T``
    (:57-66: a data column is consecutive ranks). One process a card, so
    the model axis crosses processes either way; the flag chooses the
    layout."""
    ranks = np.arange(data * model)
    if model_spans_processes:
        return ranks.reshape(model, data).T
    return ranks.reshape(data, model)


def create_mesh(cfg: Optional[MeshConfig] = None, world: Optional[int] = None,
                rank: Optional[int] = None) -> Mesh:
    """This rank's view of the (data, model) mesh of ``cfg`` over the
    process group's ``world`` ranks (by default the group's). With
    ``model > 1`` every rank makes every data and model group, in one
    order (``dist.new_group`` is collective)."""
    cfg = cfg or MeshConfig()
    world = distributed.world_size() if world is None else world
    rank = distributed.rank() if rank is None else rank
    model = max(1, cfg.model)
    data = cfg.data if cfg.data > 0 else world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not match the {world} "
                         f"processes (one card each)")
    grid = mesh_grid(data, model, cfg.model_spans_processes)
    d, m = (int(i) for i in np.argwhere(grid == rank)[0])
    data_group = model_group = None
    if model > 1:
        for col in range(model):
            group = dist.new_group(grid[:, col].tolist())
            if col == m:
                data_group = group
        for row in range(data):
            group = dist.new_group(grid[row].tolist())
            if row == d:
                model_group = group
    return Mesh(data, model, d, m, tuple(map(tuple, grid.tolist())),
                data_group, model_group)


def loader_shards(mesh: Optional[Mesh] = None) -> tuple:
    """(num_shards, shard_rank): how many distinct loader shards the mesh
    needs and which one this rank loads (``reftr_tpu.parallel.sharding.
    loader_shards``). The ranks of one data row are replicas of each
    other's input and load the same shard. Without a mesh, the DDP layout:
    (world size, rank)."""
    if mesh is None:
        world, me = distributed.world_size(), distributed.rank()
        return _loader_shards_from(np.arange(world)[:, None], me)
    return _loader_shards_from(np.asarray(mesh.grid),
                               mesh.grid[mesh.data_index][mesh.model_index])


def _loader_shards_from(process_of: np.ndarray, me: int) -> tuple:
    """Pure core of loader_shards: process_of[data, model] = process index
    of each mesh slot; me = this process."""
    rows_of: dict = {}
    for di in range(process_of.shape[0]):
        for pid in process_of[di]:
            rows_of.setdefault(int(pid), set()).add(di)
    groups: dict = {}
    for pid, rows in rows_of.items():
        groups.setdefault(frozenset(rows), []).append(pid)
    ordered = sorted(groups, key=min)
    seen: set = set()
    for rows in ordered:
        if rows & seen:
            raise ValueError(
                "unsupported mesh layout: processes' data rows partially "
                f"overlap ({ {min(g): sorted(g) for g in groups.values()} })")
        # each shard is a contiguous block of the samplers' order, so a
        # group's rows must form a contiguous range
        if max(rows) - min(rows) + 1 != len(rows):
            raise ValueError(
                "unsupported mesh layout: a process group's data rows are "
                f"not contiguous ({sorted(rows)}); loader shards require "
                "contiguous row blocks per process group")
        seen |= rows
    for rank, rows in enumerate(ordered):
        if me in groups[rows]:
            return len(ordered), rank
    # this process owns no slot of the mesh; treat it as rank 0 of a
    # 1-shard layout
    return 1, 0


def param_spec(name: str) -> Tuple[Optional[str], ...]:
    """The axis of each dim of the state_dict entry ``name`` under tensor
    parallelism: (MODEL_AXIS, None) for a column-parallel weight, (None,
    MODEL_AXIS) for a row-parallel one, (MODEL_AXIS,) for a
    column-parallel bias, () for a replicated tensor."""
    if REPLICATED_COINCIDENCES.search(name):
        return ()
    for pat, spec in _TP_RULES:
        if pat.search("." + name):
            return spec
    return ()


def shard_dim(name: str) -> Optional[int]:
    """The dim of ``name`` split over the model axis, or None."""
    spec = param_spec(name)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def local_slice(full: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of ``full`` along ``dim``."""
    n = full.shape[dim]
    if n % mesh.model:
        raise ValueError(f"dim {dim} of size {n} does not split over "
                         f"{mesh.model} model ranks")
    size = n // mesh.model
    return full.narrow(dim, mesh.model_index * size, size).contiguous()


def shard_state_dict(state: Mapping[str, torch.Tensor], mesh: Optional[Mesh]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a state dict of one process's full shapes
    (the identity without tensor parallelism)."""
    if mesh is None or mesh.model == 1:
        return dict(state)
    out = {}
    for name, t in state.items():
        dim = shard_dim(name)
        out[name] = t if dim is None else local_slice(t, dim, mesh)
    return out


def gather_full(local: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The full tensor of the model group's slices along ``dim``, on every
    rank: each rank places its block in zeros and the group sums them
    (all_reduce, which every backend has)."""
    shape = list(local.shape)
    shape[dim] *= mesh.model
    full = local.new_zeros(shape)
    full.narrow(dim, mesh.model_index * local.shape[dim],
                local.shape[dim]).copy_(local)
    return mesh.all_reduce_model(full)


def gather_state_dict(state: Mapping[str, torch.Tensor], mesh: Optional[Mesh]
                      ) -> Dict[str, torch.Tensor]:
    """One process's state dict from a rank's (collective over the model
    group; the identity without tensor parallelism)."""
    if mesh is None or mesh.model == 1:
        return dict(state)
    out = {}
    for name, t in state.items():
        dim = shard_dim(name)
        out[name] = t if dim is None else gather_full(t, dim, mesh)
    return out


def _moments(per_param: Mapping, names, mesh: Mesh, move) -> Dict:
    out = {}
    for i, per in per_param.items():
        dim = shard_dim(names[i])
        out[i] = per if dim is None else {
            k: move(v, dim, mesh) if torch.is_tensor(v) and v.dim() > dim
            else v for k, v in per.items()}
    return out


def gather_optimizer_state(opt_state: Mapping, names, mesh: Optional[Mesh]
                           ) -> Dict:
    """An optimizer's ``state_dict()`` with the per-parameter tensors of
    the sharded parameters (AdamW's moments, SGD's momentum) gathered to
    full shapes; ``names[i]`` names parameter i (collective over the
    model group)."""
    if mesh is None or mesh.model == 1:
        return dict(opt_state)
    return {**opt_state,
            "state": _moments(opt_state["state"], names, mesh, gather_full)}


def shard_optimizer_state(per_param: Mapping, names, mesh: Optional[Mesh]
                          ) -> Dict:
    """The inverse of ``gather_optimizer_state`` on a ``state`` mapping
    (parameter index -> its tensors)."""
    if mesh is None or mesh.model == 1:
        return dict(per_param)
    return _moments(per_param, names, mesh, local_slice)
