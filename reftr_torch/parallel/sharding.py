"""The data-parallel layout (the DDP part of reftr_tpu/parallel/sharding.py).

The reference's only strategy is DDP over NCCL (main_vg.py:290-296,
util/misc.py:392-431), and so is the port's: one process per card, each
with a replica of the model (``train/steps.py`` wraps it in
``DistributedDataParallel``) and its own shard of every loader.

The JAX package runs one global program over a (data, model) mesh. Its
attention kernels run per shard under ``shard_map``
(``fused_attention_sharded``) with zero collectives, the counterpart of
``parallel/context.py``'s mesh; under DDP each rank calls the kernels on
its own batch, which is the same work, so that module has no counterpart
here. Only the shard's dropout seed carries over
(``kernels/attention.py::shard_seed``). Tensor parallelism over a model
axis (``--mesh_model``, ``_TP_RULES`` :36-45) is not ported: the CLI
refuses it (``TP_ITEM``).
"""

from __future__ import annotations

import numpy as np

from reftr_torch.core import distributed

TP_ITEM = "tensor parallelism (ROADMAP.md queue 1 item 12)"


def check_data_axis(mesh_data: int, world: int) -> None:
    """Refuse a data axis that ``create_mesh`` (:49-70) would refuse: it is
    -1 (all processes) or the world size, one card a process."""
    if mesh_data not in (-1, world):
        raise ValueError(f"--mesh_data {mesh_data} does not match the "
                         f"{world} processes (one card each; -1 takes all)")


def loader_shards() -> tuple:
    """(num_shards, shard_rank): the classic layout of
    ``reftr_tpu.parallel.sharding.loader_shards``, one loader shard per
    process, (world size, rank)."""
    world, me = distributed.world_size(), distributed.rank()
    return _loader_shards_from(np.arange(world)[:, None], me)


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
