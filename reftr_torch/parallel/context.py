"""The run's mesh and where it is installed (port of
reftr_tpu/parallel/context.py).

The JAX package installs its device ``Mesh`` for the modules that read it
while ``jit`` traces a step (``use_mesh``, ``current_mesh``). The port has
one process a card, and its mesh is a grid of ranks: ``Mesh`` holds the
grid, this rank's (data, model) coordinates and the two process groups
its collectives run over, the data group (the ranks that share this
rank's model index, over which DistributedDataParallel averages the
gradients) and the model group (the ranks of this rank's data row, over
which a tensor-parallel layer reduces). ``shard`` is JAX's fold of a
shard's coordinates into its dropout key, data_index * model +
model_index (reftr_tpu/kernels/attention.py:628-634).

With ``model == 1`` the mesh is the DDP layout: the data group is the
world (``None``, torch.distributed's default group) and there is no model
group. ``parallel/sharding.py::create_mesh`` makes a mesh; the trainer
installs it with ``use_mesh`` so that the reductions of the loss and the
eval (``data_axis``) run over the data axis instead of the world.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist

_MESH_STACK: list = []


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) grid of ranks, seen from one rank.

    ``grid[d][m]`` is the rank at data index d and model index m.
    ``data_group`` is None at ``model == 1`` (the world); ``model_group``
    is None there too (nothing to reduce)."""

    data: int
    model: int
    data_index: int
    model_index: int
    grid: Tuple[Tuple[int, ...], ...]
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shard(self) -> int:
        """The fold of JAX's ``fused_attention_sharded``: a distinct index
        for every (data, model) slot, 0 at (0, 0)."""
        return self.data_index * self.model + self.model_index

    def all_reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the model group (identity at model 1)."""
        if self.model > 1:
            dist.all_reduce(t, group=self.model_group)
        return t


@contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[None]:
    """Install ``mesh`` as the current mesh for the duration of the block.

    ``None`` is a no-op so callers can pass an optional mesh through
    unconditionally."""
    if mesh is None:
        yield
        return
    _MESH_STACK.append(mesh)
    try:
        yield
    finally:
        _MESH_STACK.pop()


def current_mesh() -> Optional[Mesh]:
    return _MESH_STACK[-1] if _MESH_STACK else None


def data_axis() -> Tuple[int, Optional[dist.ProcessGroup]]:
    """(size, group) of the current mesh's data axis; without a mesh the
    world's (DDP): the ranks that hold distinct batches."""
    mesh = current_mesh()
    if mesh is not None:
        return mesh.data, mesh.data_group
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    return world, None
