"""Multi-process bootstrap and cross-process helpers (port of
reftr_tpu/core/distributed.py), on ``torch.distributed``.

  * ``initialize()`` starts the process group from the launcher's variables
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; see
    ``reftr_torch.tools.launch``) or Slurm's (``SLURM_PROCID``,
    ``SLURM_NTASKS``, the first node of the node list, port 29500), as
    the reference's util/misc.py:392-431 does; NCCL for a CUDA device,
    gloo for the CPU.
  * ``rank``, ``world_size``, ``is_main_process``: 0, 1 and True without a
    process group.
  * ``allreduce_sum_host`` sums a dict of floats over the ranks, or over
    a group of them (the mesh's data axis, ``parallel/context.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

SLURM_PORT = 29500


def _first_slurm_node(nodelist: str) -> str:
    """'node[001-008],other' -> 'node001'; 'gpu-a-3' -> 'gpu-a-3'."""
    head = nodelist.split(",")[0]
    if "[" in head:
        prefix, rng = head.split("[", 1)
        first = rng.rstrip("]").split(",")[0].split("-")[0]
        return prefix + first
    return head


def launch_env() -> Optional[Tuple[str, int, int, int]]:
    """(address, port, world size, rank) of the rendezvous that the
    launcher or Slurm announced in the environment, or None."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return (env.get("MASTER_ADDR", "127.0.0.1"),
                int(env.get("MASTER_PORT", SLURM_PORT)),
                int(env["WORLD_SIZE"]), int(env["RANK"]))
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        # Slurm: the first node is the rendezvous, as the reference's
        # scontrol-based bootstrap (util/misc.py:398-415)
        nodelist = env.get("SLURM_STEP_NODELIST",
                           env.get("SLURM_JOB_NODELIST", ""))
        first = _first_slurm_node(nodelist)
        if first:
            return (first, SLURM_PORT, int(env["SLURM_NTASKS"]),
                    int(env["SLURM_PROCID"]))
    return None


def local_rank() -> int:
    """This process's index on its node: the launcher's LOCAL_RANK, else
    Slurm's SLURM_LOCALID, else 0."""
    env = os.environ
    return int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", 0)))


def env_world_size() -> int:
    """The world size the environment announces (1 without one)."""
    rdv = launch_env()
    return rdv[2] if rdv else 1


def initialize(device: torch.device) -> bool:
    """Start the process group the environment announces, for ``device``
    (NCCL on a CUDA device, gloo on the CPU); True when a group exists
    after the call.

    A group that already exists (made by the caller) is left as it is, as
    the JAX package's call is a no-op once the runtime is up. Without the
    variables the run stays one process. Unlike the JAX package, which
    starts its runtime only for more than one process, a group is started
    wherever the launcher set the variables, a world of 1 included: so
    ``launch --nproc_per_node 1`` runs DDP over NCCL on one card. The
    caller selects the CUDA device first (``torch.cuda.set_device``).
    """
    if is_initialized():
        return True
    rdv = launch_env()
    if rdv is None:
        return False
    addr, port, world, rank = rdv
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def collective_device() -> torch.device:
    """Where a tensor must lie for the group's collectives: the current
    card under NCCL, the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce_sum_host(values: Dict[str, float], size: Optional[int] = None,
                       group: Optional[dist.ProcessGroup] = None
                       ) -> Dict[str, float]:
    """Sum a dict of floats over the ranks (or over ``group``, of ``size``
    ranks), in float64 and in the order of the sorted keys (one rank: the
    identity). The eval accumulators' all_reduce of the reference
    (engine_vg.py:207-219)."""
    if (world_size() if size is None else size) == 1:
        return dict(values)
    keys = sorted(values)
    vec = torch.tensor([values[k] for k in keys], dtype=torch.float64,
                       device=collective_device())
    dist.all_reduce(vec, group=group)
    return {k: float(v) for k, v in zip(keys, vec.tolist())}
