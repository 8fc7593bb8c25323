"""reftr_torch's launcher, bootstrap, loader shards and per-shard seeds on
the CPU, against reftr_tpu's where the JAX package has the function:

- the counterparts of tests/test_tools.py's launcher tests: ranked
  processes with torch's rendezvous variables, the multi-node rank offset,
  a failing child stops its sibling and its code is returned;
- ``_first_slurm_node`` equals JAX's, and ``launch_env`` reads the
  launcher's and Slurm's variables as JAX's ``initialize`` does;
- ``initialize`` starts a gloo group of one from the launcher's
  variables, and leaves a group that exists alone;
- ``_loader_shards_from`` equals JAX's on tests/test_train.py's layouts;
- ``shard_seed``: shard 0 is the identity, other shards stay in
  [0, 2^63) and differ, and an empty local batch is refused.
"""

import os
import socket
import sys
import tempfile

import numpy as np
import pytest
import torch

from reftr_tpu.core.distributed import _first_slurm_node as jax_first_node
from reftr_tpu.parallel.sharding import _loader_shards_from as jax_shards
from reftr_torch.core import distributed
from reftr_torch.kernels.attention import SEED_BITS, shard_seed
from reftr_torch.parallel.sharding import (_loader_shards_from,
                                           check_data_axis, loader_shards)
from reftr_torch.tools.launch import build_env, launch, parse_args

RANK_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
             "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
             "SLURM_STEP_NODELIST", "SLURM_JOB_NODELIST")


@pytest.fixture
def clean_env(monkeypatch):
    for k in RANK_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_launcher_spawns_ranked_processes():
    out = tempfile.mkdtemp()
    script = (
        "import os; open(os.path.join(%r, os.environ['RANK']),"
        " 'w').write(','.join(os.environ[k] for k in"
        " ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',"
        " 'MASTER_PORT')))" % out)
    args = parse_args([
        "--nproc_per_node", "3", "--coordinator_port", "12355", "--",
        sys.executable, "-c", script])
    assert launch(args) == 0
    got = {f: open(os.path.join(out, f)).read() for f in os.listdir(out)}
    assert set(got) == {"0", "1", "2"}
    for r in range(3):
        rank, world, local, addr, port = got[str(r)].split(",")
        assert (int(rank), int(world), int(local)) == (r, 3, r)
        assert (addr, port) == ("127.0.0.1", "12355")


def test_launcher_multinode_rank_offset():
    args = parse_args(["--nnodes", "2", "--node_rank", "1",
                       "--nproc_per_node", "4", "--coordinator_address",
                       "10.0.0.1", "--", "true"])
    env = build_env(args, local_rank=2)
    assert env["RANK"] == "6" and env["WORLD_SIZE"] == "8"
    assert env["LOCAL_RANK"] == "2"
    assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("10.0.0.1", "29500")


def test_launcher_propagates_child_failure():
    # rank 1 fails fast; the launcher must return its code and reap rank 0
    script = ("import os, sys, time\n"
              "if os.environ['RANK'] == '1': sys.exit(3)\n"
              "time.sleep(30)\n")
    args = parse_args(["--nproc_per_node", "2", "--",
                       sys.executable, "-c", script])
    assert launch(args) == 3  # returns promptly: sibling terminated


def test_launcher_maps_a_signal_to_128_plus_signum():
    script = "import os, signal; os.kill(os.getpid(), signal.SIGTERM)"
    args = parse_args(["--nproc_per_node", "1", "--",
                       sys.executable, "-c", script])
    assert launch(args) == 128 + 15


@pytest.mark.parametrize("nodelist", [
    "node[001-008],other", "gpu-a-3", "n[3,5-7]", "a1,b2", "pre[12]", ""])
def test_first_slurm_node_matches_jax(nodelist):
    assert distributed._first_slurm_node(nodelist) == jax_first_node(
        nodelist)


def test_launch_env_reads_slurm(clean_env):
    assert distributed.launch_env() is None
    assert distributed.env_world_size() == 1
    clean_env.setenv("SLURM_PROCID", "3")
    clean_env.setenv("SLURM_NTASKS", "8")
    clean_env.setenv("SLURM_LOCALID", "1")
    clean_env.setenv("SLURM_JOB_NODELIST", "gpu[02-05]")
    assert distributed.launch_env() == ("gpu02", 29500, 8, 3)
    clean_env.setenv("SLURM_STEP_NODELIST", "node[001-008],other")
    assert distributed.launch_env() == ("node001", 29500, 8, 3)
    assert distributed.local_rank() == 1
    assert distributed.env_world_size() == 8
    # the launcher's variables win, as JAX's coordinator address does
    clean_env.setenv("RANK", "1")
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("MASTER_ADDR", "10.0.0.1")
    clean_env.setenv("MASTER_PORT", "1234")
    assert distributed.launch_env() == ("10.0.0.1", 1234, 2, 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_starts_a_group_of_one(clean_env):
    """World size 1 from the launcher still starts a group (so one card
    runs DDP), over gloo on the CPU; the helpers read it."""
    cpu = torch.device("cpu")
    assert not distributed.initialize(cpu)
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "1")
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    clean_env.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert distributed.initialize(cpu)
        assert torch.distributed.get_backend() == "gloo"
        assert (distributed.rank(), distributed.world_size()) == (0, 1)
        assert distributed.is_main_process()
        assert loader_shards() == (1, 0)
        values = {"b": 2.5, "a": 1.0}
        assert distributed.allreduce_sum_host(values) == values
        # a group that exists is left alone
        clean_env.setenv("WORLD_SIZE", "2")
        assert distributed.initialize(cpu)
        assert distributed.world_size() == 1
    finally:
        torch.distributed.destroy_process_group()
    assert not distributed.is_initialized()


LAYOUTS = {
    # 2 procs x 2 devices, model within a process: DDP
    "classic": np.array([[0, 0], [1, 1]]),
    # the model axis spans both processes
    "crossed": np.array([[0, 1], [0, 1]]),
    # model=4 over 2-device hosts: one shard per pair
    "mixed": np.array([[0, 0, 1, 1], [2, 2, 3, 3]]),
    # one process a data row: the port's layout
    "ddp4": np.arange(4)[:, None],
    # a process absent from the mesh
    "sub": np.array([[0], [1]]),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_loader_shards_match_jax(name):
    layout = LAYOUTS[name]
    for me in range(int(layout.max()) + 2):
        assert _loader_shards_from(layout, me) == jax_shards(layout, me)


@pytest.mark.parametrize("layout", [np.array([[0, 1], [1, 2]]),
                                    np.array([[0], [1], [0]])])
def test_loader_shards_refuse_what_jax_refuses(layout):
    with pytest.raises(ValueError) as theirs:
        jax_shards(layout, 0)
    with pytest.raises(ValueError) as ours:
        _loader_shards_from(layout, 0)
    assert str(ours.value) == str(theirs.value)


def test_data_axis_is_all_or_the_world():
    check_data_axis(-1, 4)
    check_data_axis(2, 2)
    with pytest.raises(ValueError, match="--mesh_data 3"):
        check_data_axis(3, 2)


def test_shard_seed():
    rng = np.random.default_rng(0)
    seeds = [int(s) for s in rng.integers(0, 2 ** SEED_BITS - 1, 64)]
    seeds += [0, 2 ** SEED_BITS - 2]
    for s in seeds:
        assert shard_seed(s, 0, 4) == s
        folded = [shard_seed(s, shard, 4) for shard in range(1, 9)]
        assert all(0 <= f < 2 ** SEED_BITS for f in folded)
        assert len(set(folded + [s])) == 9
    with pytest.raises(ValueError, match="empty local batch"):
        shard_seed(seeds[0], 1, 0)
