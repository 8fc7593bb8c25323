"""Multi-process launcher (port of reftr_tpu/tools/launch.py:29-115).

Spawns ``nproc_per_node`` local processes with torch's rendezvous
variables, which ``reftr_torch.core.distributed.initialize()`` reads:
``MASTER_ADDR`` and ``MASTER_PORT`` from the coordinator flags, ``RANK``,
``LOCAL_RANK`` and ``WORLD_SIZE`` (the reference's tools/launch.py:159-189).

Usage (one node, one process per card):

    python -m reftr_torch.tools.launch --nproc_per_node 4 -- \\
        python -m reftr_torch.cli.main --preset refcoco_det ...

Multi-node (run once per node, like the reference's launcher):

    python -m reftr_torch.tools.launch --nnodes 2 --node_rank 0 \\
        --coordinator_address 10.0.0.1 --coordinator_port 29500 \\
        --nproc_per_node 4 -- python -m reftr_torch.cli.main ...

Each process trains on ``cuda:LOCAL_RANK`` (``--device cpu``: gloo on the
host). Unlike the reference's launcher, which waits for its children one
by one and leaves the others running after a failure, the first nonzero
exit stops every other child, and the launcher exits with that code.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "reftr_torch multi-process launcher",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--coordinator_address", default="127.0.0.1",
                   help="rank-0 node address (reference: --master_addr)")
    p.add_argument("--coordinator_port", type=int, default=29500)
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command, e.g. "
                        "python -m reftr_torch.cli.main --preset ...")
    args = p.parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if not args.command:
        p.error("no training command given (pass it after --)")
    return args


def build_env(args: argparse.Namespace, local_rank: int) -> dict:
    env = os.environ.copy()
    env["MASTER_ADDR"] = args.coordinator_address
    env["MASTER_PORT"] = str(args.coordinator_port)
    env["WORLD_SIZE"] = str(args.nproc_per_node * args.nnodes)
    env["RANK"] = str(args.nproc_per_node * args.node_rank + local_rank)
    env["LOCAL_RANK"] = str(local_rank)
    return env


def launch(args: argparse.Namespace) -> int:
    procs: List[subprocess.Popen] = []
    for local_rank in range(args.nproc_per_node):
        procs.append(subprocess.Popen(
            args.command, env=build_env(args, local_rank)))
    rc = 0
    try:
        live = list(procs)
        while live and rc == 0:
            for p in list(live):
                r = p.poll()
                if r is None:
                    continue
                live.remove(p)
                if r != 0:
                    rc = r
            if live and rc == 0:
                time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 10
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.send_signal(signal.SIGKILL)
                p.wait(timeout=5)  # reap: no zombie when used as a library
    # a signal-terminated child reports a negative returncode; map it to
    # the shell convention (128+signum) so sys.exit doesn't take it mod 256
    if rc < 0:
        rc = 128 - rc
    return rc


def main(argv=None) -> int:
    return launch(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
