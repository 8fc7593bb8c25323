"""JSONL experiment log and printing on rank 0 (port of
reftr_tpu/core/logging.py): ``log_stats`` appends one JSON line to
``<output_dir>/log.txt``, as main_vg.py:419-421 of the reference does,
and ``master_print`` prints, as util/misc.py:336-348 does; both on the
main process only."""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from reftr_torch.core.distributed import is_main_process


def log_stats(output_dir: str, stats: Dict[str, Any],
              filename: str = "log.txt") -> None:
    """Append one JSON line of stats on rank 0; nothing without an output
    dir."""
    if not output_dir or not is_main_process():
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, filename), "a") as f:
        f.write(json.dumps(stats) + "\n")


def master_print(*args, **kwargs):
    """``print`` on the main process (rank 0; without a process group the
    one process)."""
    if is_main_process():
        print(*args, **kwargs)
