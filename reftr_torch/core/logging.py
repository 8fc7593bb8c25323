"""JSONL experiment log and printing (port of reftr_tpu/core/logging.py,
for one process): ``log_stats`` appends one JSON line to
``<output_dir>/log.txt``, as main_vg.py:419-421 of the reference does."""

from __future__ import annotations

import json
import os
from typing import Any, Dict


def log_stats(output_dir: str, stats: Dict[str, Any],
              filename: str = "log.txt") -> None:
    """Append one JSON line of stats; nothing without an output dir."""
    if not output_dir:
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, filename), "a") as f:
        f.write(json.dumps(stats) + "\n")


def master_print(*args, **kwargs):
    """``print`` on the main process, which is the only one here."""
    print(*args, **kwargs)
