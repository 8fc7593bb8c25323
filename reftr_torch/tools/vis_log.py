"""Convert JSONL training logs into TensorBoard event files (port of
reftr_tpu/tools/vis_log.py:18-53).

Each numeric key of each ``log.txt`` line (one line an epoch, as
``cli.main`` writes it) becomes a scalar at step ``epoch``, under
``train/``, ``test/`` or ``misc/`` by its prefix, written by
``torch.utils.tensorboard.SummaryWriter`` into ``<log_dir>/tb`` (emptied
first). SummaryWriter needs the ``tensorboard`` package: where it is
missing (the card's machine) the tool raises ModuleNotFoundError.

Usage: python -m reftr_torch.tools.vis_log <exp_dir_or_parent>
"""

from __future__ import annotations

import json
import os
import shutil
import sys


def convert_from_log(log_dir: str) -> None:
    from torch.utils.tensorboard import SummaryWriter

    tb_dir = os.path.join(log_dir, "tb")
    if os.path.exists(tb_dir):
        shutil.rmtree(tb_dir)
    writer = SummaryWriter(tb_dir)
    try:
        with open(os.path.join(log_dir, "log.txt")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    break
                info = json.loads(line)
                epoch = int(info.get("epoch", 0))
                for k, v in info.items():
                    if k == "epoch" or not isinstance(v, (int, float)):
                        continue
                    group = "train" if k.startswith("train_") else (
                        "test" if k.startswith("test_") else "misc")
                    writer.add_scalar(f"{group}/{k}", float(v), epoch)
    finally:
        writer.close()


def main(root: str) -> None:
    if os.path.exists(os.path.join(root, "log.txt")):
        convert_from_log(root)
        return
    for x in sorted(os.listdir(root)):
        d = os.path.join(root, x)
        if os.path.isdir(d) and os.path.exists(os.path.join(d, "log.txt")):
            print(f"converting {d}")
            convert_from_log(d)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "./exps")
