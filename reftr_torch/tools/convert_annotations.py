"""One-time converter: the reference's .pth annotation pickles -> JSON
(port of reftr_tpu/tools/convert_annotations.py:21-64).

The reference stores annotations as torch-pickled lists of tuples
(resc_refer_dataset.py:110-116, refer_dataset.py).
``data/datasets.load_annotations`` reads a ``.json`` beside them first,
so a converted tree loads without unpickling. ``torch.load`` here unpickles
arbitrary objects (``weights_only=False``, as the reference's loaders
do): convert only files you trust.

Usage:
  python -m reftr_torch.tools.convert_annotations data/annotations_resc/unc
  python -m reftr_torch.tools.convert_annotations data/... --glob '*_train.pth'
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Optional


def _plain(obj):
    """Tensors, ndarrays, numpy scalars and tuples as JSON's types,
    recursively."""
    import numpy as np

    if hasattr(obj, "detach"):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    return obj


def convert_file(pth_path: str, out_path: Optional[str] = None) -> str:
    import torch

    out_path = out_path or (os.path.splitext(pth_path)[0] + ".json")
    records = torch.load(pth_path, map_location="cpu", weights_only=False)
    with open(out_path, "w") as f:
        json.dump(_plain(records), f)
    return out_path


def main(argv) -> int:
    root = argv[0] if argv else "."
    pattern = argv[argv.index("--glob") + 1] if "--glob" in argv else "*.pth"
    files = sorted(glob.glob(os.path.join(root, pattern)))
    if not files:
        print(f"no {pattern} files under {root}")
        return 1
    for f in files:
        out = convert_file(f)
        print(f"{f} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
