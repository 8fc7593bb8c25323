"""Epoch-level train and eval loops (port of reftr_tpu/train/engine.py:
56-108, 151-222).

``train_one_epoch`` runs one train step per batch and logs each step's
metrics one step late: step i-1's are read while step i runs on the
device, so the host never waits on the step it just launched. At the end
of the epoch the meters are averaged over the ranks (JAX's
``synchronize_between_processes``). The NaN tripwire of the reference
(engine_vg.py:55-58) is kept, on that late read.
Loss terms are logged scaled by their weight under their own names, as the
reference logs them; terms outside the weight dict are dropped.

``evaluate`` runs the eval step over a loader and gives P@0.5, mIoU (and,
when the step gives the seg sums, the seg mIoU) and the mean of each
scaled loss term over the batches, and the boxes in the original image's
pixels by image id. Its sums stay on the device and are read once per
pass; under a process group they are summed over the ranks first (JAX's
``allreduce_sum_host``, reftr_tpu/train/engine.py:212-213), so every rank
reports the global stats, and the ranks' boxes are gathered, so that every
rank holds the whole split's. There is no profiler hook and no visual
dump (``visualize_dir`` needs PIL; ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import math
import sys
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from reftr_torch.core import distributed
from reftr_torch.core.metrics import MetricLogger, SmoothedValue
from reftr_torch.models.postprocess import decode_boxes
from reftr_torch.train.state import TrainState

# target keys the steps do not read: kept on the host
HOST_TARGET_KEYS = ("orig_size", "size", "image_id")


def _strip_target(t: Dict) -> Dict:
    return {k: v for k, v in t.items() if k not in HOST_TARGET_KEYS}


def _log_train_metrics(metrics, weight_dict, logger, print_fn) -> None:
    host = metrics.get()
    if not math.isfinite(host["loss"]):
        print_fn(f"Loss is {host['loss']}, stopping training")
        sys.exit(1)
    host = {k: v * weight_dict[k] if k in weight_dict else v
            for k, v in host.items()
            if k in weight_dict or not k.startswith("loss_")}
    logger.update(**host)


def train_one_epoch(train_step, state: TrainState, loader: Iterable,
                    epoch: int, print_freq: int = 50, *,
                    weight_dict: Dict[str, float],
                    print_fn=print) -> Tuple[TrainState, Dict[str, float]]:
    """Train over ``loader``, an iterable of numpy (batch, targets) pairs.
    Returns (state, the epoch's average of each logged metric)."""
    logger = MetricLogger(print_fn=print_fn)
    logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    header = f"Epoch: [{epoch}]"
    prev_metrics = None
    for samples, targets in logger.log_every(loader, print_freq, header):
        state, metrics = train_step(state, samples, _strip_target(targets))
        if prev_metrics is not None:
            _log_train_metrics(prev_metrics, weight_dict, logger, print_fn)
        prev_metrics = metrics
    if prev_metrics is not None:
        _log_train_metrics(prev_metrics, weight_dict, logger, print_fn)
    logger.synchronize_between_processes()
    return state, {k: m.global_avg for k, m in logger.meters.items()}


def evaluate(eval_step, loader: Iterable,
             weight_dict: Optional[Dict[str, float]] = None,
             print_freq: int = 50, collect_results: bool = False,
             print_fn=print) -> Tuple[Dict[str, float], Dict[int, Any]]:
    """Returns (stats, results). stats: accuracy_iou0.5, miou, seg_miou
    when the step gives sum_seg_iou and cnt_seg (RES) and, with a
    ``weight_dict``, the batches' mean of the total loss and of each
    scaled term but the auxiliary layers' (engine_vg.py:221-222). results
    (with ``collect_results``): image id -> the valid rows' boxes, xyxy in
    the original image's pixels. Rows of a padded batch whose boxes are
    all invalid are skipped, so they cannot overwrite a real entry."""
    logger = MetricLogger(print_fn=print_fn)
    totals = None  # device float64: scaled losses, then the metric sums
    names: list = []
    n_batches = n_rows = 0
    boxes, rows = [], []
    for samples, targets in logger.log_every(loader, print_freq, "Test:"):
        out, losses, sums = eval_step(samples, _strip_target(targets))
        values: Dict[str, torch.Tensor] = {}
        if weight_dict:
            scaled = {k: v * weight_dict[k] for k, v in losses.items()
                      if k in weight_dict}
            values = {"loss": sum(scaled.values()), **scaled}
        values.update(sums)
        names = list(values)
        vec = torch.stack([v.detach().double() for v in values.values()])
        totals = vec if totals is None else totals + vec
        n_batches += 1
        if collect_results:
            sizes = torch.from_numpy(targets["orig_size"]).to(
                out["pred_boxes"].device, torch.float32)
            boxes.append(decode_boxes(out["pred_boxes"], sizes,
                                      scale_to_original_shape=True))
            b = len(targets["box_valid"])
            ids = targets.get("image_id", np.arange(n_rows, n_rows + b))
            rows.append((ids, targets["box_valid"]))
            n_rows += b
    if totals is not None and distributed.world_size() > 1:
        # every rank runs as many batches (the test sampler pads the split
        # to a multiple of the world size, and the padded rows count, as
        # in JAX and the reference): the sums add up and the losses'
        # means over the batches are the global ones
        totals = totals.to(distributed.collective_device())
        dist.all_reduce(totals)
        n_batches *= distributed.world_size()
    host = dict(zip(names, totals.tolist())) if totals is not None else {}
    sum_keys = ("sum_accu", "sum_iou", "cnt", "sum_seg_iou", "cnt_seg")
    stats = {k: host[k] / n_batches for k in names if k not in sum_keys}
    cnt = max(host.get("cnt", 0.0), 1.0)
    stats["accuracy_iou0.5"] = host.get("sum_accu", 0.0) / cnt
    stats["miou"] = host.get("sum_iou", 0.0) / cnt
    if "sum_seg_iou" in host:
        stats["seg_miou"] = host["sum_seg_iou"] / max(host["cnt_seg"], 1.0)
    # no auxiliary layer's loss in the stats (engine_vg.py:221-222)
    stats = {k: v for k, v in stats.items()
             if k.split("_")[-1] not in {"unscaled", "0", "1", "2", "3", "4"}}
    results: Dict[int, Any] = {}
    if boxes:
        arr = torch.cat(boxes).cpu().numpy()
        ids = np.concatenate([i for i, _ in rows])
        valid = np.concatenate([v for _, v in rows]).astype(bool)
        for i in range(arr.shape[0]):
            if valid[i].any():
                results[int(ids[i])] = arr[i][valid[i]].tolist()
    if collect_results and distributed.world_size() > 1:
        gathered: list = [None] * distributed.world_size()
        dist.all_gather_object(gathered, results)
        results = {k: v for part in gathered for k, v in part.items()}
    return stats, results
