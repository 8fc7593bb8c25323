"""Epoch-level train and eval loops (port of reftr_tpu/train/engine.py:
56-108, 151-222).

``train_one_epoch`` runs one train step per batch and logs each step's
metrics one step late: step i-1's are read while step i runs on the
device, so the host never waits on the step it just launched. At the end
of the epoch the meters are averaged over the data shards (JAX's
``synchronize_between_processes``). The NaN tripwire of the reference
(engine_vg.py:55-58) is kept, on that late read.
Loss terms are logged scaled by their weight under their own names, as the
reference logs them; terms outside the weight dict are dropped.

``evaluate`` runs the eval step over a loader and gives P@0.5, mIoU (and,
when the step gives the seg sums, the seg mIoU) and the mean of each
scaled loss term over the batches, and the boxes in the original image's
pixels by image id. Its sums stay on the device and are read once per
pass; under a process group they are summed over the data axis first (the
world, or the mesh's data group: ``parallel/context.py::data_axis``; JAX's
``allreduce_sum_host``, reftr_tpu/train/engine.py:212-213), so every rank
reports the global stats, and the shards' boxes are gathered, so that
every rank holds the whole split's. With ``visualize_dir`` it writes the
reference's qualitative dumps of the first VISUALIZE_LIMIT (64) samples
(engine_vg.py:86-197; ``tools/visualize.py``, PIL) on rank 0.

``train_one_epoch``'s ``profile_dir`` (``--profile_dir``) captures a
torch.profiler trace of steps ``profile_steps`` of epoch 0 into that
directory (JAX's jax.profiler hook, reftr_tpu/train/engine.py:66-104):
the card's kernels with the host's ops where there is a card, one Chrome
trace file per process (``tensorboard_trace_handler``).
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
from reftr_torch.models.postprocess import decode_boxes, segm_masks
from reftr_torch.ops.boxes import box_cxcywh_to_xyxy
from reftr_torch.parallel.context import data_axis
from reftr_torch.train.state import TrainState

# target keys the steps do not read: kept on the host
HOST_TARGET_KEYS = ("orig_size", "size", "image_id")
# samples with visual dumps under --visualize (engine_vg.py's eval)
VISUALIZE_LIMIT = 64


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


def _start_trace(profile_dir: str):
    """A started torch.profiler session that writes its trace into
    ``profile_dir`` when it stops."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    return prof


def train_one_epoch(train_step, state: TrainState, loader: Iterable,
                    epoch: int, print_freq: int = 50, *,
                    weight_dict: Dict[str, float],
                    print_fn=print, profile_dir: str = "",
                    profile_steps: Tuple[int, int] = (10, 15)
                    ) -> Tuple[TrainState, Dict[str, float]]:
    """Train over ``loader``, an iterable of numpy (batch, targets) pairs.
    Returns (state, the epoch's average of each logged metric). With
    ``profile_dir``, epoch 0's steps [profile_steps) are traced into it
    (to the epoch's end where it has fewer steps)."""
    logger = MetricLogger(print_fn=print_fn)
    logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    header = f"Epoch: [{epoch}]"
    prev_metrics = None
    prof = None
    try:
        for i, (samples, targets) in enumerate(
                logger.log_every(loader, print_freq, header)):
            if profile_dir and epoch == 0:
                if i == profile_steps[0]:
                    prof = _start_trace(profile_dir)
                elif i == profile_steps[1] and prof is not None:
                    prof.stop()
                    prof = None
            state, metrics = train_step(state, samples,
                                        _strip_target(targets))
            if prev_metrics is not None:
                _log_train_metrics(prev_metrics, weight_dict, logger,
                                   print_fn)
            prev_metrics = metrics
    finally:
        if prof is not None:
            prof.stop()
    if prev_metrics is not None:
        _log_train_metrics(prev_metrics, weight_dict, logger, print_fn)
    logger.synchronize_between_processes()
    return state, {k: m.global_avg for k, m in logger.meters.items()}


def _dump_visuals(out_dir: str, idx_base: int, samples, targets,
                  out) -> None:
    """Per-sample dumps (reftr_tpu/train/engine.py:111-148): the first
    query's box and the true box at the canvas' scale, the mask (logits
    upsampled to the canvas, sigmoid > 0.5), the true mask and the
    attention maps of each head."""
    from reftr_torch.tools.visualize import dump_eval_visuals

    images = np.asarray(samples["image"])  # uint8 canvases
    sizes = np.asarray(targets["size"]).astype(np.float32)  # resized (h, w)
    pred = decode_boxes(out["pred_boxes"].float()).cpu().numpy()
    gt = box_cxcywh_to_xyxy(torch.as_tensor(
        np.asarray(targets["boxes"]))).numpy()
    masks = out.get("pred_masks")
    if masks is not None:
        masks = segm_masks(masks[:, :1], images.shape[1:3])[:, 0]
        masks = masks.cpu().numpy()
    att = out.get("mask_att")
    if att is not None:
        att = att.float().cpu().numpy()
    for i in range(images.shape[0]):
        h, w = sizes[i]
        scale = np.array([w, h, w, h], np.float32)
        dump_eval_visuals(
            out_dir, idx_base + i, images[i], pred[i, 0] * scale,
            gt[i, 0] * scale,
            pred_mask=None if masks is None else masks[i],
            gt_mask=(np.asarray(targets["masks"])[i] if "masks" in targets
                     else None),
            attention=None if att is None else att[i])


def evaluate(eval_step, loader: Iterable,
             weight_dict: Optional[Dict[str, float]] = None,
             print_freq: int = 50, collect_results: bool = False,
             print_fn=print, visualize_dir: str = ""
             ) -> Tuple[Dict[str, float], Dict[int, Any]]:
    """Returns (stats, results). stats: accuracy_iou0.5, miou, seg_miou
    when the step gives sum_seg_iou and cnt_seg (RES) and, with a
    ``weight_dict``, the batches' mean of the total loss and of each
    scaled term but the auxiliary layers' (engine_vg.py:221-222). results
    (with ``collect_results``): image id -> the valid rows' boxes, xyxy in
    the original image's pixels. Rows of a padded batch whose boxes are
    all invalid are skipped, so they cannot overwrite a real entry. With
    ``visualize_dir``, rank 0 writes the visual dumps of the first
    VISUALIZE_LIMIT samples under <visualize_dir>/vis/."""
    logger = MetricLogger(print_fn=print_fn)
    totals = None  # device float64: scaled losses, then the metric sums
    names: list = []
    n_batches = n_rows = n_dumped = 0
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
        if (visualize_dir and n_dumped < VISUALIZE_LIMIT
                and distributed.is_main_process()):
            _dump_visuals(visualize_dir, n_dumped, samples, targets, out)
        n_dumped += len(samples["image"])
        if collect_results:
            sizes = torch.from_numpy(targets["orig_size"]).to(
                out["pred_boxes"].device, torch.float32)
            boxes.append(decode_boxes(out["pred_boxes"], sizes,
                                      scale_to_original_shape=True))
            b = len(targets["box_valid"])
            ids = targets.get("image_id", np.arange(n_rows, n_rows + b))
            rows.append((ids, targets["box_valid"]))
            n_rows += b
    shards, group = data_axis()
    if totals is not None and shards > 1:
        # every data shard runs as many batches (the test sampler pads the
        # split to a multiple of the shards, and the padded rows count, as
        # in JAX and the reference): the sums add up and the losses'
        # means over the batches are the global ones; a model group's
        # ranks hold one shard and count once (the data group)
        totals = totals.to(distributed.collective_device())
        dist.all_reduce(totals, group=group)
        n_batches *= shards
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
    if collect_results and shards > 1:
        gathered: list = [None] * shards
        dist.all_gather_object(gathered, results, group=group)
        results = {k: v for part in gathered for k, v in part.items()}
    return stats, results
