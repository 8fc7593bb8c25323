"""Epoch-level training loop (port of reftr_tpu/train/engine.py:56-108).

``train_one_epoch`` runs one train step per batch and logs each step's
metrics one step late: step i-1's are read while step i runs on the
device, so the host never waits on the step it just launched. The NaN
tripwire of the reference (engine_vg.py:55-58) is kept, on that late read.
Loss terms are logged scaled by their weight under their own names, as the
reference logs them; terms outside the weight dict are dropped. There is no
profiler hook and no visual dump here; ``engine.evaluate`` comes with the
training loop and its CLI.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Iterable, Tuple

from reftr_torch.core.metrics import MetricLogger, SmoothedValue
from reftr_torch.train.state import TrainState


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
        state, metrics = train_step(state, samples, targets)
        if prev_metrics is not None:
            _log_train_metrics(prev_metrics, weight_dict, logger, print_fn)
        prev_metrics = metrics
    if prev_metrics is not None:
        _log_train_metrics(prev_metrics, weight_dict, logger, print_fn)
    return state, {k: m.global_avg for k, m in logger.meters.items()}
