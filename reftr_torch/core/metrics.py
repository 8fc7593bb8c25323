"""Training metrics: smoothed meters and a progress logger (port of
reftr_tpu/core/metrics.py:21-137).

Windowed medians and averages, iteration and data timing, ETA and periodic
printing; the peak device memory is torch.cuda.max_memory_allocated.
Under a process group ``synchronize_between_processes`` sums each meter's
total and count over the ranks of the data axis (``parallel/context.py``:
the world, or the mesh's data group, whose model replicas log the same
values), so that its global average is the average over every data
shard's updates (the median and window stay the rank's own).
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from reftr_torch.core.distributed import allreduce_sum_host
from reftr_torch.parallel.context import data_axis


class SmoothedValue:
    """Track a series over a sliding window and its global average."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        s = allreduce_sum_host({"count": float(self.count),
                                "total": self.total}, *data_axis())
        self.count = int(s["count"])
        self.total = s["total"]

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


def _device_mem_mb() -> Optional[float]:
    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        i = 0
        if total is None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_sec = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_sec))}  "
                mem = _device_mem_mb()
                mem_s = f"  max mem: {mem:.0f}MB" if mem is not None else ""
                count = f"[{i}" + (f"/{total}]" if total else "]")
                self.print_fn(
                    f"{header} {count}  {eta}{self}  "
                    f"time: {iter_time}  data: {data_time}{mem_s}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        per_it = elapsed / max(i, 1)
        self.print_fn(
            f"{header} Total time: "
            f"{datetime.timedelta(seconds=int(elapsed))} ({per_it:.4f} s / it)")
