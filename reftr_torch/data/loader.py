"""Batched, pipelined data loader (port of reftr_tpu/data/loader.py:1-138).

  * a thread pool maps the dataset's __getitem__ over the sampler's
    indices (the native C++ ops release the GIL inside their ctypes
    calls), with the item futures of the next ``prefetch_depth`` batches
    submitted before the loader waits on the current one;
  * batches are stacked numpy dicts (the datasets emit fixed shapes); the
    train and eval steps upload them (``train/steps.py::to_device``);
  * a background thread fills a queue of depth ``prefetch_depth``; an
    error in a worker reaches the consumer;
  * without drop_last the final batch is padded to the batch size with
    copies of its last item whose ``box_valid`` (and ``mask_valid``) are
    zeroed, so losses and metrics leave them out and every batch has one
    shape.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from reftr_torch.data.samplers import ShardedSampler


def collate(items) -> Tuple[Dict, Dict]:
    """Stack a list of (sample, target) dicts into batch dicts."""
    samples = {k: np.stack([it[0][k] for it in items]) for k in items[0][0]}
    targets = {k: np.stack([it[1][k] for it in items]) for k in items[0][1]}
    return samples, targets


class DataLoader:
    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[ShardedSampler] = None,
                 num_workers: int = 2, drop_last: bool = True,
                 prefetch_depth: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(len(dataset), shuffle=False)
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_depth = prefetch_depth

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n //
                                                             self.batch_size)

    def _pad(self, items):
        """Pad the final batch to the batch size with copies of its last
        item whose validity flags are zeroed."""
        s, t = items[-1]
        t = dict(t)
        for key in ("box_valid", "mask_valid"):
            if key in t:
                t[key] = np.zeros_like(t[key])
        return items + [(s, t)] * (self.batch_size - len(items))

    def _batches(self) -> Iterator[Tuple[Dict, Dict]]:
        idx = list(self.sampler)
        spans = [idx[i: i + self.batch_size]
                 for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            spans = [s for s in spans if len(s) == self.batch_size]
        lookahead = max(1, self.prefetch_depth)
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = deque()
            span_it = iter(spans)

            def fill():
                # at most ``prefetch_depth`` batches of item futures in
                # flight beyond the one being consumed
                while len(pending) < lookahead:
                    span = next(span_it, None)
                    if span is None:
                        return
                    pending.append([pool.submit(self.dataset.__getitem__, i)
                                    for i in span])

            fill()
            while pending:
                futs = pending.popleft()
                fill()  # keep the pool fed before waiting on results
                items = [f.result() for f in futs]
                if len(items) < self.batch_size:
                    items = self._pad(items)
                yield collate(items)

    def __iter__(self) -> Iterator[Tuple[Dict, Dict]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        done = object()
        err: list = []

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:  # a worker's error reaches the consumer
                err.append(e)
            finally:
                q.put(done)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
