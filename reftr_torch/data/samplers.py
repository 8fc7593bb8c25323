"""Index samplers (port of reftr_tpu/data/samplers.py:1-77).

The reference's datasets/samplers.py:
  * ShardedSampler is DistributedSampler: a permutation seeded by
    seed + epoch, padded to a multiple of the replicas, one contiguous
    block per rank (samplers.py:40-58);
  * NodeShardedSampler is NodeDistributedSampler for cache_mode: each
    node's workers touch only the shard cached on that node
    (samplers.py:107-125).
The permutations are numpy's, so a (seed, epoch, replicas, rank) gives the
JAX package's order.
"""

from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np


class ShardedSampler:
    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} of {num_replicas} replicas")
        self.n = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(math.ceil(self.n / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def _order(self) -> List[int]:
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            return g.permutation(self.n).tolist()
        return list(range(self.n))

    def __iter__(self) -> Iterator[int]:
        indices = self._order()
        indices += indices[: self.total_size - len(indices)]  # pad
        offset = self.num_samples * self.rank  # a contiguous block per rank
        return iter(indices[offset: offset + self.num_samples])


class NodeShardedSampler(ShardedSampler):
    """cache_mode sharding: the indices cached on this node
    (idx % local_size == local_rank), then blocks across the nodes."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 local_rank: int = 0, local_size: int = 1,
                 shuffle: bool = True, seed: int = 0):
        super().__init__(dataset_len, num_replicas, rank, shuffle, seed)
        self.local_rank = local_rank
        self.local_size = local_size
        self.rank_in_part = rank // local_size
        n_parts_ranks = num_replicas // local_size
        local_count = len(range(local_rank, dataset_len, local_size))
        self.num_samples = int(math.ceil(local_count / n_parts_ranks))
        self.total_size_local = self.num_samples * n_parts_ranks

    def __iter__(self) -> Iterator[int]:
        indices = [i for i in self._order()
                   if i % self.local_size == self.local_rank]
        indices += indices[: self.total_size_local - len(indices)]
        offset = self.num_samples * self.rank_in_part
        return iter(indices[offset: offset + self.num_samples])
