"""Index sampling of the training loader (reference:
basicsr/data/data_sampler.py:21-49), the counterpart of
``edvr_tpu/data/data_sampler.py``: each epoch one permutation of a
virtually ``ratio``-enlarged index space, seeded by the epoch, of which
each rank takes every ``num_replicas``-th entry."""

from __future__ import annotations

import numpy as np


class EnlargedSampler:
    """Epoch-seeded, rank-strided sampler over an enlarged index space."""

    def __init__(self, dataset, num_replicas: int = 1, rank: int = 0,
                 ratio: int = 1):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = -(-len(dataset) * ratio // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        order = np.random.RandomState(self.epoch).permutation(
            self.total_size)
        mine = order[self.rank::self.num_replicas] % len(self.dataset)
        return iter(mine.tolist())
