"""Data layer: datasets by YAML ``type`` name, the loader factory and the
CPU and CUDA prefetchers (reference: basicsr/data/__init__.py and
prefetch_dataloader.py)."""

from __future__ import annotations

from copy import deepcopy

import torch

from edvr_tpu_torch.data import (  # noqa: F401 (registers)
    ffhq_dataset, paired_image_dataset, reds_dataset, reds_packed_dataset,
    single_image_dataset, video_test_dataset, vimeo90k_dataset)
from edvr_tpu_torch.data.data_sampler import EnlargedSampler
from edvr_tpu_torch.data.prefetcher import CUDAPrefetcher
from edvr_tpu_torch.utils import get_root_logger
from edvr_tpu_torch.utils.registry import DATASET_REGISTRY

__all__ = ['create_dataset', 'create_dataloader', 'CPUPrefetcher',
           'CUDAPrefetcher', 'EnlargedSampler']


def create_dataset(dataset_opt: dict):
    """Create a dataset from its YAML options
    (reference: basicsr/data/__init__.py:29-53)."""
    dataset_opt = deepcopy(dataset_opt)
    dataset = DATASET_REGISTRY.get(dataset_opt['type'])(dataset_opt)
    get_root_logger().info(
        f'Dataset {dataset.__class__.__name__} - {dataset_opt["name"]} '
        'is created.')
    return dataset


def _seed_worker(worker_id):
    """Reseed a loader worker's copy of the dataset's generator from the
    worker's torch seed, which the loader's seeded generator sets apart
    per worker."""
    dataset = torch.utils.data.get_worker_info().dataset
    if hasattr(dataset, 'rng'):
        dataset.rng.seed(torch.initial_seed())


def create_dataloader(dataset, dataset_opt, num_gpu=1, dist=False,
                      sampler=None, seed=None, pin_memory=False):
    """A loader with the reference's phase semantics
    (reference: basicsr/data/__init__.py:56-119): a training loader drops
    the last partial batch and reseeds each worker from ``seed``; a
    val/test loader is batch-1, unshuffled and synchronous.

    Without ``dist`` one process feeds all ``num_gpu`` devices, so a
    training batch holds ``batch_size_per_gpu x max(num_gpu, 1)`` items
    loaded by ``num_worker_per_gpu x max(num_gpu, 1)`` workers, as in
    ``edvr_tpu/data/__init__.py:50-60``; with ``dist`` each process loads
    its own device's share. ``pin_memory`` pins a training loader's
    batches (for :class:`CUDAPrefetcher`'s asynchronous copies).
    """
    phase = dataset_opt['phase']
    if phase == 'train':
        multiplier = 1 if dist else max(num_gpu, 1)
        batch_size = dataset_opt['batch_size_per_gpu'] * multiplier
        workers = dataset_opt['num_worker_per_gpu'] * multiplier
        # workers are spawned, not forked (the training process has
        # threads), and kept across epochs so they start once
        return torch.utils.data.DataLoader(
            dataset, batch_size=batch_size,
            shuffle=sampler is None, sampler=sampler, num_workers=workers,
            drop_last=True, worker_init_fn=_seed_worker,
            generator=torch.Generator().manual_seed(seed or 0),
            multiprocessing_context='spawn' if workers else None,
            persistent_workers=workers > 0, pin_memory=pin_memory)
    if phase in ('val', 'test'):
        return torch.utils.data.DataLoader(dataset, batch_size=1,
                                           shuffle=False, num_workers=0)
    raise ValueError(f'Wrong dataset phase: {phase}. '
                     "Supported ones are 'train', 'val' and 'test'.")


class CPUPrefetcher:
    """Plain iterator facade over a loader
    (reference: prefetch_dataloader.py:63-81)."""

    def __init__(self, loader):
        self.ori_loader = loader
        self.loader = iter(loader)

    def next(self):
        try:
            return next(self.loader)
        except StopIteration:
            return None

    def reset(self):
        self.loader = iter(self.ori_loader)
