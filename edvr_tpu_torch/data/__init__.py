"""Data layer: datasets by YAML ``type`` name and the loader factory
(reference: basicsr/data/__init__.py)."""

from __future__ import annotations

from copy import deepcopy

import torch

from edvr_tpu_torch.data import video_test_dataset  # noqa: F401 (registers)
from edvr_tpu_torch.utils import get_root_logger
from edvr_tpu_torch.utils.registry import DATASET_REGISTRY

__all__ = ['create_dataset', 'create_dataloader']


def create_dataset(dataset_opt: dict):
    """Create a dataset from its YAML options
    (reference: basicsr/data/__init__.py:29-53)."""
    dataset_opt = deepcopy(dataset_opt)
    dataset = DATASET_REGISTRY.get(dataset_opt['type'])(dataset_opt)
    get_root_logger().info(
        f'Dataset {dataset.__class__.__name__} - {dataset_opt["name"]} '
        'is created.')
    return dataset


def create_dataloader(dataset, dataset_opt):
    """A batch-1, unshuffled loader for a val/test dataset
    (reference: basicsr/data/__init__.py:99-101). Training loaders are not
    ported yet."""
    phase = dataset_opt['phase']
    if phase not in ('val', 'test'):
        raise NotImplementedError(
            f'{phase!r} loaders are not ported yet (val/test only)')
    return torch.utils.data.DataLoader(dataset, batch_size=1, shuffle=False,
                                       num_workers=0)
