"""Paired LQ/GT image dataset (reference:
basicsr/data/paired_image_dataset.py), the counterpart of
``edvr_tpu/data/paired_image_dataset.py``: pairs from a meta-info file or
two scanned folders, a training item cropped by ``paired_random_crop`` and
flipped/rotated by ``augment`` with draws from the dataset's own
``random.Random`` (``rng``, seeded by ``opt['seed']``; the loader's
``worker_init_fn`` reseeds each worker's copy), optional mean/std
normalisation. As in the JAX dataset, val/test items are the files as
they are (no crop). Items are ``lq`` and ``gt`` (c, h, w) float32 RGB
tensors and their paths. The disk backend only (LMDB: ROADMAP A.9).
"""

from __future__ import annotations

import random

import torch

from edvr_tpu_torch.data.data_util import (paired_paths_from_folder,
                                           paired_paths_from_meta_info_file)
from edvr_tpu_torch.data.file_client import FileClient
from edvr_tpu_torch.data.transforms import augment, paired_random_crop
from edvr_tpu_torch.utils import imfrombytes, img2tensor
from edvr_tpu_torch.utils.registry import DATASET_REGISTRY


def disk_only(io_backend_opt):
    if io_backend_opt['type'] != 'disk':
        raise NotImplementedError(
            f"io_backend {io_backend_opt['type']!r} is not ported yet; the "
            'disk backend is (ROADMAP A.9)')


def normalize(img, mean, std):
    """``(img - mean) / std`` per channel of a (c, h, w) tensor."""
    mean = torch.as_tensor(mean, dtype=img.dtype).view(-1, 1, 1)
    std = torch.as_tensor(std, dtype=img.dtype).view(-1, 1, 1)
    return (img - mean) / std


@DATASET_REGISTRY.register()
class PairedImageDataset(torch.utils.data.Dataset):

    def __init__(self, opt, rng=None):
        self.opt = opt
        self.rng = rng if rng is not None else random.Random(
            opt.get('seed', 0))
        disk_only(opt['io_backend'])
        self.file_client = None
        self.mean, self.std = opt.get('mean'), opt.get('std')
        folders = [opt['dataroot_lq'], opt['dataroot_gt']]
        filename_tmpl = opt.get('filename_tmpl', '{}')
        if opt.get('meta_info_file') is not None:
            self.paths = paired_paths_from_meta_info_file(
                folders, ['lq', 'gt'], opt['meta_info_file'], filename_tmpl)
        else:
            self.paths = paired_paths_from_folder(folders, ['lq', 'gt'],
                                                  filename_tmpl)

    def _read(self, path):
        return imfrombytes(self.file_client.get(path), float32=True)

    def __getitem__(self, index):
        if self.file_client is None:
            self.file_client = FileClient('disk')
        gt_path = self.paths[index]['gt_path']
        lq_path = self.paths[index]['lq_path']
        img_gt, img_lq = self._read(gt_path), self._read(lq_path)
        if self.opt['phase'] == 'train':
            img_gt, img_lq = paired_random_crop(
                img_gt, img_lq, self.opt['gt_size'], self.opt['scale'],
                self.rng, gt_path)
            img_gt, img_lq = augment([img_gt, img_lq], self.rng,
                                     self.opt['use_flip'],
                                     self.opt['use_rot'])
        img_gt, img_lq = img2tensor([img_gt, img_lq])
        if self.mean is not None or self.std is not None:
            img_lq = normalize(img_lq, self.mean, self.std)
            img_gt = normalize(img_gt, self.mean, self.std)
        return {'lq': img_lq, 'gt': img_gt, 'lq_path': lq_path,
                'gt_path': gt_path}

    def __len__(self):
        return len(self.paths)
