"""FFHQ faces for StyleGAN2 training (reference:
basicsr/data/ffhq_dataset.py), the counterpart of
``edvr_tpu/data/ffhq_dataset.py``: GT-only items over the 70,000 images of
Flickr-Faces-HQ on disk (``<dataroot_gt>/{index:08d}.png``), flipped
horizontally at random (``use_hflip``) and normalised by ``mean`` and
``std``. The flip's draw comes from the dataset's own ``random.Random``
(``rng``, seeded by ``opt['seed']``; the loader's ``worker_init_fn``
reseeds each worker's copy). Items are ``gt`` (c, h, w) float32 RGB
tensors and ``gt_path``. The disk backend only (LMDB: ROADMAP A.9).
"""

from __future__ import annotations

import random
from os import path as osp

import torch

from edvr_tpu_torch.data.file_client import FileClient
from edvr_tpu_torch.data.paired_image_dataset import disk_only, normalize
from edvr_tpu_torch.data.transforms import augment
from edvr_tpu_torch.utils import imfrombytes, img2tensor
from edvr_tpu_torch.utils.registry import DATASET_REGISTRY

FFHQ_SIZE = 70000  # the released set is exactly 70k images


@DATASET_REGISTRY.register()
class FFHQDataset(torch.utils.data.Dataset):

    def __init__(self, opt, rng=None):
        self.opt = opt
        self.rng = rng if rng is not None else random.Random(
            opt.get('seed', 0))
        disk_only(opt['io_backend'])
        self.file_client = None
        self.mean, self.std = opt['mean'], opt['std']
        self.paths = [osp.join(opt['dataroot_gt'], f'{v:08d}.png')
                      for v in range(FFHQ_SIZE)]

    def __getitem__(self, index):
        if self.file_client is None:
            self.file_client = FileClient('disk')
        path = self.paths[index]
        img = imfrombytes(self.file_client.get(path), float32=True)
        img = augment(img, self.rng, hflip=self.opt['use_hflip'],
                      rotation=False)
        img = normalize(img2tensor(img), self.mean, self.std)
        return {'gt': img, 'gt_path': path}

    def __len__(self):
        return len(self.paths)
