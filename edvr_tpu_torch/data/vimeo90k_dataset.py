"""Vimeo90K septuplet training dataset (reference:
basicsr/data/vimeo90k_dataset.py), the counterpart of
``edvr_tpu/data/vimeo90k_dataset.py``: the GT is frame ``im4``, the
``num_frame`` LQ neighbours are centred on it (the list reversed in place
with probability 1/2 under ``random_reverse``, as in both), one paired crop
and one flip/rotation draw shared by the window and its GT.

Items are ``lq`` (t, c, h, w) and ``gt`` (c, h, w) float32 RGB tensors in
[0, 1] and the ``key``. Every draw comes from the dataset's own
``random.Random`` (``rng``), in the JAX dataset's order. The disk backend
only (LMDB: ROADMAP A.9).
"""

from __future__ import annotations

import random
from pathlib import Path

import torch

from edvr_tpu_torch.data.file_client import FileClient
from edvr_tpu_torch.data.paired_image_dataset import disk_only
from edvr_tpu_torch.data.transforms import augment, paired_random_crop
from edvr_tpu_torch.utils import get_root_logger, imfrombytes, img2tensor
from edvr_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class Vimeo90KDataset(torch.utils.data.Dataset):

    def __init__(self, opt, rng=None):
        self.opt = opt
        self.rng = rng if rng is not None else random.Random(
            opt.get('seed', 0))
        disk_only(opt['io_backend'])
        self.gt_root = Path(opt['dataroot_gt'])
        self.lq_root = Path(opt['dataroot_lq'])
        with open(opt['meta_info_file']) as fin:
            self.keys = [line.split(' ')[0] for line in fin]
        self.file_client = None
        # neighbours centred on im4 (reference: vimeo90k_dataset.py:69-71)
        self.neighbor_list = [i + (9 - opt['num_frame']) // 2
                              for i in range(opt['num_frame'])]
        self.random_reverse = opt['random_reverse']
        get_root_logger().info(f'Random reverse is {self.random_reverse}.')

    def _read(self, path):
        return imfrombytes(self.file_client.get(path), float32=True)

    def __getitem__(self, index):
        if self.file_client is None:
            self.file_client = FileClient('disk')
        if self.random_reverse and self.rng.random() < 0.5:
            self.neighbor_list.reverse()
        key = self.keys[index]
        clip, seq = key.split('/')
        gt_path = self.gt_root / clip / seq / 'im4.png'
        img_gt = self._read(gt_path)
        img_lqs = [self._read(self.lq_root / clip / seq / f'im{i}.png')
                   for i in self.neighbor_list]
        img_gt, img_lqs = paired_random_crop(img_gt, img_lqs,
                                             self.opt['gt_size'],
                                             self.opt['scale'], self.rng,
                                             str(gt_path))
        img_lqs.append(img_gt)
        frames = img2tensor(augment(img_lqs, self.rng, self.opt['use_flip'],
                                    self.opt['use_rot']))
        return {'lq': torch.stack(frames[:-1], 0), 'gt': frames[-1],
                'key': key}

    def __len__(self):
        return len(self.keys)
