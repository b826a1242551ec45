"""LQ-only image dataset for testing without GT (reference:
basicsr/data/single_image_dataset.py), the counterpart of
``edvr_tpu/data/single_image_dataset.py``: the images of a meta-info file
or of a folder (sorted), optional mean/std normalisation. Items are ``lq``
(c, h, w) float32 RGB tensors and ``lq_path``. The disk backend only."""

from __future__ import annotations

import torch

from edvr_tpu_torch.data.data_util import paths_from_folder
from edvr_tpu_torch.data.file_client import FileClient
from edvr_tpu_torch.data.paired_image_dataset import disk_only, normalize
from edvr_tpu_torch.utils import imfrombytes, img2tensor
from edvr_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class SingleImageDataset(torch.utils.data.Dataset):

    def __init__(self, opt):
        self.opt = opt
        disk_only(opt['io_backend'])
        self.file_client = None
        self.mean, self.std = opt.get('mean'), opt.get('std')
        lq_folder = opt['dataroot_lq']
        if opt.get('meta_info_file') is not None:
            with open(opt['meta_info_file']) as fin:
                self.paths = [f'{lq_folder}/{line.rstrip()}' for line in fin]
        else:
            self.paths = sorted(paths_from_folder(lq_folder))

    def __getitem__(self, index):
        if self.file_client is None:
            self.file_client = FileClient('disk')
        lq_path = self.paths[index]
        img_lq = img2tensor(imfrombytes(self.file_client.get(lq_path),
                                        float32=True))
        if self.mean is not None or self.std is not None:
            img_lq = normalize(img_lq, self.mean, self.std)
        return {'lq': img_lq, 'lq_path': lq_path}

    def __len__(self):
        return len(self.paths)
