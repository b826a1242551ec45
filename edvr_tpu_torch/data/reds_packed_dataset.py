"""REDS training dataset on packed frames (``.tpak``), the counterpart of
``edvr_tpu/data/reds_packed_dataset.py``: the sampling of
:class:`~edvr_tpu_torch.data.reds_dataset.REDSDataset` (a random interval,
the centre re-drawn while the window leaves the clip, optional reversal,
the validation partition's clips left out, one crop and one flip/rotation
draw), its crops read as uint8 by the tpak reader (``native/tpak.py``: no
PNG decode, no whole-frame read).

Items are ``lq`` (t, c, h, w) and ``gt`` (c, h, w) float32 RGB tensors in
[0, 1] (the packed files hold BGR, as cv2 reads them) and the ``key``.
Every draw comes from the dataset's own ``random.Random`` (``rng``), in
the JAX dataset's order.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from edvr_tpu_torch.data.reds_dataset import _val_clips
from edvr_tpu_torch.data.transforms import augment
from edvr_tpu_torch.utils import get_root_logger
from edvr_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class REDSPackedDataset(torch.utils.data.Dataset):
    """``dataroot_gt`` / ``dataroot_lq`` are ``.tpak`` files; the other
    options are REDSDataset's."""

    def __init__(self, opt, rng=None):
        from edvr_tpu_torch.native.tpak import TpakReader
        self.opt = opt
        self.rng = rng if rng is not None else random.Random(
            opt.get('seed', 0))
        self.gt_pak = TpakReader(opt['dataroot_gt'])
        self.lq_pak = TpakReader(opt['dataroot_lq'])
        self.num_frame = opt['num_frame']
        if self.num_frame % 2 != 1:
            raise ValueError(f'num_frame must be odd, got {self.num_frame}')
        self.half_window = self.num_frame // 2
        excluded = _val_clips(opt['val_partition'])
        self.keys = []  # (lq clip, gt clip, frame)
        for name in self.lq_pak.clip_names:
            if name in excluded:
                continue
            lq_idx = self.lq_pak.name_to_idx[name]
            gt_idx = self.gt_pak.name_to_idx[name]
            self.keys += [(lq_idx, gt_idx, f)
                          for f in range(self.lq_pak.clip_frames[lq_idx])]
        self.interval_list = opt['interval_list']
        self.random_reverse = opt['random_reverse']
        self.n_threads = opt.get('num_worker_per_gpu', 4) or 4
        get_root_logger().info(f'REDSPackedDataset: {len(self.keys)} samples '
                               f"from {opt['dataroot_lq']}")

    def __getitem__(self, index):
        scale = self.opt['scale']
        gt_size = self.opt['gt_size']
        lq_size = gt_size // scale
        lq_idx, gt_idx, center = self.keys[index]
        clip_len = self.lq_pak.clip_frames[lq_idx]
        h_lq, w_lq, _ = self.lq_pak.clip_shapes[lq_idx]

        interval = self.rng.choice(self.interval_list)
        reach = self.half_window * interval
        while center - reach < 0 or center + reach > clip_len - 1:
            center = self.rng.randint(0, clip_len - 1)
        start = center - reach
        if self.random_reverse and self.rng.random() < 0.5:
            start, interval = center + reach, -interval
        top = self.rng.randint(0, h_lq - lq_size)
        left = self.rng.randint(0, w_lq - lq_size)

        lqs = self.lq_pak.read_windows(
            [lq_idx], [start], [interval], [top], [left], lq_size, lq_size,
            self.num_frame, self.n_threads)[0]  # (t, h, w, c) uint8 BGR
        gt = self.gt_pak.read_windows(
            [gt_idx], [center], [1], [top * scale], [left * scale], gt_size,
            gt_size, 1, self.n_threads)[0, 0]
        imgs = augment(list(lqs) + [gt], self.rng, self.opt['use_flip'],
                       self.opt['use_rot'])
        # BGR uint8 -> RGB float32, as the JAX dataset converts them
        imgs = [torch.from_numpy(np.ascontiguousarray(
            (im[..., ::-1].astype(np.float32) / 255.).transpose(2, 0, 1)))
            for im in imgs]
        clip_name = self.lq_pak.clip_names[lq_idx]
        return {'lq': torch.stack(imgs[:-1], 0), 'gt': imgs[-1],
                'key': f'{clip_name}/{center:08d}'}

    def __len__(self):
        return len(self.keys)
