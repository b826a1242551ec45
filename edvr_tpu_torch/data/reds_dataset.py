"""REDS training dataset (reference: basicsr/data/reds_dataset.py), the
counterpart of ``edvr_tpu/data/reds_dataset.py::REDSDataset``: a random
temporal window around each key frame (interval drawn from
``interval_list``, centre re-drawn while the window leaves the 100-frame
clip, optional reversal), validation clips left out, one paired crop and
one flip/rotation draw shared by the window and its GT frame.

Items are ``lq`` (t, c, h, w) and ``gt`` (c, h, w) float32 RGB tensors in
[0, 1] and the ``key``; with ``dataroot_flow``, also ``flow`` (t, 2, h, w):
the centre frame's quantized flows to its neighbours (PNGs ``<frame>_p<i>``
and ``_n<i>``, past then future, ``max_val`` 20, not denormalised), cropped
and augmented with the window, a zero flow at the centre. Every draw comes
from the dataset's own ``random.Random`` (``rng``), in the JAX dataset's
order. The loader's ``worker_init_fn`` reseeds each worker's copy. The LMDB
backend is not ported (ROADMAP A.9).
"""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np
import torch

from edvr_tpu_torch.data.file_client import FileClient
from edvr_tpu_torch.data.transforms import augment, paired_random_crop
from edvr_tpu_torch.utils import get_root_logger, imfrombytes, img2tensor
from edvr_tpu_torch.utils.flow_util import dequantize_flow
from edvr_tpu_torch.utils.registry import DATASET_REGISTRY

# REDS clips are exactly 100 frames, 00000000..00000099
_CLIP_LEN = 100


def _val_clips(partition: str) -> set:
    """Clip names reserved for validation
    (reference: reds_dataset.py:71-81)."""
    if partition == 'REDS4':
        return {'000', '011', '015', '020'}
    if partition == 'official':
        return {f'{v:03d}' for v in range(240, 270)}
    raise ValueError(f'Unknown REDS validation partition "{partition}" '
                     "(expected 'REDS4' or 'official').")


@DATASET_REGISTRY.register()
class REDSDataset(torch.utils.data.Dataset):

    def __init__(self, opt, rng=None):
        self.opt = opt
        self.rng = rng if rng is not None else random.Random(
            opt.get('seed', 0))
        self.gt_root = Path(opt['dataroot_gt'])
        self.lq_root = Path(opt['dataroot_lq'])
        flow = opt.get('dataroot_flow')
        self.flow_root = Path(flow) if flow is not None else None
        if opt['io_backend']['type'] != 'disk':
            raise NotImplementedError(
                f"io_backend {opt['io_backend']['type']!r} is not ported "
                'yet; the disk backend is (ROADMAP A.9)')
        self.num_frame = opt['num_frame']
        if self.num_frame % 2 != 1:
            raise ValueError(f'num_frame must be odd, got {self.num_frame}')
        self.half_window = self.num_frame // 2

        excluded = _val_clips(opt['val_partition'])
        self.keys = []
        with open(opt['meta_info_file']) as fin:
            for line in fin:
                clip, n_frames = line.split(' ')[:2]
                if clip not in excluded:
                    self.keys += [f'{clip}/{i:08d}'
                                  for i in range(int(n_frames))]
        self.file_client = None
        self.interval_list = opt['interval_list']
        self.random_reverse = opt['random_reverse']
        get_root_logger().info(
            'Temporal augmentation interval list: '
            f'[{",".join(str(x) for x in self.interval_list)}]; '
            f'random reverse is {self.random_reverse}.')

    def _window(self, center: int):
        """Draw the temporal window (reference: reds_dataset.py:117-136)."""
        interval = self.rng.choice(self.interval_list)
        reach = self.half_window * interval
        while center - reach < 0 or center + reach > _CLIP_LEN - 1:
            center = self.rng.randint(0, _CLIP_LEN - 1)
        frames = list(range(center - reach, center + reach + 1, interval))
        if self.random_reverse and self.rng.random() < 0.5:
            frames.reverse()
        return center, frames

    def _read(self, path):
        return imfrombytes(self.file_client.get(path), float32=True)

    def _flows(self, clip, center):
        """The centre frame's flows to its neighbours, past then future
        (reference: reds_dataset.py:160-198)."""
        tags = ([f'_p{i}' for i in range(self.half_window, 0, -1)] +
                [f'_n{i}' for i in range(1, self.half_window + 1)])
        flows = []
        for tag in tags:
            packed = imfrombytes(self.file_client.get(
                self.flow_root / clip / f'{center:08d}{tag}.png'),
                flag='grayscale')
            dx, dy = np.split(packed, 2, axis=0)
            flows.append(dequantize_flow(dx, dy, max_val=20, denorm=False))
        return flows

    def __getitem__(self, index):
        if self.file_client is None:
            self.file_client = FileClient('disk')
        key = self.keys[index]
        clip, frame_name = key.split('/')
        center, window = self._window(int(frame_name))

        gt_path = self.gt_root / clip / f'{center:08d}.png'
        img_gt = self._read(gt_path)
        img_lqs = [self._read(self.lq_root / clip / f'{f:08d}.png')
                   for f in window]
        # the flows ride along through the paired crop
        flows = (self._flows(clip, center) if self.flow_root is not None
                 else [])
        img_gt, img_lqs = paired_random_crop(img_gt, img_lqs + flows,
                                             self.opt['gt_size'],
                                             self.opt['scale'], self.rng,
                                             str(gt_path))
        img_lqs, flows = img_lqs[:self.num_frame], img_lqs[self.num_frame:]
        img_lqs.append(img_gt)
        if self.flow_root is None:
            frames = img2tensor(augment(img_lqs, self.rng,
                                        self.opt['use_flip'],
                                        self.opt['use_rot']))
        else:
            frames, flows = augment(img_lqs, self.rng, self.opt['use_flip'],
                                    self.opt['use_rot'], flows)
            frames = img2tensor(frames)
        item = {'lq': torch.stack(frames[:-1], 0), 'gt': frames[-1],
                'key': key}
        if self.flow_root is not None:
            flows = img2tensor(flows, bgr2rgb=False)
            # the centre frame has no flow to itself: a zero placeholder
            flows.insert(self.half_window, torch.zeros_like(flows[0]))
            item['flow'] = torch.stack(flows, 0)
        return item

    def __len__(self):
        return len(self.keys)
