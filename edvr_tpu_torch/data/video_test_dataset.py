"""Video test datasets (reference: basicsr/data/video_test_dataset.py), the
counterparts of ``edvr_tpu/data/video_test_dataset.py``: ``VideoTestDataset``,
per-frame items with folder/idx/border bookkeeping for Vid4, REDS4 and
REDSofficial (with ``cache_data`` every clip is held in memory as a
(t, c, h, w) tensor in ``imgs_lq`` / ``imgs_gt``, keyed by folder);
``VideoTestVimeo90KDataset``, Vimeo90K's centre-frame testing;
``VideoTestDUFDataset``, whose LQ windows may be made from the GT frames by
DUF's Gaussian downsampling; and ``VideoRecurrentTestDataset``, one item a
whole cached clip.
"""

from __future__ import annotations

import glob
from os import path as osp

import torch

from edvr_tpu_torch.data.data_util import (duf_downsample,
                                           generate_frame_indices,
                                           read_img_seq)
from edvr_tpu_torch.utils import get_root_logger, scandir
from edvr_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class VideoTestDataset(torch.utils.data.Dataset):

    def __init__(self, opt):
        self.opt = opt
        self.cache_data = opt['cache_data']
        self.gt_root, self.lq_root = opt['dataroot_gt'], opt['dataroot_lq']
        self.data_info = {'lq_path': [], 'gt_path': [], 'folder': [],
                          'idx': [], 'border': []}
        if opt['io_backend']['type'] == 'lmdb':
            raise ValueError('No need to use lmdb during validation/test.')

        logger = get_root_logger()
        logger.info(
            f'Generate data info for VideoTestDataset - {opt["name"]}')
        self.imgs_lq, self.imgs_gt = {}, {}
        if opt.get('meta_info_file'):
            with open(opt['meta_info_file'], 'r') as fin:
                subfolders = [line.split(' ')[0] for line in fin]
            subfolders_lq = [osp.join(self.lq_root, k) for k in subfolders]
            subfolders_gt = [osp.join(self.gt_root, k) for k in subfolders]
        else:
            subfolders_lq = sorted(glob.glob(osp.join(self.lq_root, '*')))
            subfolders_gt = sorted(glob.glob(osp.join(self.gt_root, '*')))

        if opt['name'].lower() not in ('vid4', 'reds4', 'redsofficial'):
            raise ValueError(
                f'Non-supported video test dataset: {opt["name"]}')
        for subfolder_lq, subfolder_gt in zip(subfolders_lq, subfolders_gt):
            subfolder_name = osp.basename(subfolder_lq)
            img_paths_lq = sorted(scandir(subfolder_lq, full_path=True))
            img_paths_gt = sorted(scandir(subfolder_gt, full_path=True))
            max_idx = len(img_paths_lq)
            if max_idx != len(img_paths_gt):
                raise ValueError(
                    f'Different number of images in lq ({max_idx}) and gt '
                    f'folders ({len(img_paths_gt)})')

            self.data_info['lq_path'].extend(img_paths_lq)
            self.data_info['gt_path'].extend(img_paths_gt)
            self.data_info['folder'].extend([subfolder_name] * max_idx)
            for i in range(max_idx):
                self.data_info['idx'].append(f'{i}/{max_idx}')
            border_l = [0] * max_idx
            for i in range(self.opt['num_frame'] // 2):
                border_l[i] = 1
                border_l[max_idx - i - 1] = 1
            self.data_info['border'].extend(border_l)

            if self.cache_data:
                logger.info(f'Cache {subfolder_name} for VideoTestDataset...')
                self.imgs_lq[subfolder_name] = read_img_seq(img_paths_lq)
                self.imgs_gt[subfolder_name] = read_img_seq(img_paths_gt)
            else:
                self.imgs_lq[subfolder_name] = img_paths_lq
                self.imgs_gt[subfolder_name] = img_paths_gt

    def __getitem__(self, index):
        folder = self.data_info['folder'][index]
        idx, max_idx = map(int, self.data_info['idx'][index].split('/'))
        select_idx = generate_frame_indices(idx, max_idx,
                                            self.opt['num_frame'],
                                            padding=self.opt['padding'])
        if self.cache_data:
            imgs_lq = self.imgs_lq[folder].index_select(
                0, torch.LongTensor(select_idx))
            img_gt = self.imgs_gt[folder][idx]
        else:
            imgs_lq = read_img_seq(
                [self.imgs_lq[folder][i] for i in select_idx])
            img_gt = read_img_seq([self.imgs_gt[folder][idx]])[0]
        return {'lq': imgs_lq, 'gt': img_gt, 'folder': folder,
                'idx': self.data_info['idx'][index],
                'border': self.data_info['border'][index],
                'lq_path': self.data_info['lq_path'][index]}

    def __len__(self):
        return len(self.data_info['gt_path'])


@DATASET_REGISTRY.register()
class VideoTestVimeo90KDataset(torch.utils.data.Dataset):
    """Centre-frame Vimeo90K testing (reference:
    video_test_dataset.py:150-228; ``edvr_tpu/data/video_test_dataset.py:109-155``):
    one item per septuplet of the meta-info file, its ``num_frame`` middle
    LQ frames and ``im4.png`` as GT, all in the folder ``vimeo90k`` with
    border 0."""

    def __init__(self, opt):
        self.opt = opt
        self.cache_data = opt['cache_data']
        if self.cache_data:
            raise NotImplementedError(
                'cache_data in Vimeo90K-Test dataset is not implemented.')
        self.gt_root, self.lq_root = opt['dataroot_gt'], opt['dataroot_lq']
        self.data_info = {'lq_path': [], 'gt_path': [], 'folder': [],
                          'idx': [], 'border': []}
        neighbor_list = [i + (9 - opt['num_frame']) // 2
                         for i in range(opt['num_frame'])]
        if opt['io_backend']['type'] == 'lmdb':
            raise ValueError('No need to use lmdb during validation/test.')

        get_root_logger().info(
            f'Generate data info for VideoTestDataset - {opt["name"]}')
        with open(opt['meta_info_file'], 'r') as fin:
            subfolders = [line.split(' ')[0] for line in fin]
        for idx, subfolder in enumerate(subfolders):
            self.data_info['gt_path'].append(
                osp.join(self.gt_root, subfolder, 'im4.png'))
            self.data_info['lq_path'].append([
                osp.join(self.lq_root, subfolder, f'im{i}.png')
                for i in neighbor_list])
            self.data_info['folder'].append('vimeo90k')
            self.data_info['idx'].append(f'{idx}/{len(subfolders)}')
            self.data_info['border'].append(0)

    def __getitem__(self, index):
        lq_path = self.data_info['lq_path'][index]
        return {'lq': read_img_seq(lq_path),
                'gt': read_img_seq([self.data_info['gt_path'][index]])[0],
                'folder': self.data_info['folder'][index],
                'idx': self.data_info['idx'][index],
                'border': self.data_info['border'][index],
                'lq_path': lq_path[self.opt['num_frame'] // 2]}

    def __len__(self):
        return len(self.data_info['gt_path'])


@DATASET_REGISTRY.register()
class VideoTestDUFDataset(VideoTestDataset):
    """VideoTestDataset whose LQ window, with ``use_duf_downsampling``, is
    the GT window through :func:`duf_downsample` (reference:
    video_test_dataset.py:231-290; ``edvr_tpu/data/video_test_dataset.py:158-196``).
    With ``cache_data`` the cached GT frames are downsampled as they are;
    without, each GT frame read is first cut to multiples of ``scale``
    (the GT frame returned too)."""

    def __getitem__(self, index):
        folder = self.data_info['folder'][index]
        idx, max_idx = map(int, self.data_info['idx'][index].split('/'))
        select_idx = generate_frame_indices(idx, max_idx,
                                            self.opt['num_frame'],
                                            padding=self.opt['padding'])
        scale = self.opt['scale']
        duf = self.opt['use_duf_downsampling']
        if self.cache_data:
            frames = self.imgs_gt[folder] if duf else self.imgs_lq[folder]
            imgs_lq = frames.index_select(0, torch.LongTensor(select_idx))
            img_gt = self.imgs_gt[folder][idx]
        else:
            frames = self.imgs_gt[folder] if duf else self.imgs_lq[folder]
            imgs_lq = read_img_seq([frames[i] for i in select_idx],
                                   require_mod_crop=duf, scale=scale)
            img_gt = read_img_seq([self.imgs_gt[folder][idx]],
                                  require_mod_crop=True, scale=scale)[0]
        if duf:
            imgs_lq = duf_downsample(imgs_lq, kernel_size=13, scale=scale)
        return {'lq': imgs_lq, 'gt': img_gt, 'folder': folder,
                'idx': self.data_info['idx'][index],
                'border': self.data_info['border'][index],
                'lq_path': self.data_info['lq_path'][index]}


@DATASET_REGISTRY.register()
class VideoRecurrentTestDataset(VideoTestDataset):
    """One item a folder: its whole cached LQ and GT clips (reference:
    video_test_dataset.py:293-325;
    ``edvr_tpu/data/video_test_dataset.py:199-216``)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.folders = sorted(set(self.data_info['folder']))

    def __getitem__(self, index):
        folder = self.folders[index]
        if not self.cache_data:
            raise NotImplementedError(
                'Without cache_data is not implemented.')
        return {'lq': self.imgs_lq[folder], 'gt': self.imgs_gt[folder],
                'folder': folder}

    def __len__(self):
        return len(self.folders)
