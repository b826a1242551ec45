"""Video SR engine (reference: basicsr/models/video_base_model.py), the
counterpart of ``edvr_tpu/models/video_base_model.py``: per-folder x
per-frame metric tables filled by whole-clip EDVR evaluation, from the
test CLI (``val.clip_mode``) or from the training loop at ``val_freq``.
Training itself is the SR engine's."""

from __future__ import annotations

from collections import Counter
from copy import deepcopy
from os import path as osp

import numpy as np
import torch

from edvr_tpu_torch.archs.edvr_arch import (EDVR, clip_window_indices,
                                            make_clip_restore_fn)
from edvr_tpu_torch.data.data_util import read_img_seq
from edvr_tpu_torch.data.video_test_dataset import VideoTestDataset
from edvr_tpu_torch.metrics import calculate_metric
from edvr_tpu_torch.models.sr_model import SRModel
from edvr_tpu_torch.utils import get_root_logger, imwrite, tensor2img
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class VideoBaseModel(SRModel):

    def _init_metric_tables(self, dataset):
        """(Re)zero the per-folder x per-frame metric tables."""
        with_metrics = self.opt['val'].get('metrics') is not None
        if with_metrics:
            frames = Counter(dataset.data_info['folder'])
            self.metric_results = {
                folder: np.zeros((num, len(self.opt['val']['metrics'])),
                                 dtype=np.float32)
                for folder, num in frames.items()}
        return with_metrics

    def _save_result_img(self, result_img, dataset_name, folder, lq_path):
        """Write one restored frame under the reference's visualization
        layout and naming (reference: video_base_model.py:77-94)."""
        img_name = osp.splitext(osp.basename(lq_path))[0]
        suffix = self.opt['val'].get('suffix') or self.opt['name']
        imwrite(result_img, osp.join(self.opt['path']['visualization'],
                                     dataset_name, folder,
                                     f'{img_name}_{suffix}.png'))

    def _score_frame(self, result_img, gt_img, folder, frame_idx):
        for metric_idx, opt_ in enumerate(
                deepcopy(self.opt['val']['metrics']).values()):
            self.metric_results[folder][frame_idx, metric_idx] += (
                calculate_metric(dict(img1=result_img, img2=gt_img), opt_))

    def validation(self, dataloader, current_iter, tb_logger,
                   save_img=False):
        """Score every frame of the dataset's clips. Whole-clip evaluation
        is the only protocol ported: under the test CLI it needs
        ``val.clip_mode``; during training (``val_freq``) it is taken for
        the per-window protocol, whose window outputs it reproduces
        (``edvr_tpu/models/video_base_model.py::_clip_validation``)."""
        dataset = dataloader.dataset
        clip_mode = (self.opt.get('val') or {}).get('clip_mode')
        if not ((clip_mode or self.is_train)
                and isinstance(dataset, VideoTestDataset)
                and isinstance(self.net_g, EDVR)):
            raise NotImplementedError(
                'only whole-clip validation (val.clip_mode with a '
                'VideoTestDataset and an EDVR network) is ported yet')
        if save_img and self.is_train:
            raise NotImplementedError(
                'saving image is not supported during training.')
        self._clip_validation(dataset, current_iter, tb_logger, save_img)

    def _clip_validation(self, dataset, current_iter, tb_logger, save_img):
        """Whole-clip EDVR evaluation in window mode (``val.clip_mode``),
        the counterpart of
        ``edvr_tpu/models/video_base_model.py::_clip_validation``. The
        output protocol (window index table, uint8 metric domain, save
        paths) is the reference's per-window one."""
        dataset_name = dataset.opt['name']
        with_metrics = self._init_metric_tables(dataset)
        win_batch = int(self.opt['val'].get('clip_win_batch', 1))
        fn = make_clip_restore_fn(self.net_g, win_batch=win_batch)
        num_frame = dataset.opt['num_frame']
        padding = dataset.opt['padding']

        lq_paths = {f: [] for f in dataset.imgs_lq}
        for path, folder in zip(dataset.data_info['lq_path'],
                                dataset.data_info['folder']):
            lq_paths[folder].append(path)

        for folder in dataset.imgs_lq:
            if dataset.cache_data:
                clip = dataset.imgs_lq[folder]
                gts = dataset.imgs_gt[folder]
            else:
                clip = read_img_seq(dataset.imgs_lq[folder])
                gts = read_img_seq(dataset.imgs_gt[folder])
            T = clip.shape[0]
            idx = clip_window_indices(T, num_frame, padding)
            out = fn(clip.to(self.device, torch.float32), idx).cpu()

            for i in range(T):
                result_img = tensor2img(out[i])
                if save_img:
                    self._save_result_img(result_img, dataset_name, folder,
                                          lq_paths[folder][i])
                if with_metrics:
                    self._score_frame(result_img, tensor2img(gts[i]),
                                      folder, i)

        if with_metrics:
            self._log_validation_metric_values(current_iter, dataset_name)

    def _log_validation_metric_values(self, current_iter, dataset_name):
        """Per-folder averaging and logging
        (reference: video_base_model.py:128-172)."""
        folder_avg = {folder: arr.mean(axis=0)
                      for folder, arr in self.metric_results.items()}
        log_str = f'Validation {dataset_name} (iter {current_iter})\n'
        for metric_idx, metric in enumerate(self.opt['val']['metrics']):
            total = float(np.mean([avg[metric_idx]
                                   for avg in folder_avg.values()]))
            log_str += f'\t # {metric}: {total:.4f}'
            for folder, avg in folder_avg.items():
                log_str += f'\t # {folder}: {float(avg[metric_idx]):.4f}'
            log_str += '\n'
        get_root_logger().info(log_str)
