"""Video SR engine (reference: basicsr/models/video_base_model.py), the
counterpart of ``edvr_tpu/models/video_base_model.py``: per-folder x
per-frame metric tables, from the test CLI or from the training loop at
``val_freq``, filled by the reference's per-window protocol (one dataset
item, one forward) or, with ``val.clip_mode``, by whole-clip EDVR
evaluation. In a multi-process run each rank scores its share (windows by
index, or folders in clip mode) and the tables are summed over the ranks
(``parallel.process_allreduce_sum``), as the JAX package does; rank 0 logs
them. Training itself is the SR engine's."""

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
from edvr_tpu_torch.parallel import get_dist_info, process_allreduce_sum
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
        layout and naming (reference: video_base_model.py:77-94;
        ``edvr_tpu/models/video_base_model.py:50-70``): Vimeo90K frames
        are named ``<sequence>_<clip>_<frame>`` after their LQ path."""
        if 'vimeo' in dataset_name.lower():
            split_result = lq_path.split('/')
            img_name = (f'{split_result[-3]}_{split_result[-2]}_'
                        f'{split_result[-1].split(".")[0]}')
        else:
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

    def _finalize_validation(self, current_iter, dataset_name, tb_logger):
        """Sum the tables over the ranks (each frame was scored by one) and
        log them on rank 0 (reference: video_base_model.py:109-113;
        ``edvr_tpu/models/video_base_model.py:80-87``)."""
        for folder in self.metric_results:
            self.metric_results[folder] = process_allreduce_sum(
                self.metric_results[folder])
        if get_dist_info()[0] == 0:
            self._log_validation_metric_values(current_iter, dataset_name,
                                               tb_logger)

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """It delegates to ``dist_validation`` (rank 0 of 1 outside a
        process group), as the JAX package's does
        (``edvr_tpu/models/video_base_model.py:216-220``)."""
        self.dist_validation(dataloader, current_iter, tb_logger, save_img)

    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img):
        """The reference's per-window protocol
        (``edvr_tpu/models/video_base_model.py:90-136``): each dataset item
        is one window through :meth:`test`, its output scored against its
        GT frame; rank r of w takes items r, r + w, ... ``val.clip_mode``
        with a VideoTestDataset and an EDVR network takes whole-clip
        evaluation instead, with the same outputs; with any other dataset or
        network it warns and falls back to the per-window protocol, as the
        JAX package does."""
        if save_img and self.is_train:
            raise NotImplementedError(
                'saving image is not supported during training.')
        dataset = dataloader.dataset
        if (self.opt.get('val') or {}).get('clip_mode'):
            if isinstance(dataset, VideoTestDataset) and \
                    isinstance(self.net_g, EDVR):
                return self._clip_validation(dataset, current_iter,
                                             tb_logger, save_img)
            get_root_logger().warning(
                'val.clip_mode needs a VideoTestDataset (whole folders) '
                'and an EDVR network; falling back to the per-window '
                'protocol.')
        dataset_name = dataset.opt['name']
        with_metrics = self._init_metric_tables(dataset)
        rank, world_size = get_dist_info()

        for idx in range(rank, len(dataset), world_size):
            val_data = dataset[idx]
            folder = val_data['folder']
            frame_idx = int(val_data['idx'].split('/')[0])
            self.feed_data({k: val_data[k][None] for k in ('lq', 'gt')
                            if k in val_data})
            self.test()
            visuals = self.get_current_visuals()
            result_img = tensor2img(visuals['result'])
            if 'gt' in visuals:
                gt_img = tensor2img(visuals['gt'])
                del self.gt
            del self.lq, self.output

            if save_img:
                self._save_result_img(result_img, dataset_name, folder,
                                      val_data['lq_path'])
            if with_metrics:
                self._score_frame(result_img, gt_img, folder, frame_idx)

        if with_metrics:
            self._finalize_validation(current_iter, dataset_name, tb_logger)

    def _clip_validation(self, dataset, current_iter, tb_logger, save_img):
        """Whole-clip EDVR evaluation in window mode (``val.clip_mode``),
        the counterpart of
        ``edvr_tpu/models/video_base_model.py::_clip_validation``. The
        output protocol (window index table, uint8 metric domain, save
        paths) is the reference's per-window one. Rank r of w takes
        folders r, r + w, ..."""
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

        rank, world_size = get_dist_info()
        for folder in list(dataset.imgs_lq)[rank::world_size]:
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
            self._finalize_validation(current_iter, dataset_name, tb_logger)

    def _log_validation_metric_values(self, current_iter, dataset_name,
                                      tb_logger=None):
        """Per-folder averaging and logging, to TensorBoard as
        ``metrics/<metric>`` and ``metrics/<metric>/<folder>`` too
        (reference: video_base_model.py:128-172;
        ``edvr_tpu/models/video_base_model.py:253-257``)."""
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
            if tb_logger is not None:
                tb_logger.add_scalar(f'metrics/{metric}', total,
                                     current_iter)
                for folder, avg in folder_avg.items():
                    tb_logger.add_scalar(f'metrics/{metric}/{folder}',
                                         float(avg[metric_idx]), current_iter)
        get_root_logger().info(log_str)
