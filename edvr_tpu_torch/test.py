"""Testing CLI: ``python -m edvr_tpu_torch.test -opt <yml> [--device cpu]
[--launcher none|pytorch]`` (reference: basicsr/test.py), the counterpart
of ``edvr_tpu/test.py``. It shares the training CLI's ``parse_options``;
with ``--launcher pytorch`` each rank scores its share of a video test set
and rank 0 logs the tables (``models/video_base_model.py``)."""

from __future__ import annotations

import logging
import os
from os import path as osp

import torch

from edvr_tpu_torch.data import create_dataloader, create_dataset
from edvr_tpu_torch.models import create_model
from edvr_tpu_torch.train import parse_options
from edvr_tpu_torch.utils import (dict2str, get_env_info, get_root_logger,
                                  get_time_str, make_exp_dirs)

# cuDNN's convolution algorithm choice for this inference process. With TF32
# off, PyTorch's default (cuDNN v8 API) heuristics pick FFT convolutions with
# ~18 GB workspaces for some of EDVR-L's 128-channel convolutions at the
# pyramid's L2/L3 sizes (222 ms for one 256->128 3x3 convolution of 5 frames
# at 90x160, against 1.25 ms for its two 128-channel halves), which makes an
# EDVR-L window ~8x slower; the v7 API's heuristics with the workspace capped
# at 1 GiB pick implicit GEMMs (scripts/dev/time_edvr_convs.py, PERF.md).
# Both variables are read at the process's first convolution, so they are set
# before it; values already in the environment are kept. Training keeps the
# default: the same policy slows the bf16 and tap_shared steps.
INFERENCE_CUDNN_ENV = {'TORCH_CUDNN_V8_API_DISABLED': '1',
                       'CUDNN_CONV_WSCAP_DBG': '1024'}


def use_inference_cudnn_policy():
    """Apply :data:`INFERENCE_CUDNN_ENV` to this process (before its first
    convolution)."""
    for key, value in INFERENCE_CUDNN_ENV.items():
        os.environ.setdefault(key, value)


def main(args=None):
    use_inference_cudnn_policy()
    opt = parse_options(is_train=False, args=args)

    make_exp_dirs(opt)
    if opt['dist']:
        torch.distributed.barrier()  # rank 0 has made the directories
    log_file = osp.join(opt['path']['log'],
                        f"test_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    test_loaders = []
    for _, dataset_opt in sorted(opt['datasets'].items()):
        test_set = create_dataset(dataset_opt)
        test_loaders.append(create_dataloader(test_set, dataset_opt))
        logger.info(f'Number of test images in {dataset_opt["name"]}: '
                    f'{len(test_set)}')

    model = create_model(opt)
    for test_loader in test_loaders:
        logger.info(f'Testing {test_loader.dataset.opt["name"]}...')
        model.validation(test_loader, current_iter=opt['name'],
                         tb_logger=None,
                         save_img=opt['val'].get('save_img', False))
    return model


if __name__ == '__main__':
    main()
