"""Testing CLI: ``python -m edvr_tpu_torch.test -opt <yml> [--device cpu]``
(reference: basicsr/test.py), the counterpart of ``edvr_tpu/test.py``."""

from __future__ import annotations

import logging
from os import path as osp

from edvr_tpu_torch.data import create_dataloader, create_dataset
from edvr_tpu_torch.models import create_model
from edvr_tpu_torch.train import parse_options
from edvr_tpu_torch.utils import (dict2str, get_env_info, get_root_logger,
                                  get_time_str, make_exp_dirs)


def main(args=None):
    opt = parse_options(is_train=False, args=args)

    make_exp_dirs(opt)
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
