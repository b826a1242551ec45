"""Run bookkeeping helpers (reference: basicsr/utils/misc.py), copied from
``edvr_tpu/utils/misc.py``; the experiment directories are rank 0's."""

from __future__ import annotations

import os
import os.path as osp
import random
import time

import numpy as np
import torch

from edvr_tpu_torch.parallel.dist_util import master_only


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators
    (reference: misc.py:13-19)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_time_str() -> str:
    return time.strftime('%Y%m%d_%H%M%S', time.localtime())


def mkdir_and_rename(path: str) -> None:
    """Create ``path``, archiving any existing directory of that name to
    ``<path>_archived_<timestamp>`` so reruns never overwrite results."""
    if osp.exists(path):
        archived = f'{path}_archived_{get_time_str()}'
        print(f'{path} exists — archiving the old run to {archived}',
              flush=True)
        os.rename(path, archived)
    os.makedirs(path, exist_ok=True)


# opt['path'] keys that are settings rather than directories
_NON_DIR_PATH_KEYS = ('strict_load', 'pretrain_network', 'resume',
                      'param_key')


@master_only
def make_exp_dirs(opt) -> None:
    """Create the experiment (train) / results (test) directory tree (rank
    0 only)."""
    paths = dict(opt['path'])
    root_key = 'experiments_root' if opt['is_train'] else 'results_root'
    mkdir_and_rename(paths.pop(root_key))
    for key, path in paths.items():
        if path is None or any(tag in key for tag in _NON_DIR_PATH_KEYS):
            continue
        os.makedirs(path, exist_ok=True)


def scandir(dir_path, suffix=None, full_path=False):
    """Yield the files directly under ``dir_path``, skipping dot-files.

    Args:
        dir_path: Directory to scan.
        suffix: Only yield files whose name ends with this str or tuple.
        full_path: Yield joined paths instead of bare file names.
    """
    for entry in os.scandir(dir_path):
        if entry.name.startswith('.') or not entry.is_file():
            continue
        if suffix is None or entry.name.endswith(suffix):
            yield entry.path if full_path else entry.name


def check_resume(opt, resume_iter: int) -> None:
    """Point every ``pretrain_network_*`` option at the run's own
    checkpoint of the resumed iteration (``<models>/net_<suffix>_<iter>.pth``),
    superseding whatever the YAML named (reference: misc.py:97-117)."""
    from edvr_tpu_torch.utils.logger import get_root_logger
    if not opt['path'].get('resume_state'):
        return
    logger = get_root_logger()
    networks = [k for k in opt if k.startswith('network_')]
    if any(opt['path'].get(f'pretrain_{n}') is not None for n in networks):
        logger.warning('resume overrides the configured pretrain_network '
                       'paths')
    skip = opt['path'].get('ignore_resume_networks') or ()
    for net in networks:
        if net in skip:
            continue
        suffix = net[len('network_'):]
        ckpt = osp.join(opt['path']['models'],
                        f'net_{suffix}_{resume_iter}.pth')
        opt['path'][f'pretrain_{net}'] = ckpt
        logger.info(f'resume: pretrain_{net} <- {ckpt}')
