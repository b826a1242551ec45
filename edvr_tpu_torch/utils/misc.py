"""Run bookkeeping helpers (reference: basicsr/utils/misc.py), copied from
``edvr_tpu/utils/misc.py`` without its process-rank machinery."""

from __future__ import annotations

import os
import os.path as osp
import time


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


def make_exp_dirs(opt) -> None:
    """Create the experiment (train) / results (test) directory tree."""
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
