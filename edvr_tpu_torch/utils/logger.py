"""Root logger and the training loop's message logger
(reference: basicsr/utils/logger.py), the counterparts of
``edvr_tpu/utils/logger.py`` without TensorBoard or wandb."""

from __future__ import annotations

import datetime
import logging
import os.path as osp
import time

_FORMAT = '%(asctime)s %(levelname)s: %(message)s'


def get_root_logger(logger_name: str = 'edvr_tpu_torch',
                    log_level: int = logging.INFO,
                    log_file: str | None = None) -> logging.Logger:
    """The package logger: one stream handler, plus a file handler on the
    latest ``log_file`` given. A process that runs the CLIs' ``main`` more
    than once (the tests do) logs each run to its own file: a new
    ``log_file`` closes the previous file handler."""
    logger = logging.getLogger(logger_name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(log_level)
    if log_file is not None:
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        file_handler = logging.FileHandler(log_file, 'w')
        file_handler.setFormatter(logging.Formatter(_FORMAT))
        file_handler.setLevel(log_level)
        logger.addHandler(file_handler)
    return logger


def get_env_info() -> str:
    import torch
    cuda = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else 'none')
    return (f'\nVersion Information:\n\tPyTorch: {torch.__version__}'
            f'\n\tCUDA: {torch.version.cuda}\n\tDevice 0: {cuda}')


class MessageLogger:
    """Format training-iteration messages with lr, time, ETA and losses
    (reference: basicsr/utils/logger.py:8-76)."""

    def __init__(self, opt, start_iter: int = 1):
        self.exp_name = opt['name']
        self.interval = opt['logger']['print_freq']
        self.start_iter = start_iter
        self.max_iters = opt['train']['total_iter']
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars: dict):
        log_vars = dict(log_vars)
        epoch = log_vars.pop('epoch')
        current_iter = log_vars.pop('iter')
        lrs = log_vars.pop('lrs')
        message = (f'[{self.exp_name[:5]}..][epoch:{epoch:3d}, '
                   f'iter:{current_iter:8,d}, lr:(')
        message += ''.join(f'{v:.3e},' for v in lrs) + ')] '
        if 'time' in log_vars:
            iter_time = log_vars.pop('time')
            data_time = log_vars.pop('data_time')
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / (current_iter - self.start_iter + 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += (f'[eta: {eta_str}, '
                        f'time (data): {iter_time:.3f} ({data_time:.3f})] ')
        message += ''.join(f'{k}: {v:.4e} ' for k, v in log_vars.items())
        self.logger.info(message)


def init_loggers(opt):
    """The root logger with a file under the run's log directory; the
    environment and the options are logged first. TensorBoard and wandb
    are not ported."""
    from edvr_tpu_torch.utils.misc import get_time_str
    from edvr_tpu_torch.utils.options import dict2str
    log_file = osp.join(opt['path']['log'],
                        f"train_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    if (opt.get('logger') or {}).get('use_tb_logger'):
        logger.warning('use_tb_logger is set; TensorBoard logging is not '
                       'ported, the losses go to the log file only')
    return logger
