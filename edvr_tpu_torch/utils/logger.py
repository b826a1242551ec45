"""Root logger, the training loop's message logger, TensorBoard and wandb
(reference: basicsr/utils/logger.py), the counterparts of
``edvr_tpu/utils/logger.py``: ranks other than 0 log errors only, and the
messages, scalars and events are rank 0's."""

from __future__ import annotations

import datetime
import logging
import os.path as osp
import sys
import time
import types

from edvr_tpu_torch.parallel.dist_util import get_dist_info, master_only

_FORMAT = '%(asctime)s %(levelname)s: %(message)s'


def get_root_logger(logger_name: str = 'edvr_tpu_torch',
                    log_level: int = logging.INFO,
                    log_file: str | None = None) -> logging.Logger:
    """The package logger: one stream handler, plus a file handler on the
    latest ``log_file`` given. A process that runs the CLIs' ``main`` more
    than once (the tests do) logs each run to its own file: a new
    ``log_file`` closes the previous file handler. On a rank other than 0
    it logs errors only and writes no file (reference: logger.py:113-149;
    ``edvr_tpu/utils/logger.py:41-44``)."""
    logger = logging.getLogger(logger_name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(log_level)
    if get_dist_info()[0] != 0:
        logger.setLevel(logging.ERROR)
        return logger
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
    """Format training-iteration messages with lr, time, ETA and losses,
    and mirror the scalars to TensorBoard: a loss ``l_*`` as
    ``losses/<k>``, any other as ``<k>`` (reference:
    basicsr/utils/logger.py:8-76; ``edvr_tpu/utils/logger.py:59-101``).
    Rank 0 only."""

    def __init__(self, opt, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt['name']
        self.interval = opt['logger']['print_freq']
        self.start_iter = start_iter
        self.max_iters = opt['train']['total_iter']
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    @master_only
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
        if self.tb_logger is not None:
            for k, v in log_vars.items():
                self.tb_logger.add_scalar(
                    f'losses/{k}' if k.startswith('l_') else k, v,
                    current_iter)
        self.logger.info(message)


@master_only
def init_tb_logger(log_dir: str):
    """A TensorBoard ``SummaryWriter`` on ``log_dir`` (rank 0), or None with
    a warning where the ``tensorboard`` package is missing: the run goes on
    without it, as the JAX package goes on without wandb."""
    # TensorBoard writes its event files through its own file layer; its
    # "notf" module is its switch that keeps it from importing TensorFlow
    # where that is installed (~15 s, and nothing of it is used here)
    sys.modules.setdefault('tensorboard.compat.notf',
                           types.ModuleType('tensorboard.compat.notf'))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        get_root_logger().warning(
            f'use_tb_logger is set but TensorBoard cannot be imported '
            f'({e}); the run goes on without its events')
        return None
    return SummaryWriter(log_dir=log_dir)


@master_only
def init_wandb_logger(opt):
    """The reference's wandb logger over TensorBoard's events (reference:
    logger.py:87-110; ``edvr_tpu/utils/logger.py:114-138``), skipped with
    a warning where ``wandb`` is not installed."""
    try:
        import wandb
    except ImportError:
        get_root_logger().warning('wandb is not installed; skipping.')
        return
    logger = get_root_logger()
    wandb_opt = opt['logger']['wandb']
    project, resume_id = wandb_opt['project'], wandb_opt.get('resume_id')
    if resume_id:
        wandb_id, resume = resume_id, 'allow'
        logger.warning(f'Resume wandb logger with id={wandb_id}.')
    else:
        wandb_id, resume = wandb.util.generate_id(), 'never'
    wandb.init(id=wandb_id, resume=resume, name=opt['name'], config=opt,
               project=project, sync_tensorboard=True)
    logger.info(f'Use wandb logger with id={wandb_id}; project={project}.')


def init_loggers(opt):
    """The root logger with a file under the run's log directory (the
    environment and the options logged first), wandb where
    ``logger.wandb.project`` is set (it needs ``use_tb_logger``) and
    TensorBoard's writer under ``<root>/tb_logger/<name>`` where
    ``use_tb_logger`` is set (reference: train.py:58-76). Returns (logger,
    the writer or None)."""
    from edvr_tpu_torch.utils.misc import get_time_str
    from edvr_tpu_torch.utils.options import dict2str
    log_file = osp.join(opt['path']['log'],
                        f"train_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    logger_opt = opt.get('logger') or {}
    if (logger_opt.get('wandb') or {}).get('project') is not None:
        if logger_opt.get('use_tb_logger') is not True:
            raise ValueError('should turn on tensorboard when using wandb')
        init_wandb_logger(opt)
    tb_logger = None
    if logger_opt.get('use_tb_logger'):
        tb_logger = init_tb_logger(osp.join(opt['path']['root'],
                                            'tb_logger', opt['name']))
    return logger, tb_logger
