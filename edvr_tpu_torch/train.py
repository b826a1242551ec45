"""Training CLI (reference: basicsr/train.py), the counterpart of
``edvr_tpu/train.py``::

    python -m edvr_tpu_torch.train -opt <yml> [--device cpu]
        [--launcher none|pytorch] [--force_yml key:sub=value ...]

One process on one device (``cuda`` unless ``--device`` says otherwise),
or with ``--launcher pytorch`` one process per rank, started with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` (as ``torchrun`` sets them): NCCL on ``cuda``, gloo on
``cpu``; each rank takes its share of the enlarged sampler and the
gradients are averaged over the ranks (``edvr_tpu_torch/parallel``). TF32
is off; the training step follows ``train.mixed_precision`` (null: fp32;
bf16: the JAX engine's policy, ``models/sr_model.py``) and validation is
fp32. The loop is the reference's: epochs over an enlarged sampler,
message logging at ``print_freq`` (and to TensorBoard with
``logger.use_tb_logger``), checkpoints at ``save_checkpoint_freq``,
validation at ``val_freq``, resume from ``path.resume_state``; batches
come through the prefetcher that ``prefetch_mode`` names
(:func:`create_prefetcher`). ``logger.profile`` (``start_iter``,
``end_iter``, ``logdir``, default ``<log>/profile``) traces the iterations
from ``start_iter`` to ``end_iter`` with ``torch.profiler`` into a Chrome
trace per rank (:class:`ProfileWindow`). ``parse_options`` is shared with
the test CLI and turns TF32 off for both. Before its first convolution the
run takes cuDNN's algorithm choice by the network it trains and its
precision (:func:`use_train_cudnn_policy`).
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import os.path as osp
import random
import time

import torch

from edvr_tpu_torch.data import (CPUPrefetcher, CUDAPrefetcher,
                                 EnlargedSampler, create_dataloader,
                                 create_dataset)
from edvr_tpu_torch.models import create_model
from edvr_tpu_torch.models.base_model import load_resume_state
from edvr_tpu_torch.parallel import get_dist_info, init_dist
from edvr_tpu_torch.utils import (MessageLogger, check_resume, init_loggers,
                                  make_exp_dirs, set_random_seed)
from edvr_tpu_torch.utils.options import parse


def parse_options(is_train=True, args=None):
    """(reference: train.py:22-55)"""
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--launcher', choices=['none', 'pytorch'],
                        default='none',
                        help="job launcher: 'pytorch' joins a process group "
                        'from RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and '
                        'MASTER_PORT (NCCL on cuda, gloo on cpu)')
    parser.add_argument('--force_yml', nargs='+', default=None,
                        help='Override yml options, e.g. '
                        'train:total_iter=100')
    parser.add_argument('--device', default='cuda',
                        help="torch device to run on (default 'cuda'; "
                        "'cpu' runs the plain PyTorch versions)")
    args = parser.parse_args(args)
    opt = parse(args.opt, is_train=is_train)
    for entry in args.force_yml or ():
        import yaml
        keys, value = entry.split('=', 1)
        node = opt
        *parents, leaf = keys.split(':')
        for k in parents:
            node = node[k]
        node[leaf] = yaml.safe_load(value)
    opt['dist'] = args.launcher != 'none'
    if opt['dist']:
        init_dist(args.launcher, args.device)
    opt['rank'], opt['world_size'] = get_dist_info()
    opt['device'] = args.device
    # fp32 on the card for both CLIs: no TF32 in cuDNN convolutions or
    # matmuls (cuDNN allows it by default), as the reference is compared
    # at full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seed = opt.get('manual_seed')
    if seed is None:
        seed = opt['manual_seed'] = random.randint(1, 10000)
    set_random_seed(seed + opt['rank'])
    return opt


def train_cudnn_env(net_opt, mixed_precision=None):
    """cuDNN's algorithm choice for training ``net_opt``'s network at the
    run's ``train.mixed_precision`` (None: fp32), as the environment to set
    before the process's first convolution.

    EDVR-L (an EDVR of 128 features or more) in fp32 takes the test CLI's
    (``test.INFERENCE_CUDNN_ENV``) for its whole run: under PyTorch's
    default (cuDNN v8 API heuristics, TF32 off) its fp32 128-channel
    convolutions take FFT algorithms with large workspaces, which make its
    fp32 step ~1.5x slower; either variable alone keeps the FFT choice.
    EDVR-L in bf16 (both shipped EDVR-L YAMLs), EDVR-M and every other
    network keep the default: since PCD's concatenated-input convolutions
    are split (``archs/edvr_arch.py::conv_cat``) the default no longer takes
    FFT for EDVR-L's validation window, and the capped choice costs a bf16
    step 1.9-3.4x. The readings are in PERF.md (``python -m
    edvr_tpu_torch.tools.train_edvr_l``)."""
    from edvr_tpu_torch.test import INFERENCE_CUDNN_ENV
    if (net_opt.get('type') == 'EDVR' and net_opt.get('num_feat', 64) >= 128
            and not mixed_precision):
        return dict(INFERENCE_CUDNN_ENV)
    return {}


def use_train_cudnn_policy(opt):
    """Apply :func:`train_cudnn_env` of ``opt['network_g']`` at
    ``opt['train']['mixed_precision']`` to this process (values already
    in the environment are kept); returns it."""
    env = train_cudnn_env(opt['network_g'],
                          opt.get('train', {}).get('mixed_precision'))
    for key, value in env.items():
        os.environ.setdefault(key, value)
    return env


# prefetch_mode values that copy batches to the card on a side stream
# ('device' is the JAX package's name for it, edvr_tpu/train.py:164-177)
PREFETCH_CUDA = ('cuda', 'device')


def create_prefetcher(opt, train_loader):
    """The training loop's prefetcher by ``prefetch_mode``: null or 'cpu'
    a :class:`CPUPrefetcher`, 'cuda' or 'device' a :class:`CUDAPrefetcher`
    onto the run's device (reference: train.py:164-177)."""
    mode = opt['datasets']['train'].get('prefetch_mode')
    if mode in (None, 'cpu'):
        return CPUPrefetcher(train_loader)
    if mode in PREFETCH_CUDA:
        return CUDAPrefetcher(train_loader, opt.get('device') or 'cuda')
    raise ValueError(f'prefetch_mode {mode!r}: expected null, cpu, cuda or '
                     'device')


def create_train_val_dataloader(opt, logger):
    """(reference: train.py:79-125)"""
    train_loader, train_sampler, val_loader = None, None, None
    total_epochs = total_iters = 0
    for phase, dataset_opt in opt['datasets'].items():
        if phase == 'train':
            ratio = dataset_opt.get('dataset_enlarge_ratio', 1)
            # each rank draws its own crops and augmentations
            seed = opt['manual_seed'] + opt['rank']
            train_set = create_dataset(dict(dataset_opt, seed=seed))
            train_sampler = EnlargedSampler(train_set, opt['world_size'],
                                            opt['rank'], ratio)
            train_loader = create_dataloader(
                train_set, dataset_opt, num_gpu=opt['num_gpu'],
                dist=opt['dist'], sampler=train_sampler, seed=seed,
                pin_memory=(dataset_opt.get('prefetch_mode') in PREFETCH_CUDA
                            and torch.device(opt.get('device') or 'cuda')
                            .type == 'cuda'))
            # one process feeds all num_gpu devices, or each rank its own
            # (edvr_tpu/train.py:104-107)
            num_iter_per_epoch = math.ceil(
                len(train_set) * ratio /
                (dataset_opt['batch_size_per_gpu'] * opt['world_size'] *
                 (1 if opt['dist'] else max(opt['num_gpu'], 1))))
            total_iters = int(opt['train']['total_iter'])
            total_epochs = math.ceil(total_iters / num_iter_per_epoch)
            logger.info(
                'Training statistics:'
                f'\n\tNumber of train images: {len(train_set)}'
                f'\n\tDataset enlarge ratio: {ratio}'
                f'\n\tRequire iter number per epoch: {num_iter_per_epoch}'
                f'\n\tTotal epochs: {total_epochs}; iters: {total_iters}.')
        elif phase == 'val':
            val_set = create_dataset(dataset_opt)
            val_loader = create_dataloader(val_set, dataset_opt)
            logger.info(f'Number of val images/folders in '
                        f'{dataset_opt["name"]}: {len(val_set)}')
        else:
            raise ValueError(f'Dataset phase {phase} is not recognized.')
    return train_loader, train_sampler, val_loader, total_epochs, total_iters


class ProfileWindow:
    """``logger.profile``'s trace: ``torch.profiler`` (CPU, and CUDA on a
    card) from the start of iteration ``start_iter`` to the end of
    ``end_iter``, after a ``torch.cuda.synchronize()``, written as
    ``<logdir>/trace_rank<rank>.json`` (Chrome's trace format); the
    counterpart of ``edvr_tpu/train.py:179-212``."""

    def __init__(self, opt):
        profile_opt = (opt.get('logger') or {}).get('profile') or {}
        self.start = profile_opt.get('start_iter')
        self.end = profile_opt.get('end_iter')
        self.logdir = profile_opt.get('logdir') or osp.join(
            opt['path']['log'], 'profile')
        self.cuda = torch.device(opt.get('device') or 'cuda').type == 'cuda'
        self.rank = opt['rank']
        self.profiler = None
        self.trace = None

    def before(self, current_iter, logger):
        if self.start is None or current_iter != self.start:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)
        self.profiler.start()
        logger.info(f'Started profiler trace -> {self.logdir}')

    def after(self, current_iter, logger, force=False):
        if self.profiler is None or not (force or current_iter == self.end):
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.profiler.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.trace = osp.join(self.logdir, f'trace_rank{self.rank}.json')
        self.profiler.export_chrome_trace(self.trace)
        self.profiler = None
        logger.info(f'Stopped profiler trace: {self.trace}')


def main(args=None):
    opt = parse_options(is_train=True, args=args)
    cudnn_env = use_train_cudnn_policy(opt)

    resume_state = load_resume_state(opt)
    if resume_state is None:
        make_exp_dirs(opt)
    else:
        check_resume(opt, resume_state['iter'])
    if opt['dist']:
        # rank 0 has made (or archived) the run's directories
        torch.distributed.barrier()
    logger, tb_logger = init_loggers(opt)
    logger.info(f'cuDNN algorithm choice: '
                f'{cudnn_env or "PyTorch default"}')

    train_loader, train_sampler, val_loader, _, total_iters = \
        create_train_val_dataloader(opt, logger)
    model = create_model(opt)

    if resume_state:
        logger.info(f"Resuming training from epoch: {resume_state['epoch']},"
                    f" iter: {resume_state['iter']}.")
        model.resume_training(resume_state)
        start_epoch = resume_state['epoch']
        current_iter = resume_state['iter']
    else:
        start_epoch = 0
        current_iter = 0

    msg_logger = MessageLogger(opt, current_iter + 1, tb_logger)
    prefetcher = create_prefetcher(opt, train_loader)
    profile = ProfileWindow(opt)
    logger.info(f'Prefetcher: {prefetcher.__class__.__name__}')
    val_opt = opt.get('val')

    logger.info(f'Start training from epoch: {start_epoch}, '
                f'iter: {current_iter}')
    data_time, iter_time = time.time(), time.time()
    start_time = time.time()
    epoch = start_epoch
    while current_iter <= total_iters:
        train_sampler.set_epoch(epoch)
        prefetcher.reset()
        train_data = prefetcher.next()
        while train_data is not None:
            data_time = time.time() - data_time
            current_iter += 1
            if current_iter > total_iters:
                break
            profile.before(current_iter, logger)
            model.feed_data(train_data)
            model.optimize_parameters(current_iter)
            profile.after(current_iter, logger)
            iter_time = time.time() - iter_time

            if current_iter % opt['logger']['print_freq'] == 0:
                log_vars = {'epoch': epoch, 'iter': current_iter,
                            'lrs': model.get_current_learning_rate(
                                current_iter),
                            'time': iter_time, 'data_time': data_time}
                log_vars.update(model.get_current_log())
                msg_logger(log_vars)
            if current_iter % opt['logger']['save_checkpoint_freq'] == 0:
                logger.info('Saving models and training states.')
                model.save(epoch, current_iter)
            if val_opt is not None and current_iter % val_opt['val_freq'] == 0:
                model.validation(val_loader, current_iter, tb_logger,
                                 val_opt.get('save_img', False))
            data_time = time.time()
            iter_time = time.time()
            train_data = prefetcher.next()
        epoch += 1

    profile.after(current_iter, logger, force=True)  # a window cut short
    consumed = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    logger.info(f'End of training. Time consumed: {consumed}')
    logger.info('Save the latest model.')
    model.save(epoch=-1, current_iter=-1)  # -1 -> 'latest'
    if val_opt is not None and val_loader is not None:
        model.validation(val_loader, current_iter, tb_logger,
                         val_opt.get('save_img', False))
    if tb_logger is not None:
        tb_logger.close()
    return model


if __name__ == '__main__':
    main()
