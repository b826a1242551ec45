"""Training CLI (reference: basicsr/train.py), the counterpart of
``edvr_tpu/train.py``::

    python -m edvr_tpu_torch.train -opt <yml> [--device cpu]
        [--force_yml key:sub=value ...]

One process on one device (``cuda`` unless ``--device`` says otherwise),
TF32 off; the training step follows ``train.mixed_precision`` (null:
fp32; bf16: the JAX engine's policy, ``models/sr_model.py``) and
validation is fp32. The loop is the reference's: epochs over an enlarged
sampler, message logging at ``print_freq``, checkpoints at
``save_checkpoint_freq``, validation at ``val_freq``, resume from
``path.resume_state``. ``parse_options`` is shared with the test CLI and
turns TF32 off for both.
"""

from __future__ import annotations

import argparse
import datetime
import math
import random
import time

import torch

from edvr_tpu_torch.data import (CPUPrefetcher, EnlargedSampler,
                                 create_dataloader, create_dataset)
from edvr_tpu_torch.models import create_model
from edvr_tpu_torch.models.base_model import load_resume_state
from edvr_tpu_torch.utils import (MessageLogger, check_resume, init_loggers,
                                  make_exp_dirs, set_random_seed)
from edvr_tpu_torch.utils.options import parse


def parse_options(is_train=True, args=None):
    """(reference: train.py:22-55)"""
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--launcher', choices=['none'], default='none',
                        help='job launcher (distributed training is not '
                        'ported)')
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
    opt['dist'] = False
    opt['rank'], opt['world_size'] = 0, 1
    opt['device'] = args.device
    # fp32 on the card for both CLIs: no TF32 in cuDNN convolutions or
    # matmuls (cuDNN allows it by default), as the reference is compared
    # at full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seed = opt.get('manual_seed')
    if seed is None:
        seed = opt['manual_seed'] = random.randint(1, 10000)
    set_random_seed(seed)
    return opt


def create_train_val_dataloader(opt, logger):
    """(reference: train.py:79-125)"""
    train_loader, train_sampler, val_loader = None, None, None
    total_epochs = total_iters = 0
    for phase, dataset_opt in opt['datasets'].items():
        if phase == 'train':
            ratio = dataset_opt.get('dataset_enlarge_ratio', 1)
            train_set = create_dataset(dict(dataset_opt,
                                            seed=opt['manual_seed']))
            train_sampler = EnlargedSampler(train_set, 1, 0, ratio)
            train_loader = create_dataloader(
                train_set, dataset_opt, num_gpu=opt['num_gpu'],
                dist=opt['dist'], sampler=train_sampler,
                seed=opt['manual_seed'])
            # one process feeds all num_gpu devices
            # (edvr_tpu/train.py:107-110)
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


def main(args=None):
    opt = parse_options(is_train=True, args=args)

    resume_state = load_resume_state(opt)
    if resume_state is None:
        make_exp_dirs(opt)
    else:
        check_resume(opt, resume_state['iter'])
    logger = init_loggers(opt)

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

    msg_logger = MessageLogger(opt, current_iter + 1)
    prefetch_mode = opt['datasets']['train'].get('prefetch_mode')
    if prefetch_mode not in (None, 'cpu'):
        raise NotImplementedError(f'prefetch_mode {prefetch_mode!r} is not '
                                  'ported yet (ROADMAP A.9)')
    prefetcher = CPUPrefetcher(train_loader)
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
            model.feed_data(train_data)
            model.optimize_parameters(current_iter)
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
                model.validation(val_loader, current_iter, None,
                                 val_opt.get('save_img', False))
            data_time = time.time()
            iter_time = time.time()
            train_data = prefetcher.next()
        epoch += 1

    consumed = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    logger.info(f'End of training. Time consumed: {consumed}')
    logger.info('Save the latest model.')
    model.save(epoch=-1, current_iter=-1)  # -1 -> 'latest'
    if val_opt is not None and val_loader is not None:
        model.validation(val_loader, current_iter, None,
                         val_opt.get('save_img', False))
    return model


if __name__ == '__main__':
    main()
