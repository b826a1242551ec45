"""Base engine (reference: basicsr/models/base_model.py), the counterpart of
``edvr_tpu/models/base_model.py``: device placement, network loading and
saving, per-iteration learning rates, training-state save and resume, and
the loss log. In a multi-process run the networks start as rank 0's, rank
0 writes the checkpoints, and the logged losses are the ranks' mean.
"""

from __future__ import annotations

import os
import os.path as osp

import torch
import torch.distributed as dist
from torch import nn

from edvr_tpu_torch.convert import load_state_dict_file
from edvr_tpu_torch.models.lr_scheduler import build_schedule
from edvr_tpu_torch.parallel import master_only, replicate_tree
from edvr_tpu_torch.parallel.dist_util import collective_device, is_dist
from edvr_tpu_torch.utils import get_root_logger


def resolve_device(name) -> torch.device:
    """``cuda`` unless the caller asks otherwise; asking for CUDA where
    there is none raises instead of running on the CPU."""
    device = torch.device(name or 'cuda')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device} was asked for but CUDA is not available; '
            'pass device cpu to run on the CPU')
    return device


class BaseModel:

    def __init__(self, opt):
        self.opt = opt
        self.is_train = opt['is_train']
        self.device = resolve_device(opt.get('device'))
        self.optimizers = {}
        self.schedulers = {}
        self.log_dict = {}

    def replicate_networks(self):
        """Give every rank rank 0's ``net_*`` networks (parameters and
        buffers), once they are built and loaded."""
        replicate_tree(*(v for k, v in vars(self).items()
                         if k.startswith('net_') and isinstance(v, nn.Module)))

    def validation(self, dataloader, current_iter, tb_logger,
                   save_img=False):
        """Dispatch to dist/nondist validation (reference:
        base_model.py:37-50; ``edvr_tpu/models/base_model.py:154-165``)."""
        if self.opt.get('dist'):
            self.dist_validation(dataloader, current_iter, tb_logger,
                                 save_img)
        else:
            self.nondist_validation(dataloader, current_iter, tb_logger,
                                    save_img)

    def load_network(self, net, path, strict=True, param_key='params'):
        """Load weights from a BasicSR ``.pth`` or an ``edvr_tpu``
        checkpoint into ``net`` (reference: base_model.py:203-262)."""
        get_root_logger().info(f'Loading {net.__class__.__name__} model '
                               f'from {path}.')
        state = load_state_dict_file(path, param_key)
        net.load_state_dict(state, strict=strict)

    # ------------------------------------------------------------------ #
    # learning rate
    # ------------------------------------------------------------------ #
    def setup_schedulers(self):
        """One step -> lr function per optimizer, from the YAML's
        ``scheduler`` block and the optimizer's base lr (reference:
        base_model.py:74-90)."""
        train_opt = self.opt['train']
        for name, optimizer in self.optimizers.items():
            self.schedulers[name] = build_schedule(train_opt,
                                                   optimizer.defaults['lr'])

    def update_learning_rate(self, current_iter):
        """Set every param group's lr to its schedule at ``current_iter``
        times the group's multiplier (``lr_mul``)."""
        for name, optimizer in self.optimizers.items():
            lr = self.schedulers[name](current_iter)
            for group in optimizer.param_groups:
                group['lr'] = lr * group['lr_mul']

    def get_current_learning_rate(self, current_iter):
        return [sched(current_iter) for sched in self.schedulers.values()]

    # ------------------------------------------------------------------ #
    # checkpoints (reference: base_model.py:170-304)
    # ------------------------------------------------------------------ #
    @master_only
    def save_network(self, net, net_label, current_iter, param_key='params'):
        """Write ``<models>/<label>_<iter>.pth`` holding the state dict
        under ``param_key``, on rank 0 (reference: base_model.py:170-201)."""
        if current_iter == -1:
            current_iter = 'latest'
        save_path = osp.join(self.opt['path']['models'],
                             f'{net_label}_{current_iter}.pth')
        os.makedirs(osp.dirname(save_path), exist_ok=True)
        state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
        torch.save({param_key: state}, save_path)

    @master_only
    def save_training_state(self, epoch, current_iter):
        """Write ``<training_states>/<iter>.state``: epoch, iteration and
        every optimizer's state, on rank 0 (reference:
        base_model.py:264-287)."""
        if current_iter == -1:
            return
        state = {'epoch': epoch, 'iter': current_iter,
                 'optimizers': {name: opt.state_dict()
                                for name, opt in self.optimizers.items()}}
        save_path = osp.join(self.opt['path']['training_states'],
                             f'{current_iter}.state')
        os.makedirs(osp.dirname(save_path), exist_ok=True)
        torch.save(state, save_path)

    def resume_training(self, resume_state):
        """Restore the optimizers' states (reference:
        base_model.py:289-304); the schedules are functions of the
        iteration and need nothing restored."""
        for name, state in resume_state['optimizers'].items():
            self.optimizers[name].load_state_dict(state)

    # ------------------------------------------------------------------ #
    # logging
    # ------------------------------------------------------------------ #
    def reduce_loss_dict(self, loss_dict):
        """Loss tensors -> floats, each the mean over the ranks in a
        multi-process run (reference: base_model.py:306-332), so that the
        log reads the global batch's loss."""
        if not is_dist():
            return {k: float(v) for k, v in loss_dict.items()}
        values = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                              for v in loss_dict.values()])
        values = values.to(collective_device())
        dist.all_reduce(values)
        values = (values / dist.get_world_size()).tolist()
        return dict(zip(loss_dict, values))

    def get_current_log(self):
        return self.reduce_loss_dict(self.log_dict)


def load_resume_state(opt):
    """The ``.state`` file named by ``path.resume_state``, or None
    (reference: train.py:130-142)."""
    path = opt['path'].get('resume_state')
    if not path:
        return None
    return torch.load(path, map_location='cpu', weights_only=True)
