"""SR engine, eval path (reference: basicsr/models/sr_model.py): builds
the network from ``network_g`` on the engine's device and loads its
pretrained weights."""

from __future__ import annotations

from copy import deepcopy

import torch

from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.models.base_model import BaseModel
from edvr_tpu_torch.utils import get_root_logger
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class SRModel(BaseModel):

    def __init__(self, opt):
        super().__init__(opt)
        # parameters are drawn from the option file's seed, on the CPU,
        # without touching the caller's global generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(opt.get('manual_seed') or 0)
            net = define_network(deepcopy(opt['network_g']))
        n = sum(p.numel() for p in net.parameters())
        get_root_logger().info(
            f'Network: {net.__class__.__name__}, with parameters: {n:,d}')
        load_path = opt['path'].get('pretrain_network_g')
        if load_path is not None:
            self.load_network(net, load_path,
                              opt['path'].get('strict_load_g', True),
                              opt['path'].get('param_key_g', 'params'))
        self.net_g = net.to(self.device).eval()
