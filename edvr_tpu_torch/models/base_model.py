"""Base engine, eval path (reference: basicsr/models/base_model.py),
the counterpart of ``edvr_tpu/models/base_model.py``: device placement
and network loading. Training is not ported yet.
"""

from __future__ import annotations

import torch

from edvr_tpu_torch.convert import load_state_dict_file
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
        if self.is_train:
            raise NotImplementedError('training is not ported yet')
        self.device = resolve_device(opt.get('device'))

    def load_network(self, net, path, strict=True, param_key='params'):
        """Load weights from a BasicSR ``.pth`` or an ``edvr_tpu``
        checkpoint into ``net`` (reference: base_model.py:203-262)."""
        get_root_logger().info(f'Loading {net.__class__.__name__} model '
                               f'from {path}.')
        state = load_state_dict_file(path, param_key)
        net.load_state_dict(state, strict=strict)
