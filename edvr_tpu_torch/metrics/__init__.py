"""Quality metrics, resolved by YAML ``type`` names
(reference: basicsr/metrics/__init__.py)."""

from copy import deepcopy

from edvr_tpu_torch.metrics.niqe import calculate_niqe
from edvr_tpu_torch.metrics.psnr_ssim import calculate_psnr, calculate_ssim
from edvr_tpu_torch.utils.registry import METRIC_REGISTRY

__all__ = ['calculate_psnr', 'calculate_ssim', 'calculate_niqe',
           'calculate_metric']


def calculate_metric(data: dict, opt: dict):
    """Dispatch a metric by its YAML option dict (``type`` key)."""
    opt = deepcopy(opt)
    metric_type = opt.pop('type')
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
