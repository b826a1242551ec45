"""Pixel losses with the reference's class API (reference:
basicsr/models/losses/losses.py:28-122 and loss_util.py), the counterparts
of ``edvr_tpu/models/losses.py``: an elementwise core, an optional
elementwise weight, then a 'none' / 'mean' / 'sum' reduction."""

from __future__ import annotations

import torch

from edvr_tpu_torch.utils.registry import LOSS_REGISTRY

_reduction_modes = ['none', 'mean', 'sum']


def _reduce(loss, weight, reduction):
    """Apply the elementwise weight, then reduce
    (reference: losses/loss_util.py:5-100)."""
    if weight is not None:
        loss = loss * weight
    if reduction == 'none':
        return loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(f'Unsupported reduction mode: {reduction}. '
                     f'Supported ones are: {_reduction_modes}')


class _PixelLoss:

    def __init__(self, loss_weight=1.0, reduction='mean'):
        if reduction not in _reduction_modes:
            raise ValueError(f'Unsupported reduction mode: {reduction}.')
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None, **kwargs):
        return self.loss_weight * _reduce(self.core(pred - target), weight,
                                          self.reduction)


@LOSS_REGISTRY.register()
class L1Loss(_PixelLoss):
    """(reference: losses.py:28-55)"""

    def core(self, diff):
        return diff.abs()


@LOSS_REGISTRY.register()
class MSELoss(_PixelLoss):
    """(reference: losses.py:58-85)"""

    def core(self, diff):
        return diff ** 2


@LOSS_REGISTRY.register()
class CharbonnierLoss(_PixelLoss):
    """sqrt(diff^2 + eps), eps controls the curvature near zero
    (reference: losses.py:88-122; eps defaults to 1e-12)."""

    def __init__(self, loss_weight=1.0, reduction='mean', eps=1e-12):
        super().__init__(loss_weight, reduction)
        self.eps = eps

    def core(self, diff):
        return torch.sqrt(diff ** 2 + self.eps)


def build_loss(opt: dict):
    """Instantiate a loss from its YAML option dict."""
    opt = dict(opt)
    loss_type = opt.pop('type')
    return LOSS_REGISTRY.get(loss_type)(**opt)
