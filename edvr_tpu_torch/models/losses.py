"""Losses with the reference's class API (reference:
basicsr/models/losses/losses.py and loss_util.py), the counterparts of
``edvr_tpu/models/losses.py``: pixel losses (an elementwise core, an
optional elementwise weight, then a 'none' / 'mean' / 'sum' reduction), the
weighted TV loss, the GAN losses, the VGG perceptual and style loss, and the
gradient penalties (R1, path length, WGAN-GP), which differentiate through
a gradient (``torch.autograd.grad(..., create_graph=True)``)."""

from __future__ import annotations

import os

import torch
from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.parallel.data_parallel import global_mean
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


@LOSS_REGISTRY.register()
class WeightedTVLoss(L1Loss):
    """Weighted total variation: the mean |difference| of vertical and of
    horizontal neighbours, each under the weight's matching slice
    (reference: losses.py:125-143; ``edvr_tpu/models/losses.py:87-103``,
    NCHW here)."""

    def __init__(self, loss_weight=1.0):
        super().__init__(loss_weight=loss_weight)

    def __call__(self, pred, weight=None):
        wy = weight[:, :, :-1, :] if weight is not None else None
        wx = weight[:, :, :, :-1] if weight is not None else None
        y_diff = super().__call__(pred[:, :, :-1, :], pred[:, :, 1:, :],
                                  weight=wy)
        x_diff = super().__call__(pred[:, :, :, :-1], pred[:, :, :, 1:],
                                  weight=wx)
        return x_diff + y_diff


@LOSS_REGISTRY.register()
class GANLoss:
    """vanilla (BCE with logits), lsgan, wgan, wgan_softplus and hinge
    (reference: losses.py:262-370; ``edvr_tpu/models/losses.py:105-149``).
    ``loss_weight`` applies on the generator side only."""

    def __init__(self, gan_type, real_label_val=1.0, fake_label_val=0.0,
                 loss_weight=1.0):
        if gan_type not in ('vanilla', 'lsgan', 'wgan', 'wgan_softplus',
                            'hinge'):
            raise NotImplementedError(
                f'GAN type {gan_type} is not implemented.')
        self.gan_type = gan_type
        self.loss_weight = loss_weight
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val

    def _core(self, x, target_is_real, is_disc):
        label = self.real_label_val if target_is_real else \
            self.fake_label_val
        if self.gan_type == 'vanilla':
            return F.binary_cross_entropy_with_logits(
                x, torch.full_like(x, label))
        if self.gan_type == 'lsgan':
            return ((x - label) ** 2).mean()
        if self.gan_type == 'wgan':
            return -x.mean() if target_is_real else x.mean()
        if self.gan_type == 'wgan_softplus':
            return F.softplus(-x if target_is_real else x).mean()
        if is_disc:  # hinge
            return F.relu(1 + (-x if target_is_real else x)).mean()
        return -x.mean()

    def __call__(self, x, target_is_real, is_disc=False):
        loss = self._core(x, target_is_real, is_disc)
        return loss if is_disc else loss * self.loss_weight


@LOSS_REGISTRY.register()
class PerceptualLoss(nn.Module):
    """Perceptual and style (Gram) loss on VGG features
    (reference: losses.py:146-259; ``edvr_tpu/models/losses.py:206-294``).

    The VGG is frozen (no gradients to its parameters; its batch-norm
    layers, in the ``_bn`` variants, on their running statistics); gt's
    features are taken without autograd. Its weights are
    torchvision's ``vgg*.pth`` at ``vgg_pretrain_path`` (default
    ``archs/vgg_arch.py::VGG_PRETRAIN_PATH``); without that file it warns
    and uses a VGG drawn from seed 0, as the JAX loss does.
    Returns ``(perceptual, style)``, each None when its weight is 0.
    """

    def __init__(self, layer_weights, vgg_type='vgg19', use_input_norm=True,
                 range_norm=False, perceptual_weight=1.0, style_weight=0.,
                 criterion='l1', vgg_pretrain_path=None):
        from edvr_tpu_torch.archs.vgg_arch import (VGG_PRETRAIN_PATH,
                                                   VGGFeatureExtractor,
                                                   load_torchvision_vgg)
        from edvr_tpu_torch.utils import get_root_logger
        super().__init__()
        if criterion not in ('l1', 'l2', 'fro'):
            raise NotImplementedError(
                f'{criterion} criterion has not been supported.')
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.layer_weights = layer_weights
        self.criterion_type = criterion
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.vgg = VGGFeatureExtractor(
                list(layer_weights), vgg_type=vgg_type,
                use_input_norm=use_input_norm, range_norm=range_norm)
        path = vgg_pretrain_path or VGG_PRETRAIN_PATH
        if os.path.exists(path):
            load_torchvision_vgg(self.vgg, path)
        else:
            get_root_logger().warning(
                f'VGG pretrain weights not found at {path}; PerceptualLoss '
                'uses a randomly initialized VGG (tests only).')
        self.vgg.requires_grad_(False).eval()

    def _crit(self, a, b):
        if self.criterion_type == 'l1':
            return (a - b).abs().mean()
        if self.criterion_type == 'l2':
            return ((a - b) ** 2).mean()
        return torch.linalg.vector_norm(a - b)  # Frobenius

    @staticmethod
    def _gram_mat(x):
        """(n, c, h, w) -> (n, c, c) Gram matrices / (c h w)
        (reference: losses.py:249-259)."""
        n, c, h, w = x.shape
        feats = x.reshape(n, c, h * w)
        return feats @ feats.transpose(1, 2) / (c * h * w)

    def forward(self, x, gt):
        x_features = self.vgg(x)
        with torch.no_grad():
            gt_features = self.vgg(gt.detach())

        percep_loss = None
        if self.perceptual_weight > 0:
            percep_loss = sum(
                self._crit(x_features[k], gt_features[k]) *
                self.layer_weights[k] for k in x_features)
            percep_loss = percep_loss * self.perceptual_weight

        style_loss = None
        if self.style_weight > 0:
            style_loss = sum(
                self._crit(self._gram_mat(x_features[k]),
                           self._gram_mat(gt_features[k])) *
                self.layer_weights[k] for k in x_features)
            style_loss = style_loss * self.style_weight
        return percep_loss, style_loss


def r1_penalty(real_pred, real_img):
    """R1 gradient penalty on real data (reference: losses.py:373-388;
    ``edvr_tpu/models/losses.py:152-161``): the mean over the batch of the
    squared norm of d sum(real_pred) / d real_img, differentiable again."""
    grad_real, = torch.autograd.grad(outputs=real_pred.sum(),
                                     inputs=real_img, create_graph=True)
    return grad_real.pow(2).reshape(grad_real.shape[0], -1).sum(1).mean()


def g_path_regularize(fake_img, latents, noise, mean_path_length,
                      decay=0.01):
    """Path-length regularisation (reference: losses.py:391-403;
    ``edvr_tpu/models/losses.py:164-180``).

    Args:
        fake_img: (n, c, h, w), a function of ``latents``.
        latents: (n, num_latent, num_style_feat).
        noise: the image-shaped noise, already divided by sqrt(h * w).
        mean_path_length: the running mean (a scalar tensor or float).

    Returns:
        (penalty, the batch's mean path length, the running mean moved by
        ``decay`` toward it, detached). In a multi-process run the batch's
        mean is the global batch's (``parallel.data_parallel.global_mean``).
    """
    grad, = torch.autograd.grad(outputs=(fake_img * noise).sum(),
                                inputs=latents, create_graph=True)
    path_lengths = torch.sqrt(grad.pow(2).sum(2).mean(1))
    batch_mean = global_mean(path_lengths)
    path_mean = mean_path_length + decay * (batch_mean - mean_path_length)
    path_penalty = (path_lengths - path_mean).pow(2).mean()
    return path_penalty, batch_mean.detach(), path_mean.detach()


def gradient_penalty_loss(discriminator, real_data, fake_data, alpha,
                          weight=None):
    """WGAN-GP gradient penalty (reference: losses.py:406-442;
    ``edvr_tpu/models/losses.py:183-196``); ``alpha``: (n, 1, 1, 1)
    interpolation weights, drawn by the caller."""
    interpolates = alpha * real_data + (1. - alpha) * fake_data
    if not interpolates.requires_grad:
        interpolates.requires_grad_(True)
    grad, = torch.autograd.grad(outputs=discriminator(interpolates).sum(),
                                inputs=interpolates, create_graph=True)
    if weight is not None:
        grad = grad * weight
    gp = ((grad.reshape(grad.shape[0], -1).norm(2, dim=1) - 1)**2).mean()
    if weight is not None:
        gp = gp / weight.mean()
    return gp


def build_loss(opt: dict):
    """Instantiate a loss from its YAML option dict."""
    opt = dict(opt)
    loss_type = opt.pop('type')
    return LOSS_REGISTRY.get(loss_type)(**opt)
