"""DFDNet building blocks (NCHW), the counterpart of
``edvr_tpu/archs/dfdnet_util.py`` (reference:
basicsr/models/archs/dfdnet_util.py).

The spectral-normalised convolutions are plain ``nn.Conv2d``s under
BasicSR's ``nn.Sequential`` indices: DFDNet is inference-only, and a
checkpoint's spectral norm is folded into its weights when it is read
(``edvr_tpu_torch.convert.fold_spectral_norm``)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

_BLUR = torch.tensor([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]]) / 16.


def blur(x):
    """Depthwise 3x3 binomial blur, zero padding 1 (reference:
    dfdnet_util.py:8-62)."""
    c = x.shape[1]
    kernel = _BLUR.to(x.device, x.dtype).expand(c, 1, 3, 3)
    return F.conv2d(x, kernel, padding=1, groups=c)


def calc_mean_std(feat, eps=1e-5):
    """Per-sample, per-channel spatial mean and std: unbiased variance plus
    ``eps``, as the JAX package takes it (reference: dfdnet_util.py:65-79).
    Returns two (n, c, 1, 1) tensors."""
    n, c = feat.shape[:2]
    flat = feat.reshape(n, c, -1)
    mean = flat.mean(dim=2).view(n, c, 1, 1)
    std = (flat.var(dim=2, unbiased=True) + eps).sqrt().view(n, c, 1, 1)
    return mean, std


def adaptive_instance_normalization(content_feat, style_feat):
    """AdaIN: ``content_feat`` normalised, then given ``style_feat``'s mean
    and std (reference: dfdnet_util.py:82-96)."""
    style_mean, style_std = calc_mean_std(style_feat)
    content_mean, content_std = calc_mean_std(content_feat)
    normalized = (content_feat - content_mean) / content_std
    return normalized * style_std + style_mean


def _conv(cin, cout, kernel_size=3, dilation=1):
    return nn.Conv2d(cin, cout, kernel_size, 1,
                     ((kernel_size - 1) // 2) * dilation, dilation)


class AttentionBlock(nn.Sequential):
    """conv, LeakyReLU 0.2, conv; children 0 and 2 (reference:
    dfdnet_util.py:99-103)."""

    def __init__(self, in_channel):
        super().__init__(_conv(in_channel, in_channel),
                         nn.LeakyReLU(0.2), _conv(in_channel, in_channel))


class ConvBlockSN(nn.Sequential):
    """MSDilationBlock's branch: two dilated convs around a LeakyReLU 0.2
    (reference: dfdnet_util.py:106-133)."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 dilation=1):
        super().__init__(_conv(in_channels, out_channels, kernel_size,
                               dilation), nn.LeakyReLU(0.2),
                         _conv(out_channels, out_channels, kernel_size,
                               dilation))


class MSDilationBlock(nn.Module):
    """Four dilated branches, concatenated, fused by a conv, plus the input
    (reference: dfdnet_util.py:136-171)."""

    def __init__(self, in_channels, kernel_size=3, dilation=(1, 1, 1, 1)):
        super().__init__()
        self.conv_blocks = nn.ModuleList(
            ConvBlockSN(in_channels, in_channels, kernel_size, d)
            for d in dilation)
        self.conv_fusion = _conv(in_channels * 4, in_channels, kernel_size)

    def forward(self, x):
        out = torch.cat([block(x) for block in self.conv_blocks], 1)
        return self.conv_fusion(out) + x


class UpResBlock(nn.Module):
    """x + conv(LeakyReLU 0.2(conv(x))) (reference: dfdnet_util.py:
    174-186)."""

    def __init__(self, in_channel):
        super().__init__()
        self.body = nn.Sequential(_conv(in_channel, in_channel),
                                  nn.LeakyReLU(0.2),
                                  _conv(in_channel, in_channel))

    def forward(self, x):
        return x + self.body(x)
