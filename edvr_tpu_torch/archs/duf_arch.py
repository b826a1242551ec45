"""DUF: video SR by dynamic upsampling filters (NCTHW inside), the
counterpart of ``edvr_tpu/archs/duf_arch.py`` (reference:
basicsr/models/archs/duf_arch.py): 3-D conv dense blocks over the seven
frames, three temporal reductions down to one frame, then a residual head
(3 r^2 channels) and a filter head (25 r^2 channels, a softmax over the 25
taps) whose per-pixel 5x5 filters upsample the centre frame; residual plus
filtered frame, pixel-shuffled by r.

BatchNorm follows the JAX package: eps 1e-3 with
``adapt_official_weights`` (the official TensorFlow model's), else 1e-5,
and flax's default momentum 0.99 (0.01 here, ``arch_util.BatchNorm3d``)
for the running statistics.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.archs.arch_util import BatchNorm3d
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY

# flax's BatchNorm momentum 0.99, in torch's convention
BN_MOMENTUM = 0.01
# num_layer -> (dense blocks, growth channels)
LAYERS = {16: (3, 32), 28: (9, 16), 52: (21, 16)}


def bn_relu_conv_block(cin, cout, eps, last_padding=(1, 1, 1)):
    """``Sequential(BN, ReLU, Conv 1x1x1 cin -> cin, BN, ReLU, Conv 3x3x3
    cin -> cout)``: children 0 and 3 are the BatchNorms, 2 and 5 the
    convs."""
    return nn.Sequential(
        BatchNorm3d(cin, eps=eps, momentum=BN_MOMENTUM),
        nn.ReLU(inplace=True), nn.Conv3d(cin, cin, 1),
        BatchNorm3d(cin, eps=eps, momentum=BN_MOMENTUM),
        nn.ReLU(inplace=True), nn.Conv3d(cin, cout, 3, padding=last_padding))


class DenseBlocksTemporalReduce(nn.Module):
    """Three blocks, each adding ``num_grow_ch`` channels and dropping the
    first and last frame (its 3x3x3 conv is unpadded in time)."""

    def __init__(self, num_feat=64, num_grow_ch=32,
                 adapt_official_weights=False):
        super().__init__()
        eps = 1e-3 if adapt_official_weights else 1e-5
        for i in range(3):
            setattr(self, f'temporal_reduce{i + 1}', bn_relu_conv_block(
                num_feat + i * num_grow_ch, num_grow_ch, eps, (0, 1, 1)))

    def forward(self, x):
        for i in range(3):
            y = getattr(self, f'temporal_reduce{i + 1}')(x)
            x = torch.cat([x[:, :, 1:-1], y], 1)
        return x


class DenseBlocks(nn.Module):
    """``num_block`` blocks, each adding ``num_grow_ch`` channels."""

    def __init__(self, num_block, num_feat=64, num_grow_ch=16,
                 adapt_official_weights=False):
        super().__init__()
        eps = 1e-3 if adapt_official_weights else 1e-5
        self.dense_blocks = nn.ModuleList([
            bn_relu_conv_block(num_feat + i * num_grow_ch, num_grow_ch, eps)
            for i in range(num_block)])

    def forward(self, x):
        for block in self.dense_blocks:
            x = torch.cat([x, block(x)], 1)
        return x


def dynamic_upsampling_filter(x, filters, filter_size=(5, 5)):
    """Per-pixel filters applied to an image.

    Args:
        x: (n, c, h, w).
        filters: (n, kh * kw, r^2, h, w), normalised over the taps.

    Returns:
        (n, c * r^2, h, w), channel ``c * r^2 + u``: each pixel's zero-padded
        kh x kw neighbourhood contracted with its filters in float32.
    """
    n, c, h, w = x.shape
    kh, kw = filter_size
    patches = F.unfold(x.float(), (kh, kw), padding=(kh // 2, kw // 2))
    patches = patches.view(n, c, kh * kw, h, w)
    out = torch.einsum('ncphw,npuhw->ncuhw', patches, filters.float())
    return out.reshape(n, c * filters.shape[2], h, w).to(x.dtype)


@ARCH_REGISTRY.register()
class DUF(nn.Module):
    """``forward(x)``: (b, 7, 3, h, w) LQ frames -> (b, 3, h r, w r).
    ``num_layer`` is 16, 28 or 52."""

    def __init__(self, scale=4, num_layer=52, adapt_official_weights=False):
        super().__init__()
        if num_layer not in LAYERS:
            raise ValueError('Only supported (16, 28, 52) layers, '
                             f'but got {num_layer}.')
        self.scale = scale
        eps = 1e-3 if adapt_official_weights else 1e-5
        num_block, num_grow_ch = LAYERS[num_layer]
        self.conv3d1 = nn.Conv3d(3, 64, (1, 3, 3), padding=(0, 1, 1))
        self.dense_block1 = DenseBlocks(num_block, 64, num_grow_ch,
                                        adapt_official_weights)
        self.dense_block2 = DenseBlocksTemporalReduce(
            64 + num_grow_ch * num_block, num_grow_ch,
            adapt_official_weights)
        channels = 64 + num_grow_ch * num_block + num_grow_ch * 3
        self.bn3d2 = BatchNorm3d(channels, eps=eps, momentum=BN_MOMENTUM)
        self.conv3d2 = nn.Conv3d(channels, 256, (1, 3, 3), padding=(0, 1, 1))
        self.conv3d_r1 = nn.Conv3d(256, 256, 1)
        self.conv3d_r2 = nn.Conv3d(256, 3 * scale**2, 1)
        self.conv3d_f1 = nn.Conv3d(256, 512, 1)
        self.conv3d_f2 = nn.Conv3d(512, 25 * scale**2, 1)

    def forward(self, x):
        b, t, _, h, w = x.shape
        x = x.permute(0, 2, 1, 3, 4)  # (b, c, t, h, w) for the 3-D convs
        x_center = x[:, :, t // 2]
        x = self.dense_block2(self.dense_block1(self.conv3d1(x)))
        x = F.relu(self.bn3d2(x))
        x = F.relu(self.conv3d2(x))
        res = self.conv3d_r2(F.relu(self.conv3d_r1(x)))[:, :, 0]
        filt = self.conv3d_f2(F.relu(self.conv3d_f1(x)))[:, :, 0]
        filt = F.softmax(filt.view(b, 25, self.scale**2, h, w), dim=1)
        out = dynamic_upsampling_filter(x_center, filt) + res
        return F.pixel_shuffle(out, self.scale)
