"""RRDBNet, the ESRGAN generator (NCHW), the counterpart of
``edvr_tpu/archs/rrdbnet_arch.py`` (reference:
basicsr/models/archs/rrdbnet_arch.py): residual dense blocks scaled by 0.2,
an RRDB trunk, and nearest x2 upsampling twice (x4 only)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.archs.arch_util import (default_init_weights, lrelu,
                                            make_layer)
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY


def _act(x):
    return lrelu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    """Five densely connected convs, the last scaled by 0.2 onto the input
    (reference: rrdbnet_arch.py:8-41)."""

    def __init__(self, num_feat=64, num_grow_ch=32):
        super().__init__()
        g = num_grow_ch
        self.conv1 = nn.Conv2d(num_feat, g, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat + g, g, 3, 1, 1)
        self.conv3 = nn.Conv2d(num_feat + 2 * g, g, 3, 1, 1)
        self.conv4 = nn.Conv2d(num_feat + 3 * g, g, 3, 1, 1)
        self.conv5 = nn.Conv2d(num_feat + 4 * g, num_feat, 3, 1, 1)
        default_init_weights([self.conv1, self.conv2, self.conv3, self.conv4,
                              self.conv5], 0.1)

    def forward(self, x):
        x1 = _act(self.conv1(x))
        x2 = _act(self.conv2(torch.cat((x, x1), 1)))
        x3 = _act(self.conv3(torch.cat((x, x1, x2), 1)))
        x4 = _act(self.conv4(torch.cat((x, x1, x2, x3), 1)))
        x5 = self.conv5(torch.cat((x, x1, x2, x3, x4), 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    """Residual in residual dense block (reference: rrdbnet_arch.py:44-65)."""

    def __init__(self, num_feat, num_grow_ch=32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


@ARCH_REGISTRY.register()
class RRDBNet(nn.Module):
    """(reference: rrdbnet_arch.py:68-113; x4 only, as the JAX module)"""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23,
                 num_grow_ch=32):
        super().__init__()
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(RRDB, num_block, num_feat=num_feat,
                               num_grow_ch=num_grow_ch)
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def forward(self, x):
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        for conv in (self.conv_up1, self.conv_up2):
            feat = _act(conv(F.interpolate(feat, scale_factor=2,
                                           mode='nearest')))
        return self.conv_last(_act(self.conv_hr(feat)))
