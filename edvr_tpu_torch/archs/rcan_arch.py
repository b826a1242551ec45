"""RCAN (NCHW), the counterpart of ``edvr_tpu/archs/rcan_arch.py``
(reference: basicsr/models/archs/rcan_arch.py): residual groups of RCABs
with squeeze-and-excitation channel attention, EDSR's mean shift and
Upsample."""

from __future__ import annotations

from torch import nn

from edvr_tpu_torch.archs.arch_util import Upsample, make_layer
from edvr_tpu_torch.archs.edsr_arch import MeanShift
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY


class ChannelAttention(nn.Module):
    """Global average pool, 1x1 squeeze, ReLU, 1x1 excite, sigmoid gate
    (reference: rcan_arch.py:7-26)."""

    def __init__(self, num_feat, squeeze_factor=16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(num_feat, num_feat // squeeze_factor, 1, padding=0),
            nn.ReLU(inplace=True),
            nn.Conv2d(num_feat // squeeze_factor, num_feat, 1, padding=0),
            nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class RCAB(nn.Module):
    """Residual channel-attention block (reference: rcan_arch.py:29-49)."""

    def __init__(self, num_feat, squeeze_factor=16, res_scale=1.0):
        super().__init__()
        self.res_scale = res_scale
        self.rcab = nn.Sequential(nn.Conv2d(num_feat, num_feat, 3, 1, 1),
                                  nn.ReLU(True),
                                  nn.Conv2d(num_feat, num_feat, 3, 1, 1),
                                  ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        return self.rcab(x) * self.res_scale + x


class ResidualGroup(nn.Module):
    """(reference: rcan_arch.py:52-75)"""

    def __init__(self, num_feat, num_block, squeeze_factor=16, res_scale=1.0):
        super().__init__()
        self.residual_group = make_layer(RCAB, num_block, num_feat=num_feat,
                                         squeeze_factor=squeeze_factor,
                                         res_scale=res_scale)
        self.conv = nn.Conv2d(num_feat, num_feat, 3, 1, 1)

    def forward(self, x):
        return self.conv(self.residual_group(x)) + x


@ARCH_REGISTRY.register()
class RCAN(nn.Module):
    """(reference: rcan_arch.py:78-141)"""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_group=10,
                 num_block=16, squeeze_factor=16, upscale=4, res_scale=1.0,
                 img_range=255., rgb_mean=(0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.mean_shift = MeanShift(img_range, rgb_mean)
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(ResidualGroup, num_group, num_feat=num_feat,
                               num_block=num_block,
                               squeeze_factor=squeeze_factor,
                               res_scale=res_scale)
        self.conv_after_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def forward(self, x):
        x = self.conv_first(self.mean_shift.shift(x))
        res = self.conv_after_body(self.body(x)) + x
        return self.mean_shift.unshift(self.conv_last(self.upsample(res)))
