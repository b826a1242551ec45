"""Modified SRResNet (NCHW), the counterpart of
``edvr_tpu/archs/srresnet_arch.py`` (reference:
basicsr/models/archs/srresnet_arch.py:7-76): conv_first, ``num_block``
residual blocks, pixel-shuffle upsampling (x2/x3 one stage, x4 two x2
stages), conv_hr and conv_last, plus the bilinearly upsampled input."""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.archs.arch_util import (ResidualBlockNoBN,
                                            default_init_weights, lrelu,
                                            make_layer)
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY


@ARCH_REGISTRY.register()
class MSRResNet(nn.Module):

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_block=16,
                 upscale=4):
        super().__init__()
        if upscale not in (2, 3, 4):
            raise ValueError(f'unsupported upscale {upscale}')
        self.upscale = upscale
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(ResidualBlockNoBN, num_block,
                               num_feat=num_feat)
        ups = [nn.Conv2d(num_feat, num_feat * (4 if upscale == 4
                                               else upscale ** 2), 3, 1, 1)]
        self.upconv1 = ups[0]
        if upscale == 4:
            self.upconv2 = nn.Conv2d(num_feat, num_feat * 4, 3, 1, 1)
            ups.append(self.upconv2)
        self.pixel_shuffle = nn.PixelShuffle(2 if upscale == 4 else upscale)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)
        default_init_weights([self.conv_first, *ups, self.conv_hr,
                              self.conv_last], 0.1)

    def forward(self, x):
        out = self.body(lrelu(self.conv_first(x)))
        out = lrelu(self.pixel_shuffle(self.upconv1(out)))
        if self.upscale == 4:
            out = lrelu(self.pixel_shuffle(self.upconv2(out)))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        return out + F.interpolate(x, scale_factor=self.upscale,
                                   mode='bilinear', align_corners=False)
