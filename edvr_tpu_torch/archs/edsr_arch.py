"""EDSR (NCHW), the counterpart of ``edvr_tpu/archs/edsr_arch.py``
(reference: basicsr/models/archs/edsr_arch.py:8-65): the input shifted by
``rgb_mean`` and scaled by ``img_range``, residual blocks with torch's
default init and ``res_scale`` (EDSR-L: 0.1), conv_after_body plus a global
skip, the pixel-shuffle Upsample and conv_last, the shift undone."""

from __future__ import annotations

import torch
from torch import nn

from edvr_tpu_torch.archs.arch_util import (ResidualBlockNoBN, Upsample,
                                            make_layer)
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY


class MeanShift(nn.Module):
    """``(x - rgb_mean) * img_range`` in, ``x / img_range + rgb_mean`` out;
    the mean is a constant, not a parameter (BasicSR keeps it out of the
    state dict)."""

    def __init__(self, img_range, rgb_mean):
        super().__init__()
        self.img_range = img_range
        self.register_buffer('mean', torch.tensor(rgb_mean).view(1, -1, 1, 1),
                             persistent=False)

    def shift(self, x):
        return (x - self.mean.to(x.dtype)) * self.img_range

    def unshift(self, x):
        return x / self.img_range + self.mean.to(x.dtype)


@ARCH_REGISTRY.register()
class EDSR(nn.Module):

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_block=16,
                 upscale=4, res_scale=1.0, img_range=255.,
                 rgb_mean=(0.4488, 0.4371, 0.4040)):
        super().__init__()
        self.mean_shift = MeanShift(img_range, rgb_mean)
        self.conv_first = nn.Conv2d(num_in_ch, num_feat, 3, 1, 1)
        self.body = make_layer(ResidualBlockNoBN, num_block,
                               num_feat=num_feat, res_scale=res_scale,
                               pytorch_init=True)
        self.conv_after_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def forward(self, x):
        x = self.conv_first(self.mean_shift.shift(x))
        res = self.conv_after_body(self.body(x)) + x
        return self.mean_shift.unshift(self.conv_last(self.upsample(res)))
