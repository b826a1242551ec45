"""Architecture building blocks (NCHW ``nn.Module``s).

Counterparts of ``edvr_tpu/archs/arch_util.py``, with BasicSR's parameter
names (reference: basicsr/models/archs/arch_util.py), so the reference's
state dicts load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.ops.dcn import modulated_deform_conv


def lrelu(x, negative_slope: float = 0.1):
    return F.leaky_relu(x, negative_slope=negative_slope)


class ResidualBlockNoBN(nn.Module):
    """Conv-ReLU-Conv residual block without BN (reference:
    arch_util.py:67-95); both convs start kaiming-normal scaled by 0.1
    with zero bias (default_init_weights, arch_util.py:20-48)."""

    def __init__(self, num_feat=64):
        super().__init__()
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        with torch.no_grad():
            for conv in (self.conv1, self.conv2):
                nn.init.kaiming_normal_(conv.weight)
                conv.weight.mul_(0.1)
                conv.bias.zero_()

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


def make_layer(basic_block, num_basic_block: int, **kwarg):
    """``nn.Sequential`` of ``num_basic_block`` blocks (reference:
    arch_util.py:51-64); children are named 0..n-1."""
    return nn.Sequential(*[basic_block(**kwarg)
                           for _ in range(num_basic_block)])


class DCNv2Pack(nn.Module):
    """Modulated deformable conv whose offsets and mask come from a
    separate feature tensor (reference: arch_util.py:232-257 with the
    ModulatedDeformConvPack parameters, deform_conv.py:345-390).

    ``conv_offset`` is zero-initialised, so the op starts as a plain conv;
    the main weight is uniform(+-1/sqrt(fan_in)).
    """

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, dilation=1, groups=1, deformable_groups=8,
                 bias=True):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.deformable_groups = deformable_groups
        k = kernel_size
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.conv_offset = nn.Conv2d(in_channels,
                                     deformable_groups * 3 * k * k, k,
                                     stride, padding, dilation, bias=True)
        stdv = 1. / math.sqrt(in_channels * k * k)
        with torch.no_grad():
            self.weight.uniform_(-stdv, stdv)
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()

    def forward(self, x, feat):
        out = self.conv_offset(feat)
        o1, o2, mask = torch.chunk(out, 3, dim=1)
        offset = torch.cat((o1, o2), dim=1)
        mask = torch.sigmoid(mask)
        return modulated_deform_conv(x, offset, mask, self.weight, self.bias,
                                     self.stride, self.padding,
                                     self.dilation, self.groups,
                                     self.deformable_groups)
