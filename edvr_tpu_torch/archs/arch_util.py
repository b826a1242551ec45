"""Architecture building blocks (NCHW ``nn.Module``s).

Counterparts of ``edvr_tpu/archs/arch_util.py``, with BasicSR's parameter
names (reference: basicsr/models/archs/arch_util.py), so the reference's
state dicts load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math
import os

import torch
from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.ops.dcn import modulated_deform_conv
from edvr_tpu_torch.parallel.data_parallel import all_reduce_sum, syncs_batch
from edvr_tpu_torch.utils.logger import get_root_logger


def _no_align() -> bool:
    """``EDVR_TPU_PCD_NO_ALIGN=1``: the alignment ablation of the JAX
    package (``edvr_tpu/archs/arch_util.py:202-209``), offsets held at
    zero and cut from the graph, so no gradient reaches ``conv_offset``
    through them; the parameters are unchanged."""
    return os.environ.get('EDVR_TPU_PCD_NO_ALIGN') == '1'


def _monitor_offsets(offset):
    """``EDVR_TPU_MONITOR_OFFSETS=1``: warn when the mean |offset| exceeds
    50, a sign of diverging alignment (reference: arch_util.py:249-253;
    ``edvr_tpu/archs/arch_util.py:211-224``). A host check, made only when
    the variable is set."""
    if os.environ.get('EDVR_TPU_MONITOR_OFFSETS') == '1':
        absmean = offset.detach().abs().mean().item()
        if absmean > 50:
            get_root_logger().warning(
                f'Offset abs mean is {absmean}, larger than 50.')


def lrelu(x, negative_slope: float = 0.1):
    return F.leaky_relu(x, negative_slope=negative_slope)


def default_init_weights(modules, scale=1.0):
    """Kaiming-normal weights (fan_in, gain sqrt(2)) times ``scale`` and
    zero biases for convolutions and linear layers (reference:
    arch_util.py:20-48; ``edvr_tpu/archs/arch_util.py:43-55``)."""
    with torch.no_grad():
        for m in modules:
            nn.init.kaiming_normal_(m.weight)
            m.weight.mul_(scale)
            if m.bias is not None:
                m.bias.zero_()


class FlaxBatchNorm:
    """Mixed into ``nn.BatchNorm2d`` / ``nn.BatchNorm3d`` (same parameters
    and state-dict keys): in training mode the layer normalises by the
    batch's mean and biased variance, as torch does, but moves its running
    statistics as ``flax.linen.BatchNorm`` does, by the biased variance
    (torch's layers use the unbiased one): ``running = (1 - momentum)
    running + momentum batch``, so flax's momentum m is ``1 - m`` here.
    ``update_stats = False`` normalises by the batch without moving them.

    In a process group of more than one rank the batch is the global one,
    as the JAX step sees the whole sharded batch: the per-channel sum and
    then the sum of squared deviations are summed over the ranks
    (``parallel.all_reduce_sum``, whose backward sums the gradients over
    the ranks again, as ``nn.SyncBatchNorm`` does, under gloo too), so the
    output, the gradients and the running statistics are those of one
    process on the global batch, on every rank.
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        dims = (0, *range(2, x.dim()))
        if syncs_batch():
            out, mean, var = self._global_batch_norm(x, dims)
        else:
            out = F.batch_norm(x, None, None, self.weight, self.bias, True,
                               0.0, self.eps)
            mean = var = None
        if self.update_stats:
            with torch.no_grad():
                dt = self.running_mean.dtype
                if mean is None:
                    var, mean = torch.var_mean(x.detach().to(dt), dim=dims,
                                               correction=0)
                self.running_mean.lerp_(mean.detach().to(dt), self.momentum)
                self.running_var.lerp_(var.detach().to(dt), self.momentum)
                self.num_batches_tracked.add_(1)
        return out

    def _global_batch_norm(self, x, dims):
        """Normalise by the global batch's mean and biased variance (two
        passes, each summed over the ranks); returns (out, mean, var)."""
        shape = (1, -1, *([1] * (x.dim() - 2)))
        count = x.numel() // x.shape[1] * torch.distributed.get_world_size()
        mean = all_reduce_sum(x.sum(dims)) / count
        centred = x - mean.view(shape)
        var = all_reduce_sum(centred.square().sum(dims)) / count
        out = centred * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            out = out * self.weight.view(shape) + self.bias.view(shape)
        return out, mean, var


class BatchNorm2d(FlaxBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics update."""


class BatchNorm3d(FlaxBatchNorm, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with flax's running-statistics update."""


class ResidualBlockNoBN(nn.Module):
    """Conv-ReLU-Conv residual block without BN, the residual scaled by
    ``res_scale`` (reference: arch_util.py:67-95;
    ``edvr_tpu/archs/arch_util.py:101-123``). Without ``pytorch_init`` both
    convs start kaiming-normal scaled by 0.1 with zero bias; with it they
    keep torch's default."""

    def __init__(self, num_feat=64, res_scale=1.0, pytorch_init=False):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        if not pytorch_init:
            default_init_weights([self.conv1, self.conv2], 0.1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x))) * self.res_scale


class Upsample(nn.Sequential):
    """Pixel-shuffle upsampler for scales 2^n and 3 (reference:
    arch_util.py:98-118; ``edvr_tpu/archs/arch_util.py:126-149``): a 3x3
    conv to 4 (or 9) x ``num_feat`` channels and a pixel shuffle per stage,
    so the convs are children 0, 2, ..."""

    def __init__(self, scale, num_feat):
        layers = []
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1),
                           nn.PixelShuffle(2)]
        elif scale == 3:
            layers += [nn.Conv2d(num_feat, 9 * num_feat, 3, 1, 1),
                       nn.PixelShuffle(3)]
        else:
            raise ValueError(f'scale {scale} is not supported. '
                             'Supported scales: 2^n and 3.')
        super().__init__(*layers)


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
        if _no_align():
            offset = torch.zeros_like(offset.detach())
        _monitor_offsets(offset)
        return modulated_deform_conv(x, offset, mask, self.weight, self.bias,
                                     self.stride, self.padding,
                                     self.dilation, self.groups,
                                     self.deformable_groups)


class WarpAlignPack(nn.Module):
    """Tap-shared deformable alignment, the ``align_variant: tap_shared``
    counterpart of :class:`DCNv2Pack` (``edvr_tpu/archs/arch_util.py:236-314``).

    One (dy, dx, mask) per deformable group warps each group's feature
    plane (bilinear, zero outside, masked), then a dense k x k conv runs
    over the warped planes. The warp is a K=1 modulated deformable conv
    with an identity 1x1 weight, so it rides the same DCN kernels.

    ``conv_offset`` (dg*3 outputs, zero-initialised) and the dense conv's
    ``weight``/``bias`` are named so that the JAX tree converts unchanged:
    ``convert._torch_key`` drops the flax ``conv`` scopes, which puts the
    JAX ``conv/conv/kernel`` on ``weight``.
    """

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, dilation=1, groups=1, deformable_groups=8):
        super().__init__()
        if in_channels % deformable_groups:
            raise ValueError(f'in_channels {in_channels} is not a multiple '
                             f'of deformable_groups {deformable_groups}')
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.deformable_groups = deformable_groups
        k = kernel_size
        self.conv_offset = nn.Conv2d(in_channels, deformable_groups * 3, k,
                                     1, (k - 1) // 2, dilation, bias=True)
        # the dense conv starts as torch's Conv2d default, as the JAX
        # Conv2d's torch-default init does
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1. / math.sqrt(in_channels // groups * k * k)
        with torch.no_grad():
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()
            nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
            self.bias.uniform_(-bound, bound)

    def forward(self, x, feat):
        n, cin, h, w = x.shape
        dg = self.deformable_groups
        dy, dx, mask = torch.chunk(self.conv_offset(feat), 3, dim=1)
        if _no_align():  # the warp held at identity, as DCNv2Pack's
            dy = torch.zeros_like(dy.detach())
            dx = torch.zeros_like(dx.detach())
        # channel 2g is group g's dy and 2g+1 its dx (K=1)
        offset = torch.stack([dy, dx], dim=2).reshape(n, 2 * dg, h, w)
        eye = torch.eye(cin, device=x.device, dtype=x.dtype).view(
            cin, cin, 1, 1)
        warped = modulated_deform_conv(x, offset, torch.sigmoid(mask), eye,
                                       None, 1, 0, 1, 1, dg)
        return F.conv2d(warped, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups)
