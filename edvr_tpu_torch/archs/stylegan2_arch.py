"""StyleGAN2 generator and discriminator (NCHW), the counterpart of
``edvr_tpu/archs/stylegan2_arch.py`` (reference:
basicsr/models/archs/stylegan2_arch.py), with BasicSR's module names and
state-dict keys.

The modulated convolution keeps the JAX package's formulation: instead of
one weight per sample and a convolution with ``groups=b``
(stylegan2_arch.py:285-319), it convolves ``x * style * scale`` with the
shared weight and scales the output by a per-(sample, channel)
demodulation, which is the same function and one convolution of the whole
batch. Upsampling is ``conv_transpose2d`` (stride 2, no padding), then the
demodulation, then the FIR smoothing; downsampling is the smoothing, then
a stride-2 convolution without padding. The FIR resampling
(``ops/upfirdn2d.py``) and the fused activation (``ops/fused_act.py``) are
plain tensor ops, and every convolution is ``ops/conv_grad.py``'s, whose
gradients are convolutions again, so autograd's double backward (R1, path
length) runs on cuDNN's convolution kernels.

Noise injection draws from a ``torch.Generator`` on the input's device
when no noise is given (:meth:`StyleGAN2Generator.noise_generator`, seeded
by ``noise_seed``; a copy of the network starts its own); the stored
per-layer noises are zero buffers, as the JAX package initialises them
(BasicSR draws them at random).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.ops import conv_grad
from edvr_tpu_torch.ops.fused_act import FusedLeakyReLU, fused_leaky_relu
from edvr_tpu_torch.ops.upfirdn2d import make_resample_kernel, upfirdn2d
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY


def normalize_style_code(x):
    """(reference: stylegan2_arch.py:16-27)"""
    return x * torch.rsqrt(torch.mean(x**2, dim=1, keepdim=True) + 1e-8)


def upfirdn_upsample(x, kernel, factor=2):
    """(reference: stylegan2_arch.py:47-74)"""
    kernel = kernel * (factor**2)
    pad = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, down=1,
                     pad=((pad + 1) // 2 + factor - 1, pad // 2))


def upfirdn_downsample(x, kernel, factor=2):
    """(reference: stylegan2_arch.py:77-100)"""
    pad = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor,
                     pad=((pad + 1) // 2, pad // 2))


def upfirdn_smooth(x, kernel, upsample_factor=1, downsample_factor=1,
                   kernel_size=1):
    """(reference: stylegan2_arch.py:103-138)"""
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor**2)
        pad = (kernel.shape[0] - upsample_factor) - (kernel_size - 1)
        pads = ((pad + 1) // 2 + upsample_factor - 1, pad // 2 + 1)
    elif downsample_factor > 1:
        pad = (kernel.shape[0] - downsample_factor) + (kernel_size - 1)
        pads = ((pad + 1) // 2, pad // 2)
    else:
        raise NotImplementedError
    return upfirdn2d(x, kernel, up=1, down=1, pad=pads)


def channels(narrow, channel_multiplier):
    """Feature channels by resolution (reference: stylegan2_arch.py:
    470-480)."""
    cm = channel_multiplier
    return {
        '4': int(512 * narrow), '8': int(512 * narrow),
        '16': int(512 * narrow), '32': int(512 * narrow),
        '64': int(256 * cm * narrow), '128': int(128 * cm * narrow),
        '256': int(64 * cm * narrow), '512': int(32 * cm * narrow),
        '1024': int(16 * cm * narrow)
    }


class NormStyleCode(nn.Module):

    def forward(self, x):
        return normalize_style_code(x)


class EqualLinear(nn.Module):
    """Equalized linear (reference: stylegan2_arch.py:146-201): the stored
    weight (out, in) is N(0, 1) / ``lr_mul``, scaled by ``lr_mul /
    sqrt(in)`` at run time; the bias is multiplied by ``lr_mul``."""

    def __init__(self, in_channels, out_channels, bias=True,
                 bias_init_val=0., lr_mul=1., activation=None):
        super().__init__()
        if activation not in (None, 'fused_lrelu'):
            raise ValueError(f'Wrong activation value in EqualLinear: '
                             f'{activation}')
        self.lr_mul = lr_mul
        self.activation = activation
        self.scale = (1 / math.sqrt(in_channels)) * lr_mul
        self.weight = nn.Parameter(
            torch.randn(out_channels, in_channels).div_(lr_mul))
        if bias:
            self.bias = nn.Parameter(torch.full((out_channels,),
                                                float(bias_init_val)))
        else:
            self.register_parameter('bias', None)

    def forward(self, x):
        bias = None if self.bias is None else self.bias * self.lr_mul
        out = F.linear(x, self.weight * self.scale)
        if self.activation == 'fused_lrelu':
            return fused_leaky_relu(out, bias)
        return out if bias is None else out + bias


class ModulatedConv2d(nn.Module):
    """Style-modulated, optionally demodulated convolution without a bias
    (reference: stylegan2_arch.py:204-326); the weight keeps BasicSR's
    (1, out, in, k, k) layout."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 num_style_feat, demodulate=True, sample_mode=None,
                 resample_kernel=(1, 3, 3, 1), eps=1e-8):
        super().__init__()
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.sample_mode = sample_mode
        self.eps = eps
        self.scale = 1 / math.sqrt(in_channels * kernel_size**2)
        self.modulation = EqualLinear(num_style_feat, in_channels,
                                      bias=True, bias_init_val=1, lr_mul=1)
        self.weight = nn.Parameter(torch.randn(1, out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.register_buffer('kernel', make_resample_kernel(resample_kernel),
                             persistent=False)

    def forward(self, x, style):
        b, cin = x.shape[:2]
        k = self.kernel_size
        style = self.modulation(style)  # (b, cin)
        weight = self.weight[0]  # (cout, cin, k, k)
        xs = x * (style * self.scale).view(b, cin, 1, 1)
        if self.sample_mode == 'upsample':
            out = conv_grad.conv_transpose2d(xs, weight.transpose(0, 1),
                                             stride=2)
        elif self.sample_mode == 'downsample':
            xs = upfirdn_smooth(xs, self.kernel, downsample_factor=2,
                                kernel_size=k)
            out = conv_grad.conv2d(xs, weight, stride=2)
        else:
            out = conv_grad.conv2d(xs, weight, padding=k // 2)
        if self.demodulate:
            # rsqrt(sum_{cin, k} (scale W style)^2 + eps) per (b, cout)
            w_sq = (self.scale * weight).pow(2).sum((2, 3))  # (cout, cin)
            demod = torch.rsqrt(style.pow(2) @ w_sq.t() + self.eps)
            out = out * demod.view(b, -1, 1, 1)
        if self.sample_mode == 'upsample':
            out = upfirdn_smooth(out, self.kernel, upsample_factor=2,
                                 kernel_size=k)
        return out


class StyleConv(nn.Module):
    """Modulated convolution, noise injection (its strength ``weight``
    starts at zero) and the fused activation (reference:
    stylegan2_arch.py:329-374)."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 num_style_feat, demodulate=True, sample_mode=None,
                 resample_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(
            in_channels, out_channels, kernel_size, num_style_feat,
            demodulate=demodulate, sample_mode=sample_mode,
            resample_kernel=resample_kernel)
        self.weight = nn.Parameter(torch.zeros(1))
        self.activate = FusedLeakyReLU(out_channels)

    def forward(self, x, style, noise=None, generator=None):
        out = self.modulated_conv(x, style)
        if noise is None:
            b, _, h, w = out.shape
            noise = torch.randn(b, 1, h, w, generator=generator,
                                device=out.device, dtype=out.dtype)
        return self.activate(out + self.weight * noise)


class ToRGB(nn.Module):
    """(reference: stylegan2_arch.py:377-424)"""

    def __init__(self, in_channels, num_style_feat, upsample=True,
                 resample_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.upsample = upsample
        self.modulated_conv = ModulatedConv2d(
            in_channels, 3, 1, num_style_feat, demodulate=False,
            sample_mode=None)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.register_buffer('kernel', make_resample_kernel(resample_kernel),
                             persistent=False)

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            if self.upsample:
                skip = upfirdn_upsample(skip, self.kernel)
            out = out + skip
        return out


class ConstantInput(nn.Module):

    def __init__(self, num_channel, size):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(1, num_channel, size, size))

    def forward(self, batch):
        return self.weight.repeat(batch, 1, 1, 1)


@ARCH_REGISTRY.register()
class StyleGAN2Generator(nn.Module):
    """(reference: stylegan2_arch.py:444-658)"""

    def __init__(self, out_size, num_style_feat=512, num_mlp=8,
                 channel_multiplier=2, resample_kernel=(1, 3, 3, 1),
                 lr_mlp=0.01, narrow=1, noise_seed=0):
        super().__init__()
        self.num_style_feat = num_style_feat
        self.noise_seed = noise_seed
        self._noise_generators = {}
        self.style_mlp = nn.Sequential(NormStyleCode(), *[
            EqualLinear(num_style_feat, num_style_feat, bias=True,
                        bias_init_val=0, lr_mul=lr_mlp,
                        activation='fused_lrelu') for _ in range(num_mlp)])
        ch = channels(narrow, channel_multiplier)
        self.constant_input = ConstantInput(ch['4'], size=4)
        self.style_conv1 = StyleConv(ch['4'], ch['4'], 3, num_style_feat,
                                     resample_kernel=resample_kernel)
        self.to_rgb1 = ToRGB(ch['4'], num_style_feat, upsample=False,
                             resample_kernel=resample_kernel)
        self.log_size = int(math.log(out_size, 2))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.num_latent = self.log_size * 2 - 2
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.noises = nn.Module()
        in_channels = ch['4']
        for i in range(self.num_layers):
            size = 2**((i + 5) // 2)
            self.noises.register_buffer(f'noise{i}',
                                        torch.zeros(1, 1, size, size))
        for i in range(3, self.log_size + 1):
            out_channels = ch[f'{2**i}']
            self.style_convs.append(StyleConv(
                in_channels, out_channels, 3, num_style_feat,
                sample_mode='upsample', resample_kernel=resample_kernel))
            self.style_convs.append(StyleConv(
                out_channels, out_channels, 3, num_style_feat,
                resample_kernel=resample_kernel))
            self.to_rgbs.append(ToRGB(out_channels, num_style_feat,
                                      upsample=True,
                                      resample_kernel=resample_kernel))
            in_channels = out_channels

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the JAX engine saves params only: its stored noises are zeros
        # whatever the seed (edvr_tpu/archs/stylegan2_arch.py's 'noises'
        # collection), as this network's buffers start; a state dict
        # without them loads them as zeros, a given one as it is
        for name, buf in self.noises.named_buffers():
            state_dict.setdefault(f'{prefix}noises.{name}',
                                  torch.zeros_like(buf))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def __getstate__(self):
        # a copy (deepcopy, pickle) starts its own noise generators afresh
        return dict(super().__getstate__(), _noise_generators={})

    def noise_generator(self, device):
        """The generator that noise is drawn from on ``device`` when none is
        given, seeded by ``noise_seed`` on its first use there."""
        device = torch.device(device)
        gen = self._noise_generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(self.noise_seed)
            self._noise_generators[device] = gen
        return gen

    def get_latent(self, x):
        return self.style_mlp(x)

    def mean_latent(self, num_latent, generator=None):
        """The mean latent of ``num_latent`` codes drawn from ``generator``
        on its own device (the network's noise generator when None)."""
        device = self.constant_input.weight.device
        if generator is None:
            generator = self.noise_generator(device)
        latent_in = torch.randn(num_latent, self.num_style_feat,
                                generator=generator,
                                device=generator.device).to(device)
        return self.style_mlp(latent_in).mean(0, keepdim=True)

    def forward(self, styles, input_is_latent=False, noise=None,
                randomize_noise=True, truncation=1, truncation_latent=None,
                inject_index=None, return_latents=False, generator=None):
        """styles: a list of one or two (b, num_style_feat) codes, or of one
        (b, num_latent, num_style_feat) latent; two codes mix at an explicit
        ``inject_index``. ``noise``: a list of ``num_layers`` tensors (None
        entries drawn); without it, drawn noise or (``randomize_noise``
        False) the stored noises. Returns (image, latent or None)."""
        if not input_is_latent:
            styles = [self.style_mlp(s) for s in styles]
        if noise is None:
            if randomize_noise:
                noise = [None] * self.num_layers
            else:
                noise = [getattr(self.noises, f'noise{i}')
                         for i in range(self.num_layers)]
        if truncation < 1:
            styles = [truncation_latent + truncation * (s - truncation_latent)
                      for s in styles]
        if len(styles) == 1:
            latent = styles[0]
            if latent.ndim < 3:
                latent = latent[:, None].repeat(1, self.num_latent, 1)
        elif len(styles) == 2:
            if inject_index is None:
                raise ValueError('style mixing needs an explicit '
                                 'inject_index')
            latent = torch.cat([
                styles[0][:, None].repeat(1, inject_index, 1),
                styles[1][:, None].repeat(1, self.num_latent - inject_index,
                                          1)], 1)
        else:
            raise ValueError(f'{len(styles)} styles; one or two are mixed')
        if generator is None and any(n is None for n in noise):
            generator = self.noise_generator(latent.device)

        out = self.constant_input(latent.shape[0])
        out = self.style_conv1(out, latent[:, 0], noise[0], generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            out = self.style_convs[2 * idx](out, latent[:, i],
                                            noise[1 + 2 * idx], generator)
            out = self.style_convs[2 * idx + 1](out, latent[:, i + 1],
                                                noise[2 + 2 * idx], generator)
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip, (latent if return_latents else None)


class ScaledLeakyReLU(nn.Module):
    """(reference: stylegan2_arch.py:661-674)"""

    def __init__(self, negative_slope=0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope) * math.sqrt(2)


class EqualConv2d(nn.Module):
    """(reference: stylegan2_arch.py:677-732)"""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, bias_init_val=0.):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.scale = 1 / math.sqrt(in_channels * kernel_size**2)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               kernel_size, kernel_size))
        if bias:
            self.bias = nn.Parameter(torch.full((out_channels,),
                                                float(bias_init_val)))
        else:
            self.register_parameter('bias', None)

    def forward(self, x):
        return conv_grad.conv2d(x, self.weight * self.scale, self.bias,
                                self.stride, self.padding)


class UpFirDnSmooth(nn.Module):
    """The smoothing before a stride-2 convolution, as a layer of
    :class:`ConvLayer` (no state-dict entry)."""

    def __init__(self, resample_kernel, kernel_size):
        super().__init__()
        self.kernel_size = kernel_size
        self.register_buffer('kernel', make_resample_kernel(resample_kernel),
                             persistent=False)

    def forward(self, x):
        return upfirdn_smooth(x, self.kernel, downsample_factor=2,
                              kernel_size=self.kernel_size)


class ConvLayer(nn.Sequential):
    """[smoothing], EqualConv2d, [activation] (reference:
    stylegan2_arch.py:735-790); the Sequential's indices are BasicSR's
    state-dict keys."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 downsample=False, resample_kernel=(1, 3, 3, 1), bias=True,
                 activate=True):
        layers = []
        if downsample:
            layers.append(UpFirDnSmooth(resample_kernel, kernel_size))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channels, out_channels, kernel_size,
                                  stride=stride, padding=padding,
                                  bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channels) if bias else
                          ScaledLeakyReLU(0.2))
        super().__init__(*layers)


class ResBlock(nn.Module):
    """(reference: stylegan2_arch.py:793-833)"""

    def __init__(self, in_channels, out_channels,
                 resample_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3)
        self.conv2 = ConvLayer(in_channels, out_channels, 3, downsample=True,
                               resample_kernel=resample_kernel)
        self.skip = ConvLayer(in_channels, out_channels, 1, downsample=True,
                              resample_kernel=resample_kernel, bias=False,
                              activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


@ARCH_REGISTRY.register()
class StyleGAN2Discriminator(nn.Module):
    """(reference: stylegan2_arch.py:836-924)"""

    def __init__(self, out_size, channel_multiplier=2,
                 resample_kernel=(1, 3, 3, 1), stddev_group=4, narrow=1):
        super().__init__()
        ch = channels(narrow, channel_multiplier)
        log_size = int(math.log(out_size, 2))
        body = [ConvLayer(3, ch[f'{out_size}'], 1)]
        in_channels = ch[f'{out_size}']
        for i in range(log_size, 2, -1):
            out_channels = ch[f'{2**(i - 1)}']
            body.append(ResBlock(in_channels, out_channels, resample_kernel))
            in_channels = out_channels
        self.conv_body = nn.Sequential(*body)
        self.final_conv = ConvLayer(in_channels + 1, ch['4'], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(ch['4'] * 4 * 4, ch['4'], bias=True,
                        activation='fused_lrelu'),
            EqualLinear(ch['4'], 1, bias=True, activation=None))
        self.stddev_group = stddev_group

    def forward(self, x):
        out = self.conv_body(x)
        b, c, h, w = out.shape
        # minibatch stddev (reference: stylegan2_arch.py:908-918): the
        # population std over each group column, averaged over (c, h, w)
        group = min(b, self.stddev_group)
        stddev = out.view(group, -1, c, h, w)
        stddev = torch.sqrt(stddev.var(0, unbiased=False) + 1e-8)
        stddev = stddev.mean((1, 2, 3)).view(-1, 1, 1, 1)
        stddev = stddev.repeat(group, 1, h, w)
        out = self.final_conv(torch.cat([out, stddev], 1))
        return self.final_linear(out.view(b, -1))
