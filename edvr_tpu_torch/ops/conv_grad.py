"""2-D convolutions whose gradients are convolutions again, for second-order
autograd (StyleGAN2's R1 and path-length regularisers).

``F.conv2d`` and ``F.conv_transpose2d`` differentiate once through
cuDNN's data- and weight-gradient kernels, but a second time through
PyTorch's generic ``_convolution_double_backward``, which computes the
weight-gradient term as a forward convolution with the batch and channel
axes swapped: a kernel the size of the output map. On an H100 80GB HBM3
at 700 W that took ~1.5 s a call at StyleGAN2's 256 px discriminator, 23
of the 24 s of an R1 iteration at batch 24 (``python -m
edvr_tpu_torch.tools.stylegan2 --profile``; PERF.md). Here each
convolution is an ``autograd.Function`` whose backward calls the same
functions: the input gradient is the transposed operation with the same
weight, the weight gradient is a second Function (cuDNN's weight-gradient
kernel through ``aten.convolution_backward``) whose own backward is again
two convolutions. Every order of derivative then runs on cuDNN's forward,
data-gradient and weight-gradient kernels. The forward is ``F.conv2d`` /
``F.conv_transpose2d`` itself, so outputs are bitwise the same; with
autograd off (sampling, FID) the functions call those directly.
"""

from __future__ import annotations

import functools

import torch
from torch.nn import functional as F


def conv2d(x, weight, bias=None, stride=1, padding=0, groups=1):
    """``F.conv2d`` (no dilation) with convolutions as its gradients."""
    if not torch.is_grad_enabled():  # nothing to differentiate
        return F.conv2d(x, weight, bias, stride, padding, 1, groups)
    op = _op(False, tuple(weight.shape), _pair(stride), _pair(padding),
             (0, 0), groups)
    return op.apply(x, weight, bias)


def conv_transpose2d(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1):
    """``F.conv_transpose2d`` (no dilation) with convolutions as its
    gradients."""
    if not torch.is_grad_enabled():
        return F.conv_transpose2d(x, weight, bias, stride, padding,
                                  output_padding, groups)
    op = _op(True, tuple(weight.shape), _pair(stride), _pair(padding),
             _pair(output_padding), groups)
    return op.apply(x, weight, bias)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@functools.lru_cache(maxsize=None)
def _op(transposed, weight_shape, stride, padding, output_padding, groups):
    """The Function of one convolution's geometry (cached, so that a
    network's convolutions share classes)."""
    kh, kw = weight_shape[2:]

    def run(x, w, b):
        if transposed:
            return F.conv_transpose2d(x, w, b, stride, padding,
                                      output_padding, groups)
        return F.conv2d(x, w, b, stride, padding, 1, groups)

    def input_grad_op(x_shape, g_shape):
        """The operation that maps an output gradient of ``g_shape`` onto
        an input of ``x_shape`` with the same weight."""
        if transposed:
            return _op(False, weight_shape, stride, padding, (0, 0), groups)
        op_pad = tuple(
            x_shape[i + 2] - ((g_shape[i + 2] - 1) * stride[i]
                              - 2 * padding[i] + (k - 1) + 1)
            for i, k in enumerate((kh, kw)))
        return _op(True, weight_shape, stride, padding, op_pad, groups)

    class Conv(torch.autograd.Function):

        @staticmethod
        def forward(ctx, x, w, b):
            ctx.save_for_backward(x, w)
            ctx.has_bias = b is not None
            return run(x, w, b)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            gx = gw = gb = None
            if ctx.needs_input_grad[0]:
                gx = input_grad_op(tuple(x.shape), tuple(g.shape)).apply(
                    g, w, None)
            if ctx.needs_input_grad[1]:
                gw = WeightGrad.apply(g, x)
            if ctx.has_bias and ctx.needs_input_grad[2]:
                gb = g.sum((0, 2, 3))
            return gx, gw, gb

    class WeightGrad(torch.autograd.Function):
        """The weight gradient of this convolution, bilinear in (output
        gradient, input)."""

        @staticmethod
        def forward(ctx, g, x):
            ctx.save_for_backward(g, x)
            empty = x.new_empty(weight_shape)
            return torch.ops.aten.convolution_backward(
                g, x, empty, None, list(stride), list(padding), [1, 1],
                transposed, list(output_padding), groups,
                [False, True, False])[1]

        @staticmethod
        def backward(ctx, gg):
            g, x = ctx.saved_tensors
            g_g = g_x = None
            if ctx.needs_input_grad[0]:  # <g, conv(x, w)> is linear in w
                g_g = Conv.apply(x, gg, None)
            if ctx.needs_input_grad[1]:
                g_x = input_grad_op(tuple(x.shape), tuple(g.shape)).apply(
                    g, gg, None)
            return g_g, g_x

    return Conv
