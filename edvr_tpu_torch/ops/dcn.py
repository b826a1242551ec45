"""Modulated deformable convolution (DCNv2), NCHW.

Semantics of the reference CUDA extension, as in
``edvr_tpu/ops/dcn.py:1-17`` (there in NHWC):

* offset layout: channel ``g * 2K + 2k`` is the **y** offset and
  ``g * 2K + 2k + 1`` the **x** offset for deformable group ``g`` and
  kernel tap ``k = i * kw + j``;
* mask layout: channel ``g * K + k``, already sigmoided by the caller;
* sampling: bilinear with a per-tap zero boundary: corners outside the
  image contribute 0, so a tap wholly outside samples 0.

``modulated_deform_conv`` dispatches on the device of ``x``: a CPU tensor
takes the plain PyTorch version under autograd, a CUDA tensor the
hand-written kernels through an autograd Function (forward
``edvr_tpu_torch/csrc/dcn_fwd.cu``, backward ``csrc/dcn_bwd.cu``), which
raise rather than fall back.
"""

from __future__ import annotations

import torch

from edvr_tpu_torch import native

# launches of each kernel of this module, counted where the kernel is
# launched; a caller resets them to check that a path went through it
LAUNCHES = {'dcn_fwd': 0, 'dcn_bwd': 0}


def _out_size(size, k, stride, padding, dilation):
    return (size + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1


def modulated_deform_conv_plain(x, offset, mask, weight, bias=None,
                                stride=1, padding=0, dilation=1, groups=1,
                                deformable_groups=1):
    """Plain PyTorch DCNv2 forward (any device; differentiable).

    Args:
        x: (n, cin, h, w).
        offset: (n, dg*2*K, out_h, out_w), interleaved (dy, dx) per tap.
        mask: (n, dg*K, out_h, out_w), in [0, 1].
        weight: (cout, cin // groups, kh, kw).
        bias: (cout,) or None.

    Returns:
        (n, cout, out_h, out_w).
    """
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    K = kh * kw
    dg = deformable_groups
    c_per = cin // dg
    oh = _out_size(h, kh, stride, padding, dilation)
    ow = _out_size(w, kw, stride, padding, dilation)
    P = oh * ow
    dt = x.dtype

    base_y = (torch.arange(oh, device=x.device, dtype=dt) * stride
              - padding).view(1, 1, oh, 1)
    base_x = (torch.arange(ow, device=x.device, dtype=dt) * stride
              - padding).view(1, 1, 1, ow)
    off = offset.view(n, dg, K, 2, oh, ow)
    msk = mask.view(n, dg, K, P)
    xg = x.reshape(n, dg, c_per, h * w)
    wk = weight.view(groups, cout // groups, cin_g, K)

    out = x.new_zeros(n, groups, cout // groups, P)
    for k in range(K):
        i, j = divmod(k, kw)
        cy = (base_y + i * dilation) + off[:, :, k, 0]  # (n, dg, oh, ow)
        cx = (base_x + j * dilation) + off[:, :, k, 1]
        y0 = torch.floor(cy)
        x0 = torch.floor(cx)
        fy = cy - y0
        fx = cx - x0
        sampled = x.new_zeros(n, dg, c_per, P)
        for yi, xi, wgt in ((y0, x0, (1 - fy) * (1 - fx)),
                            (y0, x0 + 1, (1 - fy) * fx),
                            (y0 + 1, x0, fy * (1 - fx)),
                            (y0 + 1, x0 + 1, fy * fx)):
            # validity is decided on the float corner, before the clamp and
            # the integer conversion, so any offset magnitude stays exact
            valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            idx = idx.view(n, dg, 1, P).expand(n, dg, c_per, P)
            vals = torch.gather(xg, 3, idx)
            sampled = sampled + vals * (wgt * valid.to(dt)).view(
                n, dg, 1, P)
        sampled = sampled * msk[:, :, k].view(n, dg, 1, P)
        col = sampled.reshape(n, groups, cin_g, P)
        out = out + torch.einsum('ngcp,goc->ngop', col, wk[..., k])
    out = out.reshape(n, cout, oh, ow)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out




def _check_cuda_args(op, tensors, x, offset, mask, weight, bias, stride,
                     padding, dilation, deformable_groups):
    """Shape, device and dtype checks shared by the kernels' wrappers;
    returns (n, cin, h, w, cout, kh, kw, oh, ow)."""
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f'{op}: {name} must lie on {x.device} '
                             f'(a CUDA device), got {t.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'{op}: {name} must be float32, got {t.dtype}')
    n, cin, h, w = x.shape
    cout, cin_w, kh, kw = weight.shape
    dg = deformable_groups
    K = kh * kw
    oh = _out_size(h, kh, stride, padding, dilation)
    ow = _out_size(w, kw, stride, padding, dilation)
    if cin_w != cin:
        raise ValueError(f'{op}: groups must be 1 (weight takes {cin_w} of '
                         f'{cin} input channels)')
    if cin % dg or cin // dg not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f'{op}: cin/dg = {cin}/{dg} must be 1, 2, 4, 8, 16 '
                         'or 32')
    if offset.shape != (n, dg * 2 * K, oh, ow):
        raise ValueError(f'{op}: offset shape {tuple(offset.shape)} != '
                         f'{(n, dg * 2 * K, oh, ow)}')
    if mask.shape != (n, dg * K, oh, ow):
        raise ValueError(f'{op}: mask shape {tuple(mask.shape)} != '
                         f'{(n, dg * K, oh, ow)}')
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f'{op}: bias shape {tuple(bias.shape)} != '
                         f'{(cout,)}')
    if not (offset.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f'{op}: offset and mask must be contiguous')
    return n, cin, h, w, cout, kh, kw, oh, ow


def _kernel_weight(weight, dg):
    """(cout, cin, kh, kw) -> the kernels' (dg, K, c_per, cout) slices."""
    cout, cin, kh, kw = weight.shape
    return weight.reshape(cout, dg, cin // dg, kh * kw).permute(
        1, 3, 2, 0).contiguous()


def dcn_fwd_cuda(x, offset, mask, weight, bias=None, stride=1, padding=0,
                 dilation=1, deformable_groups=1):
    """DCNv2 forward through the CUDA kernel (fp32, groups=1, no autograd;
    :class:`ModulatedDeformConvFunction` gives it one).

    Same arguments and result as :func:`modulated_deform_conv_plain`.
    Raises on any input the kernel does not take.
    """
    tensors = {'x': x, 'offset': offset, 'mask': mask, 'weight': weight}
    if bias is not None:
        tensors['bias'] = bias
    n, cin, h, w, cout, kh, kw, oh, ow = _check_cuda_args(
        'dcn_fwd', tensors, x, offset, mask, weight, bias, stride, padding,
        dilation, deformable_groups)

    fn = native.load('dcn_fwd')
    # the kernel reads x channels-last (one contiguous read per corner) and
    # the weights as (dg, K, c_per, cout) slices
    x_cl = x.detach().permute(0, 2, 3, 1).contiguous()
    wt = _kernel_weight(weight.detach(), deformable_groups)
    bias_c = bias.detach().contiguous() if bias is not None else None
    out = torch.empty(n, cout, oh, ow, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x_cl.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                 wt.data_ptr(),
                 bias_c.data_ptr() if bias_c is not None else None,
                 out.data_ptr(), n, h, w, cin, cout, oh, ow, kh, kw, stride,
                 padding, dilation, deformable_groups, stream)
    native.check('dcn_fwd', err)
    LAUNCHES['dcn_fwd'] += 1
    return out


def dcn_bwd_cuda(dout, x, offset, mask, weight, stride=1, padding=0,
                 dilation=1, deformable_groups=1):
    """DCNv2 backward through the CUDA kernel (fp32, groups=1).

    Given the output cotangent ``dout`` of :func:`dcn_fwd_cuda` at these
    inputs, returns ``(dx, d_offset, d_mask, d_weight)``, the gradients
    that autograd through :func:`modulated_deform_conv_plain` gives (the
    bias gradient is ``dout.sum((0, 2, 3))``). ``dx`` is accumulated with
    atomics, so its low bits vary from run to run. Taps of 1x1 or 3x3
    only; raises on any input the kernel does not take.
    """
    tensors = {'dout': dout, 'x': x, 'offset': offset, 'mask': mask,
               'weight': weight}
    n, cin, h, w, cout, kh, kw, oh, ow = _check_cuda_args(
        'dcn_bwd', tensors, x, offset, mask, weight, None, stride, padding,
        dilation, deformable_groups)
    if kh * kw not in (1, 9):
        raise ValueError(f'dcn_bwd: {kh}x{kw} taps; the kernel takes 1x1 '
                         'and 3x3')
    if dout.shape != (n, cout, oh, ow):
        raise ValueError(f'dcn_bwd: dout shape {tuple(dout.shape)} != '
                         f'{(n, cout, oh, ow)}')

    fn = native.load('dcn_bwd')
    dg = deformable_groups
    c_per = cin // dg
    x_cl = x.detach().permute(0, 2, 3, 1).contiguous()
    wt = _kernel_weight(weight.detach(), dg)
    dout = dout.contiguous()
    dx_cl = torch.zeros_like(x_cl)
    d_offset = torch.empty_like(offset)
    d_mask = torch.empty_like(mask)
    # blocks of the weight-gradient launch: about eight per SM, each
    # walking its share of the pixel tiles into one partial
    tiles = n * -(-(oh * ow) // 64)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nb = max(1, min(tiles, -(-8 * sms // (dg * -(-cout // 64)))))
    partial = torch.empty(nb, dg, kh * kw * c_per, cout, device=x.device,
                          dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x_cl.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                 wt.data_ptr(), dout.data_ptr(), dx_cl.data_ptr(),
                 d_offset.data_ptr(), d_mask.data_ptr(), partial.data_ptr(),
                 nb, n, h, w, cin, cout, oh, ow, kh, kw, stride, padding,
                 dilation, dg, stream)
    native.check('dcn_bwd', err)
    LAUNCHES['dcn_bwd'] += 1
    # the second pass over the per-block partials, then (dg, K, c_per,
    # cout) back to (cout, cin, kh, kw)
    d_weight = partial.sum(0).view(dg, kh * kw, c_per, cout).permute(
        3, 0, 2, 1).reshape(cout, cin, kh, kw)
    return (dx_cl.permute(0, 3, 1, 2).contiguous(), d_offset, d_mask,
            d_weight)


class ModulatedDeformConvFunction(torch.autograd.Function):
    """DCNv2 on CUDA tensors: forward :func:`dcn_fwd_cuda`, backward
    :func:`dcn_bwd_cuda`; the bias gradient is reduced outside the kernel,
    as the JAX band path adds the bias outside its kernel too."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, stride, padding,
                dilation, deformable_groups):
        ctx.geo = (stride, padding, dilation, deformable_groups)
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, offset, mask, weight)
        return dcn_fwd_cuda(x, offset, mask, weight, bias, stride, padding,
                            dilation, deformable_groups)

    @staticmethod
    def backward(ctx, dout):
        x, offset, mask, weight = ctx.saved_tensors
        dx, d_offset, d_mask, d_weight = dcn_bwd_cuda(
            dout, x, offset, mask, weight, *ctx.geo)
        d_bias = dout.sum((0, 2, 3)) if ctx.has_bias else None
        return dx, d_offset, d_mask, d_weight, d_bias, None, None, None, None


def modulated_deform_conv(x, offset, mask, weight, bias=None, stride=1,
                          padding=0, dilation=1, groups=1,
                          deformable_groups=1):
    """DCNv2, dispatched on the device of ``x``.

    A CPU tensor takes :func:`modulated_deform_conv_plain` under plain
    autograd; a CUDA tensor takes :class:`ModulatedDeformConvFunction`,
    whose forward and backward launch the kernels or raise.
    """
    if x.is_cuda:  # groups=1 only: the kernels' checks refuse others
        return ModulatedDeformConvFunction.apply(
            x, offset, mask, weight, bias, stride, padding, dilation,
            deformable_groups)
    if x.device.type != 'cpu':
        raise ValueError(f'modulated_deform_conv: unsupported device '
                         f'{x.device}')
    return modulated_deform_conv_plain(x, offset, mask, weight, bias, stride,
                                       padding, dilation, groups,
                                       deformable_groups)
