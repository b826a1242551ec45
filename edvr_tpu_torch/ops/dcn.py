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
takes the plain PyTorch version, a CUDA tensor the hand-written kernel
(``edvr_tpu_torch/csrc/dcn_fwd.cu``), which raises rather than fall back.
"""

from __future__ import annotations

import torch

from edvr_tpu_torch import native

# launches of each kernel of this module, counted where the kernel is
# launched; a caller resets them to check that a path went through it
LAUNCHES = {'dcn_fwd': 0}


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


def dcn_fwd_cuda(x, offset, mask, weight, bias=None, stride=1, padding=0,
                 dilation=1, deformable_groups=1):
    """DCNv2 forward through the CUDA kernel (fp32, groups=1, no autograd).

    Same arguments and result as :func:`modulated_deform_conv_plain`.
    Raises on any input the kernel does not take.
    """
    tensors = {'x': x, 'offset': offset, 'mask': mask, 'weight': weight}
    if bias is not None:
        tensors['bias'] = bias
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f'dcn_fwd: {name} must lie on {x.device} '
                             f'(a CUDA device), got {t.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'dcn_fwd: {name} must be float32, got '
                            f'{t.dtype}')
    n, cin, h, w = x.shape
    cout, cin_w, kh, kw = weight.shape
    dg = deformable_groups
    K = kh * kw
    oh = _out_size(h, kh, stride, padding, dilation)
    ow = _out_size(w, kw, stride, padding, dilation)
    if cin_w != cin:
        raise ValueError(f'dcn_fwd: groups must be 1 (weight takes {cin_w} '
                         f'of {cin} input channels)')
    if cin % dg or cin // dg not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f'dcn_fwd: cin/dg = {cin}/{dg} must be 1, 2, 4, 8, '
                         '16 or 32')
    if offset.shape != (n, dg * 2 * K, oh, ow):
        raise ValueError(f'dcn_fwd: offset shape {tuple(offset.shape)} != '
                         f'{(n, dg * 2 * K, oh, ow)}')
    if mask.shape != (n, dg * K, oh, ow):
        raise ValueError(f'dcn_fwd: mask shape {tuple(mask.shape)} != '
                         f'{(n, dg * K, oh, ow)}')
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f'dcn_fwd: bias shape {tuple(bias.shape)} != '
                         f'{(cout,)}')
    if not (offset.is_contiguous() and mask.is_contiguous()):
        raise ValueError('dcn_fwd: offset and mask must be contiguous')
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise RuntimeError('dcn_fwd: the CUDA kernel has no backward yet; '
                           'call it under torch.no_grad()')

    fn = native.load('dcn_fwd')
    # the kernel reads x channels-last (one contiguous read per corner) and
    # the weights as (dg, K, c_per, cout) slices
    x_cl = x.permute(0, 2, 3, 1).contiguous()
    wt = weight.reshape(cout, dg, cin // dg, K).permute(1, 3, 2, 0)
    wt = wt.contiguous()
    bias_c = bias.contiguous() if bias is not None else None
    out = torch.empty(n, cout, oh, ow, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x_cl.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                 wt.data_ptr(),
                 bias_c.data_ptr() if bias_c is not None else None,
                 out.data_ptr(), n, h, w, cin, cout, oh, ow, kh, kw, stride,
                 padding, dilation, dg, stream)
    native.check('dcn_fwd', err)
    LAUNCHES['dcn_fwd'] += 1
    return out


def modulated_deform_conv(x, offset, mask, weight, bias=None, stride=1,
                          padding=0, dilation=1, groups=1,
                          deformable_groups=1):
    """DCNv2 forward, dispatched on the device of ``x``.

    A CPU tensor takes :func:`modulated_deform_conv_plain`; a CUDA tensor
    takes :func:`dcn_fwd_cuda`, which launches the kernel or raises.
    """
    if x.is_cuda:
        return dcn_fwd_cuda(x, offset, mask, weight, bias, stride, padding,
                            dilation, deformable_groups)
    if x.device.type != 'cpu':
        raise ValueError(f'modulated_deform_conv: unsupported device '
                         f'{x.device}')
    return modulated_deform_conv_plain(x, offset, mask, weight, bias, stride,
                                       padding, dilation, groups,
                                       deformable_groups)
