"""Ablation variants of the DCNv2 forward kernel (dev tooling).

The port of ``scripts/dev/ablate_band.py::build_variant``, the TPU tool
that strips components of the band forward to attribute its time. Here
each variant is a compile-time mode of the shipped kernel
(``csrc/dcn_fwd.cu``, ``MODE``), launched through ``dcn_fwd_ablate_f32`` or
``dcn_fwd_ablate_bf16`` and counted per variant in ``native.LAUNCHES``
(``dcn_fwd_ablate_<mode>_<f32|bf16>``), so it shares every line it keeps
with the kernel that ``modulated_deform_conv`` runs. The variants are
never reachable from ``modulated_deform_conv``; ``python -m
edvr_tpu_torch.tools.ablate_dcn`` times them.

Each variant computes a stated function, inexact as a DCN, whose plain
PyTorch version is below, next to the wrapper (NCHW in and out, the
arguments of :func:`~edvr_tpu_torch.ops.dcn.modulated_deform_conv_plain`;
per (group, tap, pixel) the sample coordinate is (cy, cx) with floor
(y0, x0), fractions (fy, fx), row and column validities vy0, vy1, vx0,
vx1 and mask m):

* ``full``: DCNv2, the shipped kernel (its plain version is
  ``modulated_deform_conv_plain``);
* ``no_coef``: sum_k W_k . (the sum of the four corners clamped into the
  image): no coefficients, no mask, no validity;
* ``int_coef``: sum_k W_k . (the floor corner x vy0 x vx0 x m): one corner;
* ``no_gather``: the ``full`` function with x == 1 (x is never read);
* ``coords_only``: per pixel, the sum over groups and taps of wy0 + wy1 +
  wx0 + wx1 + y0 + x0 (wy0 = (1 - fy) vy0 m, wy1 = fy vy1 m, wx0 = (1 -
  fx) vx0, wx1 = fx vx1), on every output channel; no loads of x, no
  contraction;
* ``io_only``: per pixel, the sum over groups and taps of dy + dx + m, on
  every output channel.

Every variant adds the bias as ``full`` does; in bfloat16 the output is
rounded to bfloat16 before it. Identities that tie each plain version to
the full one on a chosen input are held in ``tests/test_torch_ablate.py``.
"""

from __future__ import annotations

import torch

from edvr_tpu_torch import native
from edvr_tpu_torch.ops import dcn

# the kernel's MODE of each variant (csrc/dcn_fwd.cu, enum Mode)
MODES = {mode: i for i, mode in enumerate(native.ABLATE_MODES)}
_DTYPE_NAMES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def _geometry(offset, mask, x, weight, stride, padding, dilation, dg):
    """Per (n, dg, K, oh, ow): the fields and the sample geometry in float32
    (or wider), as the kernel computes them."""
    n, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    K = kh * kw
    oh = dcn._out_size(h, kh, stride, padding, dilation)
    ow = dcn._out_size(w, kw, stride, padding, dilation)
    ct = torch.promote_types(offset.dtype, torch.float32)
    dev = x.device
    taps = torch.arange(K, device=dev)
    base_y = ((torch.arange(oh, device=dev) * stride - padding).view(
        1, 1, 1, oh, 1) + ((taps // kw) * dilation).view(1, 1, K, 1, 1)
              ).to(ct)
    base_x = ((torch.arange(ow, device=dev) * stride - padding).view(
        1, 1, 1, 1, ow) + ((taps % kw) * dilation).view(1, 1, K, 1, 1)
              ).to(ct)
    off = offset.reshape(n, dg, K, 2, oh, ow).to(ct)
    dy, dx = off[:, :, :, 0], off[:, :, :, 1]
    m = mask.reshape(n, dg, K, oh, ow).to(ct)
    cy, cx = base_y + dy, base_x + dx
    y0, x0 = torch.floor(cy), torch.floor(cx)
    return dict(dy=dy, dx=dx, m=m, y0=y0, x0=x0, fy=cy - y0, fx=cx - x0,
                vy0=((y0 >= 0) & (y0 <= h - 1)).to(ct),
                vy1=((y0 >= -1) & (y0 <= h - 2)).to(ct),
                vx0=((x0 >= 0) & (x0 <= w - 1)).to(ct),
                vx1=((x0 >= -1) & (x0 <= w - 2)).to(ct), oh=oh, ow=ow)


def _corner(x, yi, xi, dg):
    """x's channels of each group at integer-valued (yi, xi), clamped into
    the image: (n, dg, K, c_per, oh, ow)."""
    n, cin, h, w = x.shape
    _, _, K, oh, ow = yi.shape
    c_per = cin // dg
    idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
    idx = idx.view(n, dg, 1, K * oh * ow).expand(n, dg, c_per, K * oh * ow)
    vals = torch.gather(x.reshape(n, dg, c_per, h * w), 3, idx)
    return vals.view(n, dg, c_per, K, oh, ow).transpose(2, 3)


def _finish(acc, x, weight, bias):
    """(n, cout, oh, ow) float32 -> x's dtype, then the bias."""
    out = acc.to(x.dtype)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


def _contract(col, x, weight, bias, dg):
    """sum over (g, k, c) of W[o, g*c_per + c, k] col[n, g, k, c, p] in
    float32."""
    cout, cin, kh, kw = weight.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    wk = weight.to(acc).reshape(cout, dg, cin // dg, kh * kw)
    return _finish(torch.einsum('ngkcyx,ogck->noyx', col.to(acc), wk), x,
                   weight, bias)


def _broadcast(val, x, weight, bias):
    """(n, dg, K, oh, ow) per-pixel values summed over groups and taps, on
    every output channel."""
    s = val.sum((1, 2))
    return _finish(s.unsqueeze(1).expand(-1, weight.shape[0], -1, -1), x,
                   weight, bias)


def ablate_plain(mode, x, offset, mask, weight, bias=None, stride=1,
                 padding=0, dilation=1, deformable_groups=1):
    """The plain PyTorch version of variant ``mode`` (any device)."""
    dg = deformable_groups
    if mode == 'full':
        return dcn.modulated_deform_conv_plain(x, offset, mask, weight, bias,
                                               stride, padding, dilation, 1,
                                               dg)
    geo = _geometry(offset, mask, x, weight, stride, padding, dilation, dg)
    low = x.dtype == torch.bfloat16
    acc = torch.promote_types(x.dtype, torch.float32)
    if mode == 'no_coef':
        col = sum(_corner(x, geo['y0'] + a, geo['x0'] + b, dg).to(acc)
                  for a, b in ((0, 0), (0, 1), (1, 0), (1, 1)))
        return _contract(col, x, weight, bias, dg)
    if mode == 'int_coef':
        coef = (geo['vy0'] * geo['m']) * geo['vx0']
        vals = _corner(x, geo['y0'], geo['x0'], dg)
        if low:
            col = (vals * coef.to(x.dtype).unsqueeze(3)).to(acc)
        else:
            col = vals * coef.unsqueeze(3)
        return _contract(col, x, weight, bias, dg)
    if mode == 'no_gather':
        wy = ((1 - geo['fy']) * geo['vy0'], geo['fy'] * geo['vy1'])
        wx = ((1 - geo['fx']) * geo['vx0'], geo['fx'] * geo['vx1'])
        if low:
            col = sum(((wy[a] * geo['m']) * wx[b]).to(x.dtype).to(acc)
                      for a in (0, 1) for b in (0, 1))
        else:
            col = sum(wy[a] * wx[b] for a in (0, 1) for b in (0, 1))
            col = col * geo['m']
        c_per = x.shape[1] // dg
        col = col.unsqueeze(3).expand(-1, -1, -1, c_per, -1, -1)
        return _contract(col, x, weight, bias, dg)
    if mode == 'coords_only':
        val = ((1 - geo['fy']) * geo['vy0'] * geo['m']
               + geo['fy'] * geo['vy1'] * geo['m']
               + (1 - geo['fx']) * geo['vx0'] + geo['fx'] * geo['vx1']
               + geo['y0'] + geo['x0'])
        return _broadcast(val, x, weight, bias)
    if mode == 'io_only':
        return _broadcast(geo['dy'] + geo['dx'] + geo['m'], x, weight, bias)
    raise ValueError(f'unknown ablation variant {mode!r}; one of '
                     f'{sorted(MODES)}')


def ablate_cuda(mode, x, offset, mask, weight, bias=None, stride=1,
                padding=0, dilation=1, deformable_groups=1):
    """Variant ``mode`` through the kernel (CUDA tensors, float32 or
    bfloat16, groups=1; no autograd). Raises on any input the kernel does
    not take."""
    if mode not in MODES:
        raise ValueError(f'unknown ablation variant {mode!r}; one of '
                         f'{sorted(MODES)}')
    tensors = {'x': x, 'offset': offset, 'mask': mask, 'weight': weight}
    if bias is not None:
        tensors['bias'] = bias
    n, cin, h, w, cout, kh, kw, oh, ow = dcn._check_cuda_args(
        'dcn_fwd_ablate', tensors, x, offset, mask, weight, bias, stride,
        padding, dilation, deformable_groups)
    dname = _DTYPE_NAMES[x.dtype]
    entry = f'dcn_fwd_ablate_{dname}'
    fn = native.load(entry)
    x_cl = dcn._fwd_x(x, deformable_groups)
    wt = dcn._kernel_weight(weight, deformable_groups)
    bias_c = bias.contiguous() if bias is not None else None
    out = torch.empty(n, cout, oh, ow, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x_cl.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                 wt.data_ptr(),
                 bias_c.data_ptr() if bias_c is not None else None,
                 out.data_ptr(), n, h, w, cin, cout, oh, ow, kh, kw, stride,
                 padding, dilation, deformable_groups, MODES[mode], stream)
    native.check(entry, err)
    native.LAUNCHES[f'dcn_fwd_ablate_{mode}_{dname}'] += 1
    return out
