"""Modulated deformable convolution (DCNv2), NCHW.

Semantics of the reference CUDA extension, as in
``edvr_tpu/ops/dcn.py:1-17`` (there in NHWC):

* offset layout: channel ``g * 2K + 2k`` is the **y** offset and
  ``g * 2K + 2k + 1`` the **x** offset for deformable group ``g`` and
  kernel tap ``k = i * kw + j``;
* mask layout: channel ``g * K + k``, already sigmoided by the caller;
* sampling: bilinear with a per-tap zero boundary: corners outside the
  image contribute 0, so a tap wholly outside samples 0;
* sample coordinates, fractions and validity in float32 (or wider) for
  every input dtype, as ``edvr_tpu/ops/dcn.py:467-481``; in bfloat16 the
  TPU kernel's rounding points (``edvr_tpu/ops/dcn_band.py:501-536``):
  each corner's coefficient, mask included, and each corner's product with
  the table value rounded to bfloat16, the contraction accumulated in
  float32 and the output cast to bfloat16 before the bias.

``modulated_deform_conv`` dispatches on the device of ``x``: a CPU tensor
takes the plain PyTorch version under autograd, a CUDA tensor the
hand-written kernels through an autograd Function (forward
``edvr_tpu_torch/csrc/dcn_fwd.cu``, backward ``csrc/dcn_bwd.cu``; float32
and bfloat16 entries), which raise rather than fall back or cast.

With ``EDVR_TPU_DCN_PALLAS=1``, the JAX package's switch, and a tile of at
least two pixels (``128 // (2 * c_per) >= 2``), it takes the packed route
instead (:func:`_mdcn_packed`, the gather branch of
``edvr_tpu/ops/dcn.py::_mdcn_packed``): one row gather
(``ops/gather.py``, ``csrc/row_gather.cu``) and one blend GEMM
(``ops/dcn_blend.py``, ``csrc/blend_matmul.cu``) per deformable group, on
either device; on a CUDA tensor it never launches ``dcn_fwd``/``dcn_bwd``.
In bfloat16 it takes the JAX route's bf16 rounding points and the blend
kernel's bf16 form (``blend_matmul_bf16``).

``EDVR_TPU_DCN_QUANT=int|half|quarter``, the JAX package's inference knob
(``edvr_tpu/ops/dcn.py:445-455``), rounds every offset to a 1, 1/2 or 1/4
px grid before either route or the plain version runs (half to even, as
``jnp.round``); its gradient through the rounding is zero.
"""

from __future__ import annotations

import os

import torch
from torch.nn import functional as F

from edvr_tpu_torch import native
from edvr_tpu_torch.ops.dcn_blend import blend_matmul_group
from edvr_tpu_torch.ops.gather import row_gather

# launches of every kernel of the port (``native.LAUNCHES``, the same
# dict), counted where each kernel is launched; a caller resets them to
# check that a path went through a kernel
LAUNCHES = native.LAUNCHES


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
    # bf16: band_forward's rounding points; coordinates in float32 at least
    low = dt == torch.bfloat16
    ct = torch.promote_types(offset.dtype, torch.float32)
    acc = torch.promote_types(dt, torch.float32)

    base_y = (torch.arange(oh, device=x.device, dtype=ct) * stride
              - padding).view(1, 1, oh, 1)
    base_x = (torch.arange(ow, device=x.device, dtype=ct) * stride
              - padding).view(1, 1, 1, ow)
    off = offset.view(n, dg, K, 2, oh, ow).to(ct)
    msk = mask.view(n, dg, K, P)
    xg = x.reshape(n, dg, c_per, h * w)
    wk = weight.view(groups, cout // groups, cin_g, K)

    out = x.new_zeros(n, groups, cout // groups, P, dtype=acc)
    for k in range(K):
        i, j = divmod(k, kw)
        cy = (base_y + i * dilation) + off[:, :, k, 0]  # (n, dg, oh, ow)
        cx = (base_x + j * dilation) + off[:, :, k, 1]
        y0 = torch.floor(cy)
        x0 = torch.floor(cx)
        fy = cy - y0
        fx = cx - x0
        mk = msk[:, :, k].view(n, dg, oh, ow).to(ct) if low else None
        sampled = x.new_zeros(n, dg, c_per, P, dtype=acc)
        if low:  # the row and column factors apart
            corners = ((y0, x0, (1 - fy, 1 - fx)), (y0, x0 + 1, (1 - fy, fx)),
                       (y0 + 1, x0, (fy, 1 - fx)), (y0 + 1, x0 + 1, (fy, fx)))
        else:
            corners = ((y0, x0, (1 - fy) * (1 - fx)),
                       (y0, x0 + 1, (1 - fy) * fx),
                       (y0 + 1, x0, fy * (1 - fx)),
                       (y0 + 1, x0 + 1, fy * fx))
        for yi, xi, wgt in corners:
            # validity is decided on the float corner, before the clamp and
            # the integer conversion, so any offset magnitude stays exact
            vy = (yi >= 0) & (yi <= h - 1)
            vx = (xi >= 0) & (xi <= w - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            idx = idx.view(n, dg, 1, P).expand(n, dg, c_per, P)
            vals = torch.gather(xg, 3, idx)
            if low:
                # the coefficient (ay * bx, the mask inside ay) and the
                # per-corner product rounded to bf16, summed in float32
                wy, wx = wgt
                coef = ((wy * vy.to(ct) * mk) * (wx * vx.to(ct))).to(dt)
                sampled = sampled + vals * coef.view(n, dg, 1, P)
            else:
                sampled = sampled + vals * (wgt * (vy & vx).to(dt)).view(
                    n, dg, 1, P)
        if not low:
            sampled = sampled * msk[:, :, k].view(n, dg, 1, P)
        col = sampled.reshape(n, groups, cin_g, P)
        out = out + torch.einsum('ngcp,goc->ngop', col,
                                 wk[..., k].to(acc))
    out = out.reshape(n, cout, oh, ow).to(dt)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


def _mdcn_packed(x, offset, mask, weight, bias, stride, padding, dilation,
                 groups, dg):
    """The packed-tile DCNv2 (``edvr_tpu/ops/dcn.py:560-836``, its gather
    branch with the blend kernel), NCHW in and out, float32 or bfloat16.

    Each group's input plane is re-laid into overlapping tiles of 2 rows x
    PX pixels x c_per channels (``lanes`` = 2*PX*c_per, 128 when 2*c_per
    divides 128), so one row of the tile table holds all four bilinear
    corners of a sample. Per tap the sample picks its tile row and the
    coefficients of its (row, pixel) slots; out-of-image corners fall
    outside the tile's slots or carry a zero validity, which is the per-tap
    zero boundary. Per deformable group, one row gather fetches the tiles of
    all K taps as ``g_cat`` (NP, K*lanes) and one blend GEMM contracts them
    with the tap weights tiled over the slots.

    The element type ``etype`` is x's (JAX's ``etype`` for a bf16 input,
    ``:590-599``): the tile table, the tiled weights, the fractions, the
    validities, the mask and the slot coefficients are in it, each product
    rounded as JAX rounds it; the sample coordinates are float32 at least,
    the accumulator float32, cast to x's dtype before the bias is added.
    """
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    K = kh * kw
    c_per = cin // dg
    PX = 128 // (2 * c_per)        # pixels per tile row
    SX = PX - 1                    # tile stride (tiles overlap by 1 pixel)
    tiles_x = (w - 1) // SX + 1
    lanes = 2 * PX * c_per
    oh = _out_size(h, kh, stride, padding, dilation)
    ow = _out_size(w, kw, stride, padding, dilation)
    P = oh * ow
    NP = n * P
    dt, dev = x.dtype, x.device  # dt is JAX's etype
    ct = torch.promote_types(offset.dtype, torch.float32)

    # tile table (:706-728): tile t holds columns t*SX .. t*SX+PX-1 (zero
    # beyond w) of an image row (r=0) and of the row below it (r=1, zero
    # under the last row); rows (n, dg, h, tiles_x), lanes (r, px, c)
    tab = F.pad(x, (0, tiles_x * SX + 1 - w)).unfold(3, PX, SX)
    tab_dn = F.pad(tab[:, :, 1:], (0, 0, 0, 0, 0, 1))
    tab = torch.stack([tab, tab_dn], dim=4).view(
        n, dg, c_per, h, tiles_x, 2, PX).permute(0, 1, 3, 4, 5, 6, 2)
    tab = tab.reshape(n * dg * h * tiles_x, lanes)

    # weights tiled across the (row, pixel) slots (:605-614): wexp[k, g,
    # lane=(r, px, c), o], block-diagonal over the conv groups
    wk = weight.permute(2, 3, 1, 0).reshape(K, cin_g, cout)
    wfull = wk if groups == 1 else torch.stack([
        torch.block_diag(*wk[k].split(cout // groups, dim=1))
        for k in range(K)])
    wexp = wfull.view(K, dg, 1, c_per, cout).expand(
        K, dg, 2 * PX, c_per, cout).reshape(K, dg, lanes, cout).to(dt)

    # per tap (:729-805): sample coordinates (in ct), the tile row and the
    # slot coefficients (in dt), all groups and taps at once as (n, dg, K, P)
    base_y = (torch.arange(oh, device=dev, dtype=ct) * stride
              - padding).view(oh, 1).expand(oh, ow).reshape(1, 1, 1, P)
    base_x = (torch.arange(ow, device=dev, dtype=ct) * stride
              - padding).view(1, ow).expand(oh, ow).reshape(1, 1, 1, P)
    taps = torch.arange(K, device=dev)
    tap_y = ((taps // kw) * dilation).to(ct).view(1, 1, K, 1)
    tap_x = ((taps % kw) * dilation).to(ct).view(1, 1, K, 1)
    off = offset.reshape(n, dg, K, 2, P).to(ct)
    cy = (base_y + tap_y) + off[:, :, :, 0]
    cx = (base_x + tap_x) + off[:, :, :, 1]
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    fy = (cy - y0).to(dt)
    fx = (cx - x0).to(dt)
    # validity is decided on the float corner; the corners are clamped just
    # beyond the image before the integer conversion, which changes no
    # valid corner, so any offset magnitude stays exact
    vy0 = ((y0 >= 0) & (y0 <= h - 1)).to(dt)
    vy1 = ((y0 >= -1) & (y0 <= h - 2)).to(dt)
    vx0 = ((x0 >= 0) & (x0 <= w - 1)).to(dt)
    vx1 = ((x0 >= -1) & (x0 <= w - 2)).to(dt)
    y0i = y0.detach().clamp(-2, h).to(torch.int32)
    x0i = x0.detach().clamp(-2, w).to(torch.int32)
    ty = y0i.clamp(0, h - 1)
    tx = torch.div(x0i, SX, rounding_mode='floor').clamp(0, tiles_x - 1)
    row_base = ((torch.arange(n, device=dev, dtype=torch.int32) * dg).view(
        n, 1) + torch.arange(dg, device=dev, dtype=torch.int32)) * (
            h * tiles_x)
    row = ty * tiles_x + tx + row_base.view(n, dg, 1, 1)
    ry0 = (y0i - ty).unsqueeze(-1)
    px0 = (x0i - SX * tx).unsqueeze(-1)
    mg = mask.reshape(n, dg, K, P).to(dt)
    zero = torch.zeros((), device=dev, dtype=dt)
    slot_r = torch.arange(2, device=dev, dtype=torch.int32)
    slot_p = torch.arange(PX, device=dev, dtype=torch.int32)
    # the coefficient of slot (r, px) is the row factor of r times the
    # pixel factor of px, as the two jnp.where of :796-799 multiply
    coef_r = torch.where(slot_r == ry0, ((1 - fy) * vy0 * mg).unsqueeze(-1),
                         torch.where(slot_r == ry0 + 1,
                                     (fy * vy1 * mg).unsqueeze(-1), zero))
    coef_p = torch.where(slot_p == px0, ((1 - fx) * vx0).unsqueeze(-1),
                         torch.where(slot_p == px0 + 1,
                                     (fx * vx1).unsqueeze(-1), zero))

    # per deformable group: one gather over all K taps, laid out (NP, K)
    # so that the (NP*K, lanes) rows read as (NP, K*lanes), the
    # lane-concatenation of the taps; one blend GEMM into the accumulator
    out = x.new_zeros(NP, cout, dtype=torch.float32)
    for g in range(dg):
        idx = row[:, g].permute(0, 2, 1).reshape(-1)
        g_cat = row_gather(tab, idx).view(NP, K * lanes)
        cs_cat = (coef_r[:, g].permute(0, 2, 1, 3).unsqueeze(-1)
                  * coef_p[:, g].permute(0, 2, 1, 3).unsqueeze(-2)
                  ).reshape(NP, K * 2 * PX)
        wexp_g = wexp[:, g].reshape(K * lanes, cout)
        out = blend_matmul_group(g_cat, cs_cat, wexp_g, out, c_per)

    out = out.view(n, oh, ow, cout).to(dt).permute(0, 3, 1, 2).contiguous()
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


def _check_cuda_args(op, tensors, x, offset, mask, weight, bias, stride,
                     padding, dilation, deformable_groups):
    """Shape, device and dtype checks shared by the kernels' wrappers:
    every tensor on x's CUDA device, all float32 or all bfloat16 (the
    kernels' two element types; nothing is cast). Returns (n, cin, h, w,
    cout, kh, kw, oh, ow)."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f'{op}: x must be float32 or bfloat16, got {x.dtype}')
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f'{op}: {name} must lie on {x.device} '
                             f'(a CUDA device), got {t.device}')
        if t.dtype != x.dtype:
            raise TypeError(f'{op}: {name} is {t.dtype} but x is {x.dtype}; '
                            'the kernels take one dtype for all inputs')
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


# resident blocks per SM of the backward launch (csrc/dcn_bwd.cu asks for
# two at EDVR-M's c_per 8), so that its persistent blocks fill the card in
# one wave and its dW partials stay a few MB
BWD_BLOCKS_PER_SM = 2

# the kernels' element types, and the suffix of each one's entry name in
# native.SIGNATURES and LAUNCHES ('dcn_fwd' is the float32 forward)
KERNEL_DTYPES = {torch.float32: '', torch.bfloat16: '_bf16'}


def _kernel_weight(weight, dg):
    """(cout, cin, kh, kw) -> the kernels' (dg, K, c_per, cout) slices."""
    cout, cin, kh, kw = weight.shape
    return weight.reshape(cout, dg, cin // dg, kh * kw).permute(
        1, 3, 2, 0).contiguous()


# the forward kernel reads x group-major, (n, dg, h, w, c_per): a corner's
# c_per channels are contiguous and the corners of neighbouring pixels lie
# c_per elements apart, so a warp's gather touches few cache lines.
# tools/ab_kernels.py clears it to run an earlier dcn_fwd.cu, which reads
# x channels-last, (n, h, w, cin).
FWD_X_GROUP_MAJOR = True


def _fwd_x(x, dg):
    """x (n, cin, h, w) in the forward kernel's layout (a copy)."""
    n, cin, h, w = x.shape
    if FWD_X_GROUP_MAJOR:
        return x.detach().view(n, dg, cin // dg, h, w).permute(
            0, 1, 3, 4, 2).contiguous()
    return x.detach().permute(0, 2, 3, 1).contiguous()


def dcn_fwd_cuda(x, offset, mask, weight, bias=None, stride=1, padding=0,
                 dilation=1, deformable_groups=1):
    """DCNv2 forward through the CUDA kernel (float32 or bfloat16,
    groups=1, no autograd; :class:`ModulatedDeformConvFunction` gives it
    one).

    Same arguments and result as :func:`modulated_deform_conv_plain`, in
    the inputs' dtype: ``dcn_fwd_f32`` or ``dcn_fwd_bf16``, counted in
    ``LAUNCHES['dcn_fwd']`` or ``LAUNCHES['dcn_fwd_bf16']``. Raises on any
    input the kernel does not take.
    """
    tensors = {'x': x, 'offset': offset, 'mask': mask, 'weight': weight}
    if bias is not None:
        tensors['bias'] = bias
    n, cin, h, w, cout, kh, kw, oh, ow = _check_cuda_args(
        'dcn_fwd', tensors, x, offset, mask, weight, bias, stride, padding,
        dilation, deformable_groups)

    entry = 'dcn_fwd' + KERNEL_DTYPES[x.dtype]
    fn = native.load(entry)
    # the kernel reads x group-major (one contiguous read per corner) and
    # the weights as (dg, K, c_per, cout) slices
    x_cl = _fwd_x(x, deformable_groups)
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
    native.check(entry, err)
    LAUNCHES[entry] += 1
    return out


def dcn_bwd_cuda(dout, x, offset, mask, weight, stride=1, padding=0,
                 dilation=1, deformable_groups=1):
    """DCNv2 backward through the CUDA kernel (float32 or bfloat16,
    groups=1).

    Given the output cotangent ``dout`` of :func:`dcn_fwd_cuda` at these
    inputs, returns ``(dx, d_offset, d_mask, d_weight)``, the gradients
    that autograd through :func:`modulated_deform_conv_plain` gives (the
    bias gradient is ``dout.sum((0, 2, 3))``), each in its input's dtype.
    One launch computes all four (``dcn_bwd_f32`` or ``dcn_bwd_bf16``,
    counted once). In bfloat16 the kernel sums in float32: ``dx`` into a
    float32 buffer (bf16 atomics would lose the sum) and ``d_weight`` from
    float32 partials, both cast here. ``dx`` is accumulated with
    atomics, so its low bits vary from run to run. Any kh x kw: taps other
    than 3x3 and 1x1 run in chunks of at most 9 (blocks of the one launch,
    counted by ``csrc/dcn_bwd.cu``'s ``dcn_bwd_tap_chunks``), so the
    kernel's shared memory is that of 9 taps whatever the size. Raises on
    any input the kernel does not take.
    """
    tensors = {'dout': dout, 'x': x, 'offset': offset, 'mask': mask,
               'weight': weight}
    n, cin, h, w, cout, kh, kw, oh, ow = _check_cuda_args(
        'dcn_bwd', tensors, x, offset, mask, weight, None, stride, padding,
        dilation, deformable_groups)
    if dout.shape != (n, cout, oh, ow):
        raise ValueError(f'dcn_bwd: dout shape {tuple(dout.shape)} != '
                         f'{(n, cout, oh, ow)}')

    entry = 'dcn_bwd' + KERNEL_DTYPES[x.dtype]
    fn = native.load(entry)
    dg = deformable_groups
    c_per = cin // dg
    x_cl = x.detach().permute(0, 2, 3, 1).contiguous()
    wt = _kernel_weight(weight.detach(), dg)
    dout = dout.contiguous()
    dx_cl = torch.zeros(x_cl.shape, device=x.device, dtype=torch.float32)
    d_offset = torch.empty_like(offset)
    d_mask = torch.empty_like(mask)
    # blocks per (deformable group, tap chunk, 64 output channels):
    # BWD_BLOCKS_PER_SM per SM in all, each walking its share of the pixel
    # tiles into one partial
    tiles = n * -(-(oh * ow) // 64)
    chunks = native.load('dcn_bwd_tap_chunks')(kh, kw)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nb = max(1, min(tiles, -(-BWD_BLOCKS_PER_SM * sms
                             // (dg * chunks * -(-cout // 64)))))
    partial = torch.empty(nb, dg, kh * kw * c_per, cout, device=x.device,
                          dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x_cl.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                 wt.data_ptr(), dout.data_ptr(), dx_cl.data_ptr(),
                 d_offset.data_ptr(), d_mask.data_ptr(), partial.data_ptr(),
                 nb, n, h, w, cin, cout, oh, ow, kh, kw, stride, padding,
                 dilation, dg, stream)
    native.check(entry, err)
    LAUNCHES[entry] += 1
    # the second pass over the per-block partials, then (dg, K, c_per,
    # cout) back to (cout, cin, kh, kw)
    d_weight = partial.sum(0).view(dg, kh * kw, c_per, cout).permute(
        3, 0, 2, 1).reshape(cout, cin, kh, kw).to(weight.dtype)
    dx = dx_cl.permute(0, 3, 1, 2).to(x.dtype,
                                      memory_format=torch.contiguous_format)
    return dx, d_offset, d_mask, d_weight


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


# EDVR_TPU_DCN_QUANT's values and the grid each rounds the offsets to,
# in steps of 1 / denominator px
DCN_QUANT = {'int': 1.0, 'half': 2.0, 'quarter': 4.0}


def modulated_deform_conv(x, offset, mask, weight, bias=None, stride=1,
                          padding=0, dilation=1, groups=1,
                          deformable_groups=1):
    """DCNv2, dispatched on the device of ``x``.

    With ``EDVR_TPU_DCN_PALLAS=1`` and ``128 // (2 * c_per) >= 2`` (the
    JAX package's switch and condition, ``edvr_tpu/ops/dcn.py:461-465,
    616-627``) the packed route :func:`_mdcn_packed` runs, its gather and
    blend kernels on a CUDA tensor and their plain versions on a CPU one.
    Otherwise a CPU tensor takes :func:`modulated_deform_conv_plain` under
    plain autograd, and a CUDA tensor :class:`ModulatedDeformConvFunction`,
    whose forward and backward launch the kernels or raise. With
    ``EDVR_TPU_DCN_QUANT`` set, the offsets are first rounded to its grid
    (:data:`DCN_QUANT`; another value raises ``KeyError``).
    """
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'modulated_deform_conv: unsupported device '
                         f'{x.device}')
    quant = os.environ.get('EDVR_TPU_DCN_QUANT', '')
    if quant:
        denom = DCN_QUANT[quant]
        offset = torch.round(offset * denom) / denom
    c_per = x.shape[1] // deformable_groups
    if (os.environ.get('EDVR_TPU_DCN_PALLAS') == '1'
            and 128 // (2 * c_per) >= 2):
        return _mdcn_packed(x, offset, mask, weight, bias, stride, padding,
                            dilation, groups, deformable_groups)
    if x.is_cuda:  # groups=1 only: the kernels' checks refuse others
        return ModulatedDeformConvFunction.apply(
            x, offset, mask, weight, bias, stride, padding, dilation,
            deformable_groups)
    return modulated_deform_conv_plain(x, offset, mask, weight, bias, stride,
                                       padding, dilation, groups,
                                       deformable_groups)
