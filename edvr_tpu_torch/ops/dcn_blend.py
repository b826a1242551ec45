"""Fused blend + tap-concatenation GEMM of the packed DCN route:
``out_prev + (g_cat * repeat_interleave(cs_cat, c_per, 1)) @ wexp_g``.

The counterpart of ``edvr_tpu/ops/dcn_pallas.py`` (``blend_matmul_group``
and its custom VJP ``blend_matmul_group_ad``). One deformable group's K
gathered tiles arrive lane-concatenated as ``g_cat`` (NP, K*lanes); the
compact per-slot bilinear coefficients ``cs_cat`` (NP, K*slots), slots =
lanes / c_per, are expanded over the c_per channels of each slot,
multiplied in, and contracted with the slot-tiled weights ``wexp_g``
(K*lanes, cout) into the (NP, cout) accumulator. On a CUDA tensor the
forward is the hand-written kernel ``edvr_tpu_torch/csrc/blend_matmul.cu``;
on a CPU tensor its plain version. The backward is the JAX ``_bm_bwd`` in
torch ops, as JAX computes it in XLA outside the Pallas kernel.
"""

from __future__ import annotations

import torch

from edvr_tpu_torch import native


def blend_matmul_group_plain(g_cat, cs_cat, wexp_g, out_prev, c_per):
    """Plain PyTorch version of the forward (any device)."""
    return out_prev + (g_cat * cs_cat.repeat_interleave(c_per, 1)) @ wexp_g


def blend_matmul_cuda(g_cat, cs_cat, wexp_g, out_prev, c_per):
    """The forward through the CUDA kernel (float32, no autograd; c_per in
    {1, 2, 4, 8, 16, 32} and a width that is a multiple of 4). Raises on
    any input the kernel does not take."""
    tensors = {'g_cat': g_cat, 'cs_cat': cs_cat, 'wexp_g': wexp_g,
               'out_prev': out_prev}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != g_cat.device:
            raise ValueError(f'blend_matmul: {name} must lie on '
                             f'{g_cat.device} (a CUDA device), got '
                             f'{t.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'blend_matmul: {name} must be float32, got '
                            f'{t.dtype}')
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f'blend_matmul: {name} must be a contiguous '
                             f'matrix, got shape {tuple(t.shape)}')
    NP, width = g_cat.shape
    cout = wexp_g.shape[1]
    if c_per not in (1, 2, 4, 8, 16, 32) or width % 4:
        raise ValueError(f'blend_matmul: c_per {c_per} must be 1, 2, 4, 8, '
                         f'16 or 32 and the width {width} a multiple of 4')
    if (cs_cat.shape != (NP, width // c_per) or width % c_per
            or wexp_g.shape != (width, cout)
            or out_prev.shape != (NP, cout)):
        raise ValueError(
            f'blend_matmul: shapes g_cat {tuple(g_cat.shape)}, cs_cat '
            f'{tuple(cs_cat.shape)}, wexp_g {tuple(wexp_g.shape)}, out_prev '
            f'{tuple(out_prev.shape)} do not fit c_per {c_per}')
    if g_cat.data_ptr() % 16:
        raise ValueError('blend_matmul: g_cat must be 16-byte aligned')

    fn = native.load('blend_matmul')
    out = torch.empty_like(out_prev)
    with torch.cuda.device(g_cat.device):
        stream = torch.cuda.current_stream(g_cat.device).cuda_stream
        err = fn(g_cat.data_ptr(), cs_cat.data_ptr(), wexp_g.data_ptr(),
                 out_prev.data_ptr(), out.data_ptr(), NP, width, cout, c_per,
                 stream)
    native.check('blend_matmul', err)
    native.LAUNCHES['blend_matmul'] += 1
    return out


class BlendMatmulGroupFunction(torch.autograd.Function):
    """``blend_matmul_group_ad``: the kernel (or, on a CPU tensor, its plain
    version) forward; the backward of ``dcn_pallas.py:120-132`` in torch
    ops: ``d_g``, ``d_cs`` summed over each slot's c_per channels, ``d_w``,
    and ``dout`` as the gradient of ``out_prev``."""

    @staticmethod
    def forward(ctx, g_cat, cs_cat, wexp_g, out_prev, c_per):
        ctx.c_per = c_per
        ctx.save_for_backward(g_cat, cs_cat, wexp_g)
        if g_cat.is_cuda:
            return blend_matmul_cuda(g_cat, cs_cat, wexp_g, out_prev, c_per)
        if g_cat.device.type != 'cpu':
            raise ValueError(f'blend_matmul: unsupported device '
                             f'{g_cat.device}')
        return blend_matmul_group_plain(g_cat, cs_cat, wexp_g, out_prev,
                                        c_per)

    @staticmethod
    def backward(ctx, dout):
        g_cat, cs_cat, wexp_g = ctx.saved_tensors
        c_per = ctx.c_per
        need_g, need_cs, need_w = ctx.needs_input_grad[:3]
        cs_full = cs_cat.repeat_interleave(c_per, 1)
        d_g = d_cs = d_w = None
        if need_g or need_cs:
            gw = dout @ wexp_g.t()  # (NP, width)
            if need_g:
                d_g = gw * cs_full
            if need_cs:
                d_cs = (gw * g_cat).view(g_cat.shape[0], -1, c_per).sum(-1)
            del gw
        if need_w:
            d_w = (g_cat * cs_full).t() @ dout
        return d_g, d_cs, d_w, dout, None


def blend_matmul_group(g_cat, cs_cat, wexp_g, out_prev, c_per):
    """Differentiable ``out_prev + (g_cat * expand(cs_cat)) @ wexp_g``,
    dispatched on the device of ``g_cat``."""
    return BlendMatmulGroupFunction.apply(g_cat, cs_cat, wexp_g, out_prev,
                                          c_per)
