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

Two element types, as the TPU kernel's: ``g_cat``, ``cs_cat`` and
``wexp_g`` all float32 or all bfloat16; ``out_prev`` and the result are
float32 in both. In bfloat16 the blended strip is rounded to bfloat16 and
contracted with exact products summed in float32
(``preferred_element_type=jnp.float32``, ``dcn_pallas.py:70-75``).
"""

from __future__ import annotations

import torch

from edvr_tpu_torch import native


# the element types of g_cat, cs_cat and wexp_g, and each one's kernel
# entry (native.SIGNATURES, LAUNCHES)
ENTRIES = {torch.float32: 'blend_matmul', torch.bfloat16: 'blend_matmul_bf16'}


def check_dtypes(g_cat, cs_cat, wexp_g, out_prev):
    """Raise unless g_cat, cs_cat and wexp_g are all float32 or all
    bfloat16 and out_prev is float32 (nothing is cast)."""
    if g_cat.dtype not in ENTRIES:
        raise TypeError(f'blend_matmul: g_cat must be float32 or bfloat16, '
                        f'got {g_cat.dtype}')
    for name, t in (('cs_cat', cs_cat), ('wexp_g', wexp_g)):
        if t.dtype != g_cat.dtype:
            raise TypeError(f'blend_matmul: {name} is {t.dtype} but g_cat is '
                            f'{g_cat.dtype}; g_cat, cs_cat and wexp_g take '
                            'one dtype')
    if out_prev.dtype != torch.float32:
        raise TypeError(f'blend_matmul: out_prev must be float32 (the '
                        f'accumulator), got {out_prev.dtype}')


def blend_matmul_group_plain(g_cat, cs_cat, wexp_g, out_prev, c_per):
    """Plain PyTorch version of the forward (any device). In bfloat16 the
    blended strip is the bf16 product and the contraction runs in float32
    on its exact values: ``bf16 @ bf16`` would round the result to bf16,
    where the TPU kernel keeps it in float32."""
    blended = g_cat * cs_cat.repeat_interleave(c_per, 1)
    if blended.dtype == torch.bfloat16:
        return out_prev + blended.float() @ wexp_g.float()
    return out_prev + blended @ wexp_g


def blend_matmul_cuda(g_cat, cs_cat, wexp_g, out_prev, c_per):
    """The forward through the CUDA kernel (no autograd): float32
    operands by ``blend_matmul_f32`` (a width that is a multiple of 4),
    bfloat16 ones by ``blend_matmul_bf16`` (a width that is a multiple of
    8, an even count of slots), each counted in ``LAUNCHES`` under its
    entry; c_per in {1, 2, 4, 8, 16, 32}. Raises on any input the kernel
    does not take."""
    tensors = {'g_cat': g_cat, 'cs_cat': cs_cat, 'wexp_g': wexp_g,
               'out_prev': out_prev}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != g_cat.device:
            raise ValueError(f'blend_matmul: {name} must lie on '
                             f'{g_cat.device} (a CUDA device), got '
                             f'{t.device}')
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f'blend_matmul: {name} must be a contiguous '
                             f'matrix, got shape {tuple(t.shape)}')
    check_dtypes(g_cat, cs_cat, wexp_g, out_prev)
    low = g_cat.dtype == torch.bfloat16
    NP, width = g_cat.shape
    cout = wexp_g.shape[1]
    piece = 8 if low else 4  # elements of a 16-byte copy
    if c_per not in (1, 2, 4, 8, 16, 32) or width % piece:
        raise ValueError(f'blend_matmul: c_per {c_per} must be 1, 2, 4, 8, '
                         f'16 or 32 and the width {width} a multiple of '
                         f'{piece}')
    if (cs_cat.shape != (NP, width // c_per) or width % c_per
            or wexp_g.shape != (width, cout)
            or out_prev.shape != (NP, cout)):
        raise ValueError(
            f'blend_matmul: shapes g_cat {tuple(g_cat.shape)}, cs_cat '
            f'{tuple(cs_cat.shape)}, wexp_g {tuple(wexp_g.shape)}, out_prev '
            f'{tuple(out_prev.shape)} do not fit c_per {c_per}')
    if low and (width // c_per % 2 or cs_cat.data_ptr() % 4):
        raise ValueError('blend_matmul: bf16 coefficient rows must hold an '
                         'even count of slots, 4-byte aligned')
    if g_cat.data_ptr() % 16:
        raise ValueError('blend_matmul: g_cat must be 16-byte aligned')

    entry = ENTRIES[g_cat.dtype]
    fn = native.load(entry)
    out = torch.empty_like(out_prev)
    err = native.launch(fn, g_cat.device, g_cat.data_ptr(),
                        cs_cat.data_ptr(), wexp_g.data_ptr(),
                        out_prev.data_ptr(), out.data_ptr(), NP, width, cout,
                        c_per)
    native.check(entry, err)
    native.LAUNCHES[entry] += 1
    return out


class BlendMatmulGroupFunction(torch.autograd.Function):
    """``blend_matmul_group_ad``: the kernel (or, on a CPU tensor, its plain
    version) forward; the backward of ``dcn_pallas.py:119-132`` in torch
    ops, at its rounding points: ``gw = dout_e @ wexp_g^T`` in float32,
    ``d_g = e(gw * cs_full)``, ``d_cs`` summed over each slot's c_per
    channels in float32 then cast, ``d_w = e(e(g * cs_full)^T @ dout_e)``
    with float32 sums, and ``dout`` as the gradient of ``out_prev``, where
    ``e`` is the operands' dtype (a no-op in float32)."""

    @staticmethod
    def forward(ctx, g_cat, cs_cat, wexp_g, out_prev, c_per):
        check_dtypes(g_cat, cs_cat, wexp_g, out_prev)
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
        dt, f32 = g_cat.dtype, torch.float32
        need_g, need_cs, need_w = ctx.needs_input_grad[:3]
        cs_full = cs_cat.repeat_interleave(c_per, 1).to(f32)
        # dout in the operands' dtype, its products exact in float32
        dout_e = dout.to(dt).to(f32)
        d_g = d_cs = d_w = None
        if need_g or need_cs:
            gw = dout_e @ wexp_g.to(f32).t()  # (NP, width)
            if need_g:
                d_g = (gw * cs_full).to(dt)
            if need_cs:
                d_cs = (gw * g_cat.to(f32)).view(g_cat.shape[0], -1,
                                                 c_per).sum(-1).to(dt)
            del gw
        if need_w:
            blended = (g_cat.to(f32) * cs_full).to(dt).to(f32)
            d_w = (blended.t() @ dout_e).to(dt)
        return d_g, d_cs, d_w, dout, None


def blend_matmul_group(g_cat, cs_cat, wexp_g, out_prev, c_per):
    """Differentiable ``out_prev + (g_cat * expand(cs_cat)) @ wexp_g``,
    dispatched on the device of ``g_cat``."""
    return BlendMatmulGroupFunction.apply(g_cat, cs_cat, wexp_g, out_prev,
                                          c_per)
