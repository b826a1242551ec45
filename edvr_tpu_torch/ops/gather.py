"""Row gather ``out[i, :] = table[idx[i], :]``, the gather of the packed
DCN route.

It is the gather that ``edvr_tpu/ops/dcn.py::_mdcn_packed`` does with
``jnp.take(tab, row, axis=0)`` and that
``scripts/dev/probe_mosaic_gather.py`` probes as an in-kernel Mosaic gather:
a float32 or bfloat16 (R, L) table of packed 128-lane tiles gathered at
data-dependent rows. On a CUDA tensor it is the hand-written kernel
``edvr_tpu_torch/csrc/row_gather.cu``, which copies 32-bit words: a bf16
table is gathered as the words that hold its pairs of lanes, a bit copy.
On a CPU tensor its plain version. The gradient is a scatter-add into a
zero table, as JAX differentiates the take through an XLA scatter outside
any Pallas kernel; it is summed in float32 and cast to the table's dtype.
"""

from __future__ import annotations

import torch

from edvr_tpu_torch import native


def row_gather_plain(table, idx):
    """Plain PyTorch version: ``table.index_select(0, idx)``."""
    return table.index_select(0, idx)


def row_gather_cuda(table, idx):
    """``table[idx]`` through the CUDA kernel (float32 (R, L) table, or
    bfloat16 with an even L, gathered as float32 words; int32 (G,)
    indices; no autograd). Raises on any input the kernel does not take.
    An index outside [0, R) fails the kernel with a device-side assertion,
    as ``index_select`` does on CUDA: the error surfaces as a CUDA error
    (``cudaErrorAssert``) at the next synchronisation, and the process's
    CUDA context is lost. The call itself never synchronises."""
    for name, t in (('table', table), ('idx', idx)):
        if not t.is_cuda or t.device != table.device:
            raise ValueError(f'row_gather: {name} must lie on '
                             f'{table.device} (a CUDA device), got '
                             f'{t.device}')
    if (table.dtype not in (torch.float32, torch.bfloat16)
            or idx.dtype != torch.int32):
        raise TypeError(f'row_gather: needs a float32 or bfloat16 table and '
                        f'int32 indices, got {table.dtype} and {idx.dtype}')
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f'row_gather: table must be 2-D and idx 1-D, got '
                         f'{tuple(table.shape)} and {tuple(idx.shape)}')
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError('row_gather: table and idx must be contiguous')
    low = table.dtype == torch.bfloat16
    if low and table.shape[1] % 2:
        raise ValueError('row_gather: a bfloat16 table needs an even row '
                         'length (pairs of lanes in 32-bit words)')
    if table.data_ptr() % 16:
        raise ValueError('row_gather: the table must be 16-byte aligned')
    words = table.view(torch.float32) if low else table  # 32-bit words
    (R, L), G = words.shape, idx.shape[0]

    out = torch.empty(G, L, device=table.device, dtype=torch.float32)
    err = native.launch(native.load('row_gather'), table.device,
                        words.data_ptr(), idx.data_ptr(), out.data_ptr(), G,
                        R, L)
    native.check('row_gather', err)
    native.LAUNCHES['row_gather'] += 1
    return out.view(torch.bfloat16) if low else out


class RowGatherFunction(torch.autograd.Function):
    """``table[idx]`` with a scatter-add backward. The forward is the
    kernel on a CUDA tensor and its plain version on a CPU tensor."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.rows = table.shape[0]
        ctx.save_for_backward(idx)
        if table.is_cuda:
            return row_gather_cuda(table, idx)
        if table.device.type != 'cpu':
            raise ValueError(f'row_gather: unsupported device '
                             f'{table.device}')
        return row_gather_plain(table, idx)

    @staticmethod
    def backward(ctx, dout):
        idx, = ctx.saved_tensors
        dtable = dout.new_zeros(ctx.rows, dout.shape[1], dtype=torch.float32)
        dtable.index_add_(0, idx, dout.float())
        return dtable.to(dout.dtype), None


def row_gather(table, idx):
    """Differentiable ``table[idx]`` (float32 or bfloat16 (R, L) table,
    int32 indices), dispatched on the device of ``table``."""
    return RowGatherFunction.apply(table, idx)
