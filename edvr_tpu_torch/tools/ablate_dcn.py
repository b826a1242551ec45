"""Attribute the DCNv2 forward kernel's time to its components, on a CUDA
card: the port's twin of ``scripts/dev/ablate_band.py``'s ``main``.

    python -m edvr_tpu_torch.tools.ablate_dcn [--dtype bf16|fp32]
        [--shape l1|l2|l3|train_l1] [--seed 0] [--iters 20]

Times each variant of ``csrc/dcn_fwd.cu`` (``edvr_tpu_torch/ops/dcn_ablate.py``:
full, no_coef, int_coef, no_gather, coords_only, io_only) through its
wrapper by CUDA events over ``--iters`` warm calls, on inputs drawn as the
JAX tool draws them (``ablate_band.py:289-307``): offsets U(-2, 2), mask
U(0, 1), N(0, 1) table and weights, no bias, from ``--seed`` with an
explicit ``torch.Generator``. Default shape: EDVR-M inference L1 (n=5,
180x320, 64 -> 64 channels, dg=8, 3x3 taps). The JAX tool's ``r bw J``
arguments are TPU tiling and have no counterpart.

Prints one JSON line per variant: its ms, the ms it saves against
``full``, and its own bound (the larger of its operations, in the time
the kernel's arithmetic needs on the tensor cores and the fp32 pipe, and
its bytes over the memory rate, each input it reads counted once, its
output once); then a line for the JAX v5 ablations
that have no counterpart here, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from edvr_tpu_torch.ops import dcn_ablate

# (n, h, w) of each shape; 64 -> 64 channels, dg 8, 3x3 taps, padding 1
SHAPES = {'l1': (5, 180, 320), 'l2': (5, 90, 160), 'l3': (5, 45, 80),
          'train_l1': (20, 64, 64)}
CHANNELS, DG, KSIZE = 64, 8, 3
DTYPES = {'fp32': torch.float32, 'bf16': torch.bfloat16}
# H100 SXM published peaks (NVIDIA data sheet): fp32 on the CUDA cores,
# bf16 dense on the tensor cores, device memory
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# TF32 dense on the tensor cores: the rate of a float32 product taken in
# 3xTF32 (three TF32 products per float32 product)
PEAK_TF32 = 495e12

# what each variant keeps of the components (a) fields, (b) coordinate and
# coefficient math, (c) corner loads, (d) blend, (e) contraction, and its
# counterpart in the JAX tool
VARIANTS = {
    'full': ('a-e', "full; band_forward v5 ''"),
    'no_coef': ('a, c, e', 'no_coef'),
    'int_coef': ('a, b, one corner, d, e', 'band_forward v5 int_coef'),
    'no_gather': ('a, b, d, e', 'onehot_only / no_product'),
    'coords_only': ('a, b', 'rows_only'),
    'io_only': ('a', 'dma_only'),
}
NO_COUNTERPART = {
    'variant': 'no_inw, noselect', 'counterpart': None,
    'note': 'band_forward v5 no_inw and noselect have no counterpart: '
            'dcn_fwd.cu has no in-window indicator or outlier patch, and '
            'reads the offset and mask fields without select-transposes'}


def make_inputs(shape='l1', dtype=torch.bfloat16, seed=0, device='cuda'):
    """(x, offset, mask, weight) of ``shape`` in ``dtype`` on ``device``."""
    n, h, w = SHAPES[shape]
    K = KSIZE * KSIZE
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, CHANNELS, h, w, generator=gen)
    offset = torch.rand(n, DG * 2 * K, h, w, generator=gen) * 4 - 2
    mask = torch.rand(n, DG * K, h, w, generator=gen)
    weight = torch.randn(CHANNELS, CHANNELS, KSIZE, KSIZE, generator=gen)
    return [t.to(device, dtype) for t in (x, offset, mask, weight)]


def bound(mode, x, offset, mask, weight):
    """(bound ms, 'operations' or 'bytes', operations, bytes) of variant
    ``mode`` on these inputs: each input it reads counted once, the output
    written once. Its operations take the time the kernel's arithmetic
    needs, the larger of two units: the contraction on the tensor cores
    (fp32 in 3xTF32, three TF32 products per product at the TF32 rate;
    bf16 as two exact products per column entry, its hi and lo, at the
    bf16 rate) and the per-sample math on the fp32 pipe."""
    n, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    K = kh * kw
    samples = n * h * w * K * cin          # (pixel, tap, channel) samples
    contraction = 2 * samples * cout
    points = n * h * w * K * DG            # (pixel, tap, group) points
    read = {'x': x.numel(), 'fields': offset.numel() + mask.numel(),
            'weight': weight.numel()}
    mma, simt, elems = {
        'full': (contraction, 8 * samples, sum(read.values())),
        'no_coef': (contraction, 4 * samples, sum(read.values())),
        'int_coef': (contraction, samples, sum(read.values())),
        'no_gather': (contraction, 0, read['fields'] + read['weight']),
        'coords_only': (0, 20 * points, read['fields']),
        'io_only': (0, 2 * points, read['fields']),
    }[mode]
    nbytes = (elems + n * cout * h * w) * x.element_size()
    t_mma = (3 * mma / PEAK_TF32 if x.dtype == torch.float32
             else 2 * mma / PEAK_OPS[x.dtype])
    t_ops = max(t_mma, simt / PEAK_OPS[torch.float32])
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', mma + simt,
            nbytes)


def cuda_ms(fn, iters):
    """Mean ms of ``fn`` over ``iters`` warm calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(dtype='bf16', shape='l1', seed=0, iters=20):
    """Time every variant at ``shape`` in ``dtype``; returns one dict per
    variant, ``full`` first."""
    if not torch.cuda.is_available():
        raise RuntimeError('ablate_dcn needs a CUDA card')
    if iters < 20:
        raise ValueError(f'iters must be >= 20, got {iters}')
    args = make_inputs(shape, DTYPES[dtype], seed)
    rows = []
    for mode, (keeps, jax_name) in VARIANTS.items():
        ms = cuda_ms(lambda: dcn_ablate.ablate_cuda(mode, *args, None, 1, 1,
                                                    1, DG), iters)
        bound_ms, bound_by, ops, nbytes = bound(mode, *args)
        rows.append(dict(variant=mode, dtype=dtype, shape=shape,
                         x=list(args[0].shape), keeps=keeps,
                         jax_counterpart=jax_name, ms=ms, iters=iters,
                         bound_ms=bound_ms, bound_by=bound_by,
                         gop=ops / 1e9, mbytes=nbytes / 1e6))
    full_ms = rows[0]['ms']
    for row in rows:
        row['saved_ms'] = full_ms - row['ms']
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--dtype', choices=sorted(DTYPES), default='bf16')
    ap.add_argument('--shape', choices=sorted(SHAPES), default='l1')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('ablate_dcn: needs a CUDA card', file=sys.stderr)
        return 1
    for row in run(args.dtype, args.shape, args.seed, args.iters):
        print(json.dumps(row), flush=True)
    print(json.dumps(NO_COUNTERPART), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
