"""Time the distinct fp32 convolutions of an EDVR x4 window under cuDNN's
algorithm choices, on a CUDA card.

    python3 scripts/dev/time_edvr_convs.py [--variant L|M] [--frames 5]

For each (batch, cin, cout, kernel, stride, h, w) of one 180x320 window of
EDVR-L (128 features) or EDVR-M (64), with TF32 off as in the port, prints
one JSON line with how many calls of the window it stands for, and ms per
call by CUDA events and the device memory the call adds at its peak
under:

* ``heuristic``: ``cudnn.benchmark`` off (the port's setting);
* ``benchmark``: ``cudnn.benchmark`` on, PyTorch's default
  ``benchmark_limit`` (the first 10 of cuDNN's candidates);
* ``benchmark_all``: ``cudnn.benchmark`` on, ``benchmark_limit = 0`` (every
  candidate);
* ``channels_last``: ``cudnn.benchmark`` off, input and weight in
  channels-last memory format;
* ``split_in_two``: ``cudnn.benchmark`` off, a convolution of ``cin``
  channels as the sum of two over ``cin / 2`` each (the two halves of a
  concatenated input);
* ``im2col_mm``: ``F.unfold`` and one ``torch.bmm`` (cuBLAS fp32), the
  convolution as one GEMM, for scale.

Run it once more with ``CUDNN_CONV_WSCAP_DBG=<MiB>`` in the environment to
see cuDNN's choices with its workspace capped. The last line sums each
choice over the window. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F


def shapes(nf, t=5, h=180, w=320):
    """(calls per window, batch, cin, cout, k, stride, h, w) of EDVR's
    convolutions at ``nf`` features, ``t`` frames, an h x w LQ window."""
    dg3k = 8 * 3 * 9
    rows = [(1, t, 3, nf, 3, 1, h, w),             # conv_first
            (10, t, nf, nf, 3, 1, h, w),           # feature_extraction
            (1, t, nf, nf, 3, 2, h, w),            # conv_l2_1
            (1, t, nf, nf, 3, 1, h // 2, w // 2),  # conv_l2_2
            (1, t, nf, nf, 3, 2, h // 2, w // 2),  # conv_l3_1
            (1, t, nf, nf, 3, 1, h // 4, w // 4)]  # conv_l3_2
    # PCD per level: convs of 2nf (concatenated) inputs (offset_conv1,
    # offset_conv2 below L3, feat_conv below L3, cas_offset_conv1 at L1),
    # of nf inputs (offset_conv2 at L3, offset_conv3, cas_offset_conv2) and
    # the packs' conv_offset (L1 twice: the cascade)
    for s, (cat2, single, offs) in ((1, (4, 2, 2)), (2, (3, 1, 1)),
                                    (4, (1, 1, 1))):
        rows += [(cat2, t, 2 * nf, nf, 3, 1, h // s, w // s),
                 (single, t, nf, nf, 3, 1, h // s, w // s),
                 (offs, t, nf, dg3k, 3, 1, h // s, w // s)]
    # TSA fusion
    rows += [(1, 1, nf, nf, 3, 1, h, w),               # temporal_attn1
             (1, t, nf, nf, 3, 1, h, w),               # temporal_attn2
             (2, 1, t * nf, nf, 1, 1, h, w),           # feat_fusion, sa1
             (1, 1, 2 * nf, nf, 1, 1, h // 2, w // 2),  # spatial_attn2
             (2, 1, nf, nf, 1, 1, h // 2, w // 2),     # sa_l1, sa4
             (1, 1, 2 * nf, nf, 3, 1, h // 4, w // 4),  # spatial_attn_l2
             (1, 1, nf, nf, 3, 1, h // 4, w // 4),     # spatial_attn_l3
             (1, 1, nf, nf, 3, 1, h // 2, w // 2),     # spatial_attn3
             (1, 1, nf, nf, 3, 1, h, w),               # spatial_attn5
             (2, 1, nf, nf, 1, 1, h, w)]               # sa_add1, sa_add2
    rows += [(80 if nf == 128 else 20, 1, nf, nf, 3, 1, h, w),  # trunk
             (1, 1, nf, 4 * nf, 3, 1, h, w),           # upconv1
             (1, 1, nf, 256, 3, 1, 2 * h, 2 * w),      # upconv2
             (1, 1, 64, 64, 3, 1, 4 * h, 4 * w)]       # conv_hr
    return rows


def cuda_ms(fn, iters=10):
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


def timed(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms(fn)
    return ms, torch.cuda.max_memory_allocated() - base


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--variant', choices=('L', 'M'), default='L')
    ap.add_argument('--frames', type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    nf = 128 if args.variant == 'L' else 64
    gen = torch.Generator().manual_seed(0)
    totals = {}
    for calls, n, cin, cout, k, stride, h, w in shapes(nf, args.frames):
        x = torch.randn(n, cin, h, w, generator=gen).cuda()
        wt = (torch.randn(cout, cin, k, k, generator=gen) * 0.05).cuda()
        conv = lambda a=x, b=wt: F.conv2d(a, b, None, stride, k // 2)
        row = {}
        with torch.no_grad():
            for name, bench, limit in (('heuristic', False, 10),
                                       ('benchmark', True, 10),
                                       ('benchmark_all', True, 0)):
                torch.backends.cudnn.benchmark = bench
                torch.backends.cudnn.benchmark_limit = limit
                row[name] = timed(conv)
            torch.backends.cudnn.benchmark = False
            torch.backends.cudnn.benchmark_limit = 10
            xl = x.contiguous(memory_format=torch.channels_last)
            wl = wt.contiguous(memory_format=torch.channels_last)
            row['channels_last'] = timed(lambda: conv(xl, wl))
            del xl, wl
            half = cin // 2
            xa, xb = x[:, :half].contiguous(), x[:, half:].contiguous()
            wa, wb = wt[:, :half].contiguous(), wt[:, half:].contiguous()
            row['split_in_two'] = timed(
                lambda: conv(xa, wa).add_(conv(xb, wb)))
            del xa, xb, wa, wb
            oh = (h + 2 * (k // 2) - k) // stride + 1
            ow = (w + 2 * (k // 2) - k) // stride + 1
            wm = wt.reshape(cout, -1)

            def im2col_mm():
                col = F.unfold(x, k, padding=k // 2, stride=stride)
                return torch.bmm(wm.expand(n, -1, -1), col).view(
                    n, cout, oh, ow)
            row['im2col_mm'] = timed(im2col_mm)
        for key, (ms, _) in row.items():
            totals[key] = totals.get(key, 0.) + calls * ms
        print(json.dumps({
            'shape': dict(calls_per_window=calls, n=n, cin=cin, cout=cout,
                          k=k, stride=stride, h=h, w=w),
            'gflop': 2 * n * cin * cout * k * k * h * w / stride ** 2 / 1e9,
            'ms': {k_: v[0] for k_, v in row.items()},
            'peak_extra_bytes': {k_: v[1] for k_, v in row.items()},
            'card': card}), flush=True)
        del x, wt
    print(json.dumps({'variant': args.variant, 'frames': args.frames,
                      'ms_per_window_by_choice': totals, 'card': card}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
