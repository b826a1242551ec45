"""Time each distinct convolution of an EDVR forward pass on a CUDA card,
forward and backward, in fp32 and bf16, under each cuDNN choice.

    python -m edvr_tpu_torch.tools.time_convs [--variant L|M]
        [--shape NAME ...] [--dtype fp32 bf16] [--policy default capped]
        [--out FILE]

For each shape of :data:`SHAPES` (EDVR-L's training crops at batch 4 and
32, and its 180x320 inference window) the convolutions are recorded from
one forward pass of the port's EDVR (``F.conv2d`` calls, through a
``TorchFunctionMode``, in float32): each distinct (input, weight, stride,
padding) with how many calls of the pass it stands for. A convolution that
:func:`edvr_tpu_torch.archs.edvr_arch.conv_cat` splits in float32 shows as
two halves; each split pair is also timed as the one convolution of the
concatenated input it replaces (``"concat": true``), the form the port
runs in bf16 (the summary's ``port_form``); and
each 3x3 convolution of 128 or more input channels also as two over the
halves of its (sliced) input (``"halves": true``). Each is
timed by CUDA events, forward alone and forward + backward
(``torch.autograd.grad`` of the input, the weight and the bias), with the
device memory it adds at its peak (cuDNN's workspace), and the names of
the kernels one forward + backward launches (``torch.profiler``); a name
with ``fft`` in it marks cuDNN's FFT choice.

Each (dtype, policy, shape) runs in a child process of its own, because
cuDNN's algorithm choice is read once per process: ``default`` is
PyTorch's, ``capped`` the test CLI's ``INFERENCE_CUDNN_ENV``. TF32 is off
(as ``train.parse_options`` sets it). Prints one JSON line per convolution
and one summary line per run (ms of all the pass's convolutions, forward
and forward + backward, and those that drew an FFT kernel, in each of the
three forms), then the
card's name and power limit. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from edvr_tpu_torch.test import INFERENCE_CUDNN_ENV

POLICIES = {'default': {}, 'capped': INFERENCE_CUDNN_ENV}
# (batch of 5-frame clips, LQ height, width)
SHAPES = {'train_b4': (4, 64, 64), 'train_b32': (32, 64, 64),
          'infer': (1, 180, 320)}
VARIANTS = {'L': dict(num_feat=128, num_reconstruct_block=40),
            'M': dict(num_feat=64, num_reconstruct_block=10)}
DTYPES = {'fp32': torch.float32, 'bf16': torch.bfloat16}


class _Recorder(TorchFunctionMode):
    """Records each ``F.conv2d`` call as (input shape, weight shape, bias,
    stride, padding, split), ``split`` the weight's full input channels
    when the weight is a slice of a larger one (a half of ``conv_cat``)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d:
            x, w = args[0], args[1]
            bias = args[2] if len(args) > 2 else kwargs.get('bias')
            stride = args[3] if len(args) > 3 else kwargs.get('stride', 1)
            pad = args[4] if len(args) > 4 else kwargs.get('padding', 0)
            base = w._base
            split = (base.shape[1] if base is not None
                     and base.shape[1] != w.shape[1] else None)
            self.calls.append((tuple(x.shape), tuple(w.shape),
                               bias is not None, _pair(stride), _pair(pad),
                               split))
        return func(*args, **kwargs)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def record_convs(variant, batch, h, w):
    """The distinct convolutions of one forward pass of EDVR-``variant``
    on (batch, 5, 3, h, w) on the card, each as [calls, (input shape,
    weight shape, bias, stride, padding, split)], in order of first
    call."""
    from edvr_tpu_torch.archs.edvr_arch import EDVR
    net = EDVR(**VARIANTS[variant]).cuda()
    rec = _Recorder()
    with rec, torch.no_grad():
        net(torch.rand(batch, 5, 3, h, w, device='cuda'))
    del net
    counts = {}
    for call in rec.calls:
        counts[call] = counts.get(call, 0) + 1
    return [[n, call] for call, n in counts.items()]


def _cuda_ms(fn, iters):
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


def _kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type.name == 'CUDA'})


def time_conv(xs, ws, bias, stride, pad, dtype, gen, iters=5,
              halves=False):
    """ms forward, ms forward + backward, the peak extra bytes of each and
    the kernel names of one forward + backward. With ``halves`` the
    convolution is taken as two over the halves of its input channels (the
    input sliced, as a split of a convolution with no concatenated input
    would take it)."""
    x = torch.randn(xs, generator=gen).cuda().to(dtype).requires_grad_()
    wt = (torch.randn(ws, generator=gen) * 0.05).cuda().to(
        dtype).requires_grad_()
    b = (torch.zeros(ws[0], device='cuda', dtype=dtype).requires_grad_()
         if bias else None)
    leaves = [t for t in (x, wt, b) if t is not None]
    gy = None

    def conv():
        if not halves:
            return F.conv2d(x, wt, b, stride, pad)
        c = ws[1] // 2
        return (F.conv2d(x[:, :c], wt[:, :c], None, stride, pad)
                + F.conv2d(x[:, c:], wt[:, c:], b, stride, pad))

    def fwd():
        with torch.no_grad():
            return conv()

    def fwd_bwd():
        return torch.autograd.grad(conv(), leaves, gy)

    gy = torch.randn(fwd().shape, generator=gen).cuda().to(dtype)
    out = {}
    for name, fn in (('fwd', fwd), ('fwd_bwd', fwd_bwd)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out[f'ms_{name}'] = _cuda_ms(fn, iters)
        out[f'peak_extra_bytes_{name}'] = (torch.cuda.max_memory_allocated()
                                           - base)
    out['kernels'] = _kernel_names(fwd_bwd)
    out['fft'] = any('fft' in k.lower() for k in out['kernels'])
    return out


def child(spec):
    """One (variant, shape, dtype, policy) run, in a process that has run
    no convolution: a line per convolution and a summary."""
    os.environ.update(POLICIES[spec['policy']])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, h, w = SHAPES[spec['shape']]
    dtype = DTYPES[spec['dtype']]
    gen = torch.Generator().manual_seed(0)
    convs = record_convs(spec['variant'], batch, h, w)
    lines, pairs = [], {}
    for calls, (xs, ws, bias, stride, pad, split) in convs:
        row = dict(calls=calls, x=list(xs), w=list(ws), bias=bias,
                   stride=list(stride), padding=list(pad), split_of=split,
                   concat=False, halves=False)
        lines.append(dict(row, **time_conv(xs, ws, bias, stride, pad, dtype,
                                           gen)))
        if ws[1] >= 128 and ws[2] == 3:
            # a 3x3 convolution of 128 or more input channels (a half of a
            # concatenated input's included), taken in halves too
            lines.append(dict(row, halves=True, **time_conv(
                xs, ws, bias, stride, pad, dtype, gen, halves=True)))
        if split is not None:
            # the two halves of one concatenated-input convolution: time
            # the convolution they replace once per pair
            key = (xs[0], xs[2], xs[3], ws[0], split, stride, pad)
            pairs[key] = calls
    for (n, hh, ww, cout, cin, stride, pad), calls in pairs.items():
        xs, ws = (n, cin, hh, ww), (cout, cin, 3, 3)
        lines.append(dict(calls=calls, x=list(xs), w=list(ws), bias=True,
                          stride=list(stride), padding=list(pad),
                          split_of=None, concat=True, halves=False,
                          **time_conv(xs, ws, True, stride, pad, dtype,
                                      gen)))
    halved = {(tuple(r['x']), tuple(r['w']), r['bias']) for r in lines
              if r['halves']}
    total = {}
    # the pass as the port runs it (split), as it ran before (concat), and
    # with every 3x3 convolution of 128 or more channels in halves
    for form, rows in (
            ('split', [r for r in lines
                       if not r['concat'] and not r['halves']]),
            ('concat', [r for r in lines
                        if r['split_of'] is None and not r['halves']]),
            ('halves', [r for r in lines if not r['concat'] and (
                r['halves'] or (tuple(r['x']), tuple(r['w']), r['bias'])
                not in halved)])):
        total[form] = {k: sum(r['calls'] * r[k] for r in rows)
                       for k in ('ms_fwd', 'ms_fwd_bwd')}
        total[form]['fft_convs'] = [[r['x'], r['w']] for r in rows
                                    if r['fft']]
        total[form]['peak_extra_bytes_max'] = max(
            r['peak_extra_bytes_fwd_bwd'] for r in rows)
    return lines, dict(spec, batch=batch, hw=[h, w],
                       cudnn_version=torch.backends.cudnn.version(),
                       port_form='split' if dtype == torch.float32
                       else 'concat', ms_per_pass=total)


def smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--variant', choices=sorted(VARIANTS), default='L')
    parser.add_argument('--shape', nargs='+', choices=sorted(SHAPES),
                        default=['train_b4', 'train_b32', 'infer'])
    parser.add_argument('--dtype', nargs='+', choices=sorted(DTYPES),
                        default=['fp32', 'bf16'])
    parser.add_argument('--policy', nargs='+', choices=sorted(POLICIES),
                        default=['default'])
    parser.add_argument('--out', default=None)
    parser.add_argument('--child', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('time_convs: needs a CUDA card', file=sys.stderr)
        return 1
    if args.child:
        lines, summary = child(json.loads(args.child))
        for line in lines:
            print(json.dumps(line))
        print(json.dumps(dict(summary=summary)), flush=True)
        return 0
    card = smi()
    env = {k: v for k, v in os.environ.items()
           if k not in INFERENCE_CUDNN_ENV}
    out = []
    for policy in args.policy:
        for dtype in args.dtype:
            for shape in args.shape:
                spec = dict(variant=args.variant, shape=shape, dtype=dtype,
                            policy=policy)
                proc = subprocess.run(
                    [sys.executable, '-m', 'edvr_tpu_torch.tools.time_convs',
                     '--child', json.dumps(spec)], env=env,
                    capture_output=True, text=True)
                if proc.returncode:
                    raise RuntimeError(f'{spec} failed (exit '
                                       f'{proc.returncode}):\n'
                                       f'{proc.stderr[-4000:]}')
                for line in proc.stdout.strip().splitlines():
                    row = dict(json.loads(line), card=card)
                    row.setdefault('spec', spec)
                    out.append(row)
                    if 'summary' in row or row.get('fft'):
                        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            f.writelines(json.dumps(r) + '\n' for r in out)
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
