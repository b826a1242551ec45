"""Where the time of one EDVR x4 window goes in the PyTorch port, on a
CUDA card.

    python3 scripts/dev/profile_torch_window.py [--variant M|L] [--windows 3]
        [--trace out.json]

Builds EDVR-M (64 features, 5 frames, dg=8, 5+10 blocks, TSA) with the
golden reference weights (tests/data/golden/arch_edvr_m_full.npz), or with
``--variant L`` EDVR-L (128 features, 5+40 blocks) with seeded weights
(torch seed ``--seed``, each ``conv_offset`` drawn from N(0, 0.02)), fp32
with TF32 off, and restores seeded 5-frame 180x320 windows. Prints JSON
lines:

* ``window_ms``: ms per window by the host clock around synchronised work,
  with cuDNN's algorithm search off (the port's setting) and on;
* ``profile``: kernel time by category (cuDNN/GEMM convolutions, the DCN
  kernel, elementwise, other) from a torch.profiler trace of ``--windows``
  windows, the device's busy share (summed kernel time over the host's
  wall time of the profiled region) and the top kernels by time.

Needs the repo around it and a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, ROOT)

from edvr_tpu_torch.archs import define_network  # noqa: E402


def category(name: str) -> str:
    low = name.lower()
    if 'dcn_fwd' in low:
        return 'dcn_fwd'
    if any(k in low for k in ('conv', 'cudnn', 'xmma', 'gemm', 'fprop',
                              'winograd', 'implicit')):
        return 'conv_gemm'
    if 'elementwise' in low or 'vectorized' in low:
        return 'elementwise'
    return 'other'


def window_ms(net, wins, iters):
    with torch.no_grad():
        net(wins[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            net(wins[i % len(wins)])
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--variant', choices=('M', 'L'), default='M')
    ap.add_argument('--windows', type=int, default=3)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--trace', default=None,
                    help='also keep the chrome trace at this path')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()

    data = np.load(osp.join(ROOT, 'tests', 'data', 'golden',
                            'arch_edvr_m_full.npz'))
    config = json.loads(bytes(data['__config__']).decode())
    if args.variant == 'M':
        net = define_network(config)
        net.load_state_dict({k: torch.from_numpy(data[k])
                             for k in data.files if not k.startswith('__')},
                            strict=True)
    else:
        torch.manual_seed(args.seed)
        net = define_network(dict(config, num_feat=128,
                                  num_reconstruct_block=40))
        with torch.no_grad():
            for mod in net.modules():
                if hasattr(mod, 'conv_offset'):
                    mod.conv_offset.weight.normal_(0, 0.02)
    net = net.cuda().eval()
    gen = torch.Generator().manual_seed(args.seed)
    wins = [torch.rand(1, 5, 3, 180, 320, generator=gen).cuda()
            for _ in range(4)]

    timings, peaks = {}, {}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        torch.cuda.reset_peak_memory_stats()
        key = f'cudnn_benchmark_{bench}'.lower()
        timings[key] = window_ms(net, wins, 8)
        peaks[key] = torch.cuda.max_memory_allocated()
    torch.backends.cudnn.benchmark = False
    print(json.dumps({'variant': args.variant, 'window_ms': timings,
                      'peak_mem_bytes': peaks, 'card': card}), flush=True)

    window_ms(net, wins, 2)  # warm again under the port's setting
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.windows):
            net(wins[i % len(wins)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or osp.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    by_cat, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        by_cat[category(e['name'])] += e['dur']
        by_name[e['name'][:90]] += e['dur']
    busy = sum(by_cat.values())
    n = args.windows
    print(json.dumps({
        'variant': args.variant,
        'profile': {
            'windows': n, 'kernels': len(kernels),
            'wall_ms_per_window': wall_us / n / 1e3,
            'kernel_ms_per_window': busy / n / 1e3,
            'device_busy_share': busy / wall_us,
            'ms_per_window_by_category': {
                k: v / n / 1e3 for k, v in sorted(
                    by_cat.items(), key=lambda kv: -kv[1])},
            'top_kernels_ms_per_window': {
                k: v / n / 1e3 for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:12]},
        },
        'card': card}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
