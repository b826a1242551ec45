"""Where the time of one EDVR-M x4 training step goes in the PyTorch port,
on a CUDA card: the training twin of profile_torch_window.py.

    python3 scripts/dev/profile_torch_train_step.py [--steps 3] [--trace out.json]

Builds the EDVR-M training engine of chip_smoke.py (the
train_EDVR_M_x4_SR_REDS.yml options with its cuts: fp32 with TF32 off,
golden weights, batch 4 of 5-frame 64x64 LQ crops, Charbonnier loss, Adam)
past its TSA warm-up, and runs seeded batches. Prints JSON lines:

* ``step_ms``: ms per step by the host clock around synchronised steps
  (median of 8), and the peak device memory;
* ``profile``: kernel time by category (DCN forward and backward kernels,
  cuDNN forward, data-gradient and weight-gradient convolutions, the
  optimizer, elementwise, reductions, other) from a torch.profiler trace
  of ``--steps`` steps, the device's busy share (summed kernel time over
  the host's wall time of the profiled region) and the top kernels.

Needs the repo around it and a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import random
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from edvr_tpu_torch.models import create_model  # noqa: E402
from edvr_tpu_torch.utils.options import parse_dict  # noqa: E402


def category(name: str) -> str:
    low = name.lower()
    for key in ('dcn_fwd', 'dcn_bwd_data', 'dcn_bwd_weight'):
        if key in low:
            return key
    if 'multi_tensor' in low or 'adam' in low:
        return 'optimizer'
    if 'wgrad' in low:
        return 'conv_wgrad'
    if 'dgrad' in low:
        return 'conv_dgrad'
    if any(k in low for k in ('conv', 'cudnn', 'xmma', 'gemm', 'fprop',
                              'winograd', 'implicit')):
        return 'conv_fprop_gemm'
    if 'reduce' in low:
        return 'reduction'
    if 'elementwise' in low or 'vectorized' in low:
        return 'elementwise'
    return 'other'


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=3)
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

    state = chip_smoke.load_golden()[0]
    gen = torch.Generator().manual_seed(args.seed)
    batches = chip_smoke.train_batches(gen, 4, chip_smoke.BATCH,
                                       random.Random(args.seed))
    with tempfile.TemporaryDirectory() as tmp:
        opt = parse_dict(json.loads(json.dumps(chip_smoke.EDVR_M_TRAIN_OPT)),
                         is_train=True, root=tmp)
        opt['device'] = 'cuda'
        ckpt = osp.join(tmp, 'golden.pth')
        torch.save({'params': state}, ckpt)
        opt['path']['pretrain_network_g'] = ckpt
        model = create_model(opt)
    it = chip_smoke.TSA_ITER  # past the warm-up: every parameter learns

    def step():
        nonlocal it
        model.feed_data(batches[it % len(batches)])
        model.optimize_parameters(it)
        it += 1

    for _ in range(3):  # cuDNN's algorithm choice, the kernels' load
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(8):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    secs.sort()
    print(json.dumps({'step_ms': {'median': secs[len(secs) // 2] * 1e3,
                                  'all': [s * 1e3 for s in secs]},
                      'peak_mem_bytes': torch.cuda.max_memory_allocated(),
                      'card': card}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
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
    n = args.steps
    print(json.dumps({
        'profile': {
            'steps': n, 'kernels': len(kernels),
            'wall_ms_per_step': wall_us / n / 1e3,
            'kernel_ms_per_step': busy / n / 1e3,
            'device_busy_share': busy / wall_us,
            'ms_per_step_by_category': {
                k: v / n / 1e3 for k, v in sorted(
                    by_cat.items(), key=lambda kv: -kv[1])},
            'top_kernels_ms_per_step': {
                k: v / n / 1e3 for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:14]},
        },
        'card': card}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
