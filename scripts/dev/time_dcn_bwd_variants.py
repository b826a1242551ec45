"""Time variants of the DCNv2 backward kernel against each other on a CUDA
card, at the EDVR-M training shapes.

    python3 scripts/dev/time_dcn_bwd_variants.py [NAME=path/to/dcn_bwd.cu ...]

Each variant is a source with the C entry point of
edvr_tpu_torch/csrc/dcn_bwd.cu (``dcn_bwd_f32``); the package's own source
is always the variant ``current``. Every variant is built with the port's
nvcc flags, checked against autograd through the plain version (each
gradient relative to its largest entry, as chip_smoke.py holds it), then
timed through the port's wrapper by CUDA events at L1/L2/L3 (n=20, 64
channels, dg=8, 64/32/16 px), the variants in turns (A B ... B A) so that
a drift of the card's clock falls on all of them. Prints one JSON line per
level and the nvidia-smi name/power line. Needs the repo around it and a
CUDA card; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os.path as osp
import subprocess
import sys
import tempfile

import torch

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from edvr_tpu_torch import native  # noqa: E402
from edvr_tpu_torch.ops import dcn  # noqa: E402


def build(path: str, out_dir: str, name: str):
    so = osp.join(out_dir, f'lib{name}.so')
    subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, '-o', so, path],
                   check=True, capture_output=True, text=True)
    symbol, argtypes = native.SIGNATURES['dcn_bwd']
    fn = getattr(ctypes.CDLL(so), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main(argv):
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    variants = {'current': osp.join(native.CSRC, 'dcn_bwd.cu')}
    variants.update(a.split('=', 1) for a in argv)
    gen = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {name: build(path, tmp, name) for name, path in
               variants.items()}
        for level, (h, w) in chip_smoke.TRAIN_LEVELS.items():
            args = chip_smoke.dcn_inputs(h, w, gen, n=chip_smoke.TRAIN_N)
            geo = (1, 1, 1, 8)
            dout = torch.randn(args[0].shape, generator=gen).cuda()
            leaves = [a.clone().requires_grad_() for a in args[:4]]
            want = torch.autograd.grad(
                dcn.modulated_deform_conv_plain(*leaves, args[4], *geo[:3],
                                                1, 8), leaves, dout)

            def run(name):
                native._libs['dcn_bwd'] = fns[name]
                return dcn.dcn_bwd_cuda(dout, *args[:4], *geo)

            errs, times = {}, {n: [] for n in fns}
            for name in fns:
                errs[name] = max(chip_smoke.rel_err(g, w_)
                                 for g, w_ in zip(run(name), want))
                if not errs[name] <= chip_smoke.BWD_TOL:
                    raise AssertionError(f'{name} {level}: rel err '
                                         f'{errs[name]}')
            order = list(fns) + list(fns)[::-1]
            for name in order:
                times[name].append(chip_smoke.cuda_ms(lambda: run(name), 20))
            print(json.dumps({
                'level': level, 'shape': list(args[0].shape),
                'ms': {n: sum(t) / len(t) for n, t in times.items()},
                'ms_each_turn': times, 'rel_err': errs,
                'bound_ms': chip_smoke.dcn_bwd_bound(*args[:4])[0]}),
                flush=True)
    native._libs.pop('dcn_bwd', None)
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
