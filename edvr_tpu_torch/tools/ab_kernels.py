"""Time earlier sources of the DCNv2 forward, the blend GEMM and the DCNv2
backward against the current ones, on a CUDA card, in one process.

    python -m edvr_tpu_torch.tools.ab_kernels [OLD_FWD=path]
        [OLD_BLEND=path] [OLD_BWD=path] [--iters 20] [--ablate]

``OLD_FWD`` is an earlier ``csrc/dcn_fwd.cu``, ``OLD_BLEND`` an earlier
``csrc/blend_matmul.cu``, ``OLD_BWD`` an earlier ``csrc/dcn_bwd.cu``, each
with the C entry points of the current one and the headers it includes
beside it, e.g. from a git checkout::

    mkdir -p old && for f in dcn_fwd.cu blend_matmul.cu dcn_bwd.cu \
        dcn_common.cuh mma_common.cuh; do
        git show HEAD~1:edvr_tpu_torch/csrc/$f > old/$f; done

Each is built with the port's nvcc flags into ``edvr_tpu_torch/_build/ab``
and bound in place of the current library behind the port's own wrapper
(``ops/dcn.py::dcn_fwd_cuda``, ``ops/dcn_blend.py::blend_matmul_cuda``,
``ops/dcn.py::dcn_bwd_cuda``; the forward that reads x channels-last, the
two-launch backward with its eight blocks per SM). Old and new are held against the plain version at each
level (the forward at ``DCN_TOL`` absolute / ``BF16_FWD_TOL`` of
``max|out|``; the blend at ``BLEND_TOL`` of ``max|out|``; the backward at
``BWD_TOL`` / ``BF16_BWD_TOL`` of each gradient's largest entry, all from
``chip_smoke.py``), then timed by CUDA events over ``--iters`` warm calls
in turns, old new new old, so that a drift of the card's clock falls on
both:

* the forward at the inference shapes L1/L2/L3 (n=5 frames of a 180x320
  clip) and the training shapes (n=20; 64/32/16 px), fp32 and bf16, with
  each CUDA kernel's device time per call from ``torch.profiler``, the
  bound and the GEMM alone (``torch.mm`` of a materialized column, a part
  of the function);

* the blend at the packed route's inference shapes L1/L2/L3 (one
  deformable group of an EDVR-M DCN call on a 180x320 clip, as
  ``chip_smoke.py`` kernel_blend_* builds it), with ``torch.addmm`` on the
  blended strip beside it;
* the backward at the training shapes L1/L2/L3 (n=20, 64/32/16 px), fp32
  and bf16, with each CUDA kernel's device time per call from
  ``torch.profiler`` (the old source's two launches apart).

With ``--ablate`` it also builds the current sources with their
measurement switches (``-DDCN_FWD_ONE_PRODUCT``, ``-DDCN_FWD_NO_MMA``;
``-DBLEND_ONE_PRODUCT``, ``-DBLEND_NO_SPLIT``; ``-DDCN_BWD_NO_ATOMICS``,
``-DDCN_BWD_NO_GATHER``, ``-DDCN_BWD_NO_MMA``, ``-DDCN_BWD_NO_ITEMS``,
whose results are wrong by design and are not checked) and times each
against the shipped build at the L1 shapes, in turns, and the backward at
1, 2 and 4 blocks per SM.

Prints one JSON line per kernel, level and dtype, then the card's name and
power limit. Needs the repo around it (it reads ``chip_smoke.py``'s
shapes, inputs and bounds) and a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import os.path as osp
import subprocess
import sys

import torch

from edvr_tpu_torch import native

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
AB_DIR = osp.join(native.BUILD_DIR, 'ab')
# the kernel entries of each source that can be swapped
OLD_SOURCES = {'OLD_FWD': ('dcn_fwd', ('dcn_fwd', 'dcn_fwd_bf16')),
               'OLD_BLEND': ('blend_matmul', ('blend_matmul',)),
               'OLD_BWD': ('dcn_bwd', ('dcn_bwd', 'dcn_bwd_bf16'))}
ENTRIES = {source: entries for source, entries in OLD_SOURCES.values()}
# blocks per SM of the two-launch backward that the fused kernel replaced:
# its weight-gradient launch ran eight per SM
OLD_BWD_BLOCKS_PER_SM = 8


# the measurement switches of the current sources (--ablate)
ABLATIONS = {
    'dcn_fwd': {'one_product': ['-DDCN_FWD_ONE_PRODUCT'],
                'no_mma': ['-DDCN_FWD_NO_MMA']},
    'blend_matmul': {'one_product': ['-DBLEND_ONE_PRODUCT'],
                     'no_split': ['-DBLEND_NO_SPLIT'],
                     'one_product_no_split': ['-DBLEND_ONE_PRODUCT',
                                              '-DBLEND_NO_SPLIT']},
    'dcn_bwd': {'no_atomics': ['-DDCN_BWD_NO_ATOMICS'],
                'no_gather': ['-DDCN_BWD_NO_GATHER'],
                'no_gather_no_atomics': ['-DDCN_BWD_NO_GATHER',
                                         '-DDCN_BWD_NO_ATOMICS'],
                'no_mma': ['-DDCN_BWD_NO_MMA'],
                'no_items': ['-DDCN_BWD_NO_ITEMS']},
}


def build_old(path: str, source: str, entries, tag='old',
              defines=()) -> dict:
    """Build ``path`` (an earlier ``csrc/<source>.cu``, or the current one
    with ``defines``) and bind its ``entries``."""
    os.makedirs(AB_DIR, exist_ok=True)
    so = osp.join(AB_DIR, f'lib{source}-{tag}.so')
    proc = subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, *defines,
                           '-o', so, path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed to build {path} (exit '
                           f'{proc.returncode}):\n{proc.stdout}{proc.stderr}')
    lib = ctypes.CDLL(so)
    fns = {}
    for entry in entries:
        symbol, argtypes = native.SIGNATURES[entry]
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[entry] = fn
    return fns


@contextlib.contextmanager
def fwd_channels_last():
    """For a block, hand the forward kernel x channels-last, (n, h, w,
    cin), as earlier sources of ``csrc/dcn_fwd.cu`` read it."""
    from edvr_tpu_torch.ops import dcn
    saved = dcn.FWD_X_GROUP_MAJOR
    dcn.FWD_X_GROUP_MAJOR = False
    try:
        yield
    finally:
        dcn.FWD_X_GROUP_MAJOR = saved


@contextlib.contextmanager
def bound_to(fns: dict, blocks_per_sm=None):
    """Route the wrappers of ``fns``' entries to those functions for a
    block (and the backward's grid to ``blocks_per_sm``)."""
    from edvr_tpu_torch.ops import dcn
    saved = {e: native._libs.get(e) for e in fns}
    saved_blocks = dcn.BWD_BLOCKS_PER_SM
    native._libs.update(fns)
    if blocks_per_sm is not None:
        dcn.BWD_BLOCKS_PER_SM = blocks_per_sm
    try:
        yield
    finally:
        dcn.BWD_BLOCKS_PER_SM = saved_blocks
        for e, fn in saved.items():
            if fn is None:
                native._libs.pop(e, None)
            else:
                native._libs[e] = fn


def kernel_ms_per_call(fn, calls=10) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, 'device_time_total', None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            out[e.key[:80]] = us / calls / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def turns(runs: dict, iters: int) -> dict:
    """Mean ms of each of ``runs`` ({'old': fn, 'new': fn}), timed in the
    order old new new old; the times of each turn beside the mean."""
    import chip_smoke
    each = {k: [] for k in runs}
    for name in ['old', 'new', 'new', 'old']:
        each[name].append(chip_smoke.cuda_ms(runs[name], iters))
    return {'ms': {k: sum(v) / len(v) for k, v in each.items()},
            'ms_each_turn': each}


def ab_fwd(old_fns, iters, gen, card):
    import chip_smoke
    from edvr_tpu_torch.ops import dcn
    new_fns = {e: native.load(e) for e in old_fns}
    levels = [(lv, hw, 5) for lv, hw in chip_smoke.LEVELS.items()]
    levels += [(f'train_{lv}', hw, chip_smoke.TRAIN_N)
               for lv, hw in chip_smoke.TRAIN_LEVELS.items()]
    for dname, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        for level, (h, w), n in levels:
            with torch.no_grad():
                args = [a.to(dtype) for a in chip_smoke.dcn_inputs(
                    h, w, gen, n=n)]
                want = dcn.modulated_deform_conv_plain(*args, 1, 1, 1, 1, 8)
                runs, errs, profiles = {}, {}, {}
                for name, fns in (('old', old_fns), ('new', new_fns)):
                    def run(fns=fns, old=name == 'old'):
                        layout = (fwd_channels_last() if old
                                  else contextlib.nullcontext())
                        with bound_to(fns), layout:
                            return dcn.dcn_fwd_cuda(*args, 1, 1, 1, 8)
                    got = run()
                    torch.cuda.synchronize()
                    if dtype == torch.float32:
                        errs[name] = (got - want).abs().max().item()
                        tol = chip_smoke.DCN_TOL
                    else:
                        errs[name] = chip_smoke.rel_err(got, want)
                        tol = chip_smoke.BF16_FWD_TOL
                    if not errs[name] <= tol:
                        raise AssertionError(f'dcn_fwd {name} {dname} '
                                             f'{level}: {errs[name]} > {tol}')
                    runs[name] = run
                    profiles[name] = kernel_ms_per_call(run)
                del want, got
                timed = turns(runs, iters)
                bound = chip_smoke.dcn_bound(*args)
                library_ms = chip_smoke.gemm_only_ms(args[0], args[3], iters)
            print(json.dumps({
                'kernel': 'dcn_fwd' + ('' if dname == 'fp32' else '_bf16'),
                'level': level, 'dtype': dname, 'shape': list(args[0].shape),
                **timed, 'kernel_ms_per_call': profiles, 'err': errs,
                'tol': tol, 'bound_ms': bound[0], 'bound_by': bound[1],
                'bound_ms_fp32_pipe': bound[4], 'library_ms': library_ms,
                'library': chip_smoke.GEMM_ONLY, 'card': card}), flush=True)
            del args


def ab_blend(old_fns, iters, gen, card):
    import chip_smoke
    from edvr_tpu_torch.ops import dcn_blend
    new_fns = {'blend_matmul': native.load('blend_matmul')}
    for level, (h, w) in chip_smoke.LEVELS.items():
        with torch.no_grad():
            dcn_args = chip_smoke.dcn_inputs(h, w, gen)
            _, (*args, c_per) = chip_smoke.packed_kernel_inputs(dcn_args)
            del dcn_args
            want = dcn_blend.blend_matmul_group_plain(*args, c_per)
            scale = want.abs().max().item()
            runs, errs = {}, {}
            for name, fns in (('old', old_fns), ('new', new_fns)):
                def run(fns=fns):
                    with bound_to(fns):
                        return dcn_blend.blend_matmul_cuda(*args, c_per)
                got = run()
                torch.cuda.synchronize()
                errs[name] = (got - want).abs().max().item()
                if not errs[name] <= chip_smoke.BLEND_TOL * scale:
                    raise AssertionError(f'blend {name} {level}: max abs err '
                                         f'{errs[name]} > {chip_smoke.BLEND_TOL}'
                                         f' x {scale}')
                runs[name] = run
            del want, got
            timed = turns(runs, iters)
            blended = args[0] * args[1].repeat_interleave(c_per, 1)
            library_ms = chip_smoke.cuda_ms(
                lambda: torch.addmm(args[3], blended, args[2]), iters)
            del blended
            bound = chip_smoke.blend_bound(*args)
        print(json.dumps({
            'kernel': 'blend_matmul', 'level': level,
            'g_cat': list(args[0].shape), 'c_per': c_per, **timed,
            'library_ms': library_ms, 'max_abs_err': errs,
            'max_abs_out': scale, 'bound_ms': bound[0], 'bound_by': bound[1],
            'bound_ms_fp32_pipe': bound[4], 'card': card}), flush=True)
        del args


def ab_bwd(old_fns, iters, gen, card):
    import chip_smoke
    from edvr_tpu_torch.ops import dcn
    new_fns = {e: native.load(e) for e in old_fns}
    for dname, dtype, tol in (('fp32', torch.float32, chip_smoke.BWD_TOL),
                              ('bf16', torch.bfloat16,
                               chip_smoke.BF16_BWD_TOL)):
        for level, (h, w) in chip_smoke.TRAIN_LEVELS.items():
            args = [a.to(dtype) for a in chip_smoke.dcn_inputs(
                h, w, gen, n=chip_smoke.TRAIN_N)]
            geo = (1, 1, 1, 8)
            dout = torch.randn(args[0].shape, generator=gen).cuda().to(dtype)
            leaves = [a.clone().requires_grad_() for a in args[:4]]
            want = torch.autograd.grad(dcn.modulated_deform_conv_plain(
                *leaves, args[4], *geo[:3], 1, 8), leaves, dout)
            del leaves
            runs, errs, profiles = {}, {}, {}
            for name, fns, blocks in (
                    ('old', old_fns, OLD_BWD_BLOCKS_PER_SM),
                    ('new', new_fns, None)):
                def run(fns=fns, blocks=blocks):
                    with bound_to(fns, blocks):
                        return dcn.dcn_bwd_cuda(dout, *args[:4], *geo)
                errs[name] = {g: chip_smoke.rel_err(a, b) for g, a, b in zip(
                    ('dx', 'd_offset', 'd_mask', 'd_weight'), run(), want)}
                if not max(errs[name].values()) <= tol:
                    raise AssertionError(f'dcn_bwd {name} {dname} {level}: '
                                         f'{errs[name]} > {tol}')
                runs[name] = run
                profiles[name] = kernel_ms_per_call(run)
            timed = turns(runs, iters)
            bound = chip_smoke.dcn_bwd_bound(*args[:4])
            print(json.dumps({
                'kernel': 'dcn_bwd' + ('' if dname == 'fp32' else '_bf16'),
                'level': level, 'dtype': dname, 'shape': list(args[0].shape),
                **timed, 'kernel_ms_per_call': profiles,
                'rel_err': errs, 'tol': tol, 'bound_ms': bound[0],
                'bound_by': bound[1], 'bound_ms_fp32_pipe': bound[4],
                'card': card}), flush=True)
            del args, dout, want


def ablate(iters, gen, card):
    """The current kernels against their measurement builds at the L1
    shapes, in turns (shipped, each variant, then back); the backward also
    at 1, 2 and 4 blocks per SM."""
    import chip_smoke
    from edvr_tpu_torch.ops import dcn, dcn_blend
    variants = {}
    for source, switches in ABLATIONS.items():
        entries = ENTRIES[source]
        variants[source] = {'shipped': {e: native.load(e) for e in entries}}
        for name, defines in switches.items():
            variants[source][name] = build_old(
                osp.join(native.CSRC, f'{source}.cu'), source, entries, name,
                defines)

    def timed(runs):
        order = list(runs) + list(runs)[::-1]
        each = {k: [] for k in runs}
        for name in order:
            each[name].append(chip_smoke.cuda_ms(runs[name], iters))
        return {k: sum(v) / len(v) for k, v in each.items()}

    h, w = chip_smoke.LEVELS['L1']
    for dname, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        with torch.no_grad():
            args = [a.to(dtype) for a in chip_smoke.dcn_inputs(h, w, gen)]
            runs, kernel_ms = {}, {}
            for name, fns in variants['dcn_fwd'].items():
                def run(fns=fns):
                    with bound_to(fns):
                        return dcn.dcn_fwd_cuda(*args, 1, 1, 1, 8)
                runs[name] = run
                kernel_ms[name] = sum(v for k, v in kernel_ms_per_call(run)
                                      .items() if 'dcn_fwd' in k)
            print(json.dumps({'ablate': 'dcn_fwd', 'level': 'L1',
                              'dtype': dname, 'ms': timed(runs),
                              'kernel_ms': kernel_ms, 'card': card}),
                  flush=True)
            del args
    with torch.no_grad():
        _, (*args, c_per) = chip_smoke.packed_kernel_inputs(
            chip_smoke.dcn_inputs(h, w, gen))
        runs = {}
        for name, fns in variants['blend_matmul'].items():
            def run(fns=fns):
                with bound_to(fns):
                    return dcn_blend.blend_matmul_cuda(*args, c_per)
            runs[name] = run
        print(json.dumps({'ablate': 'blend_matmul', 'level': 'L1',
                          'ms': timed(runs), 'card': card}), flush=True)
        del args
    h, w = chip_smoke.TRAIN_LEVELS['L1']
    for dname, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        args = [a.to(dtype) for a in chip_smoke.dcn_inputs(
            h, w, gen, n=chip_smoke.TRAIN_N)]
        dout = torch.randn(args[0].shape, generator=gen).cuda().to(dtype)
        runs, kernel_ms = {}, {}
        cases = [(name, fns, None) for name, fns in
                 variants['dcn_bwd'].items()]
        cases += [(f'shipped_{b}_per_sm', variants['dcn_bwd']['shipped'], b)
                  for b in (1, 4)]
        for name, fns, blocks in cases:
            def run(fns=fns, blocks=blocks):
                with bound_to(fns, blocks):
                    return dcn.dcn_bwd_cuda(dout, *args[:4], 1, 1, 1, 8)
            runs[name] = run
            kernel_ms[name] = sum(v for k, v in kernel_ms_per_call(run)
                                  .items() if 'dcn_bwd' in k)
        print(json.dumps({'ablate': 'dcn_bwd', 'level': 'train_L1',
                          'dtype': dname, 'ms': timed(runs),
                          'kernel_ms': kernel_ms, 'card': card}), flush=True)
        del args, dout


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('sources', nargs='*',
                    metavar='OLD_FWD=path|OLD_BLEND=path|OLD_BWD=path')
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--ablate', action='store_true',
                    help='time the measurement builds of the current kernels')
    opts = ap.parse_args(argv)
    old = {}
    for item in opts.sources:
        key, _, path = item.partition('=')
        if key not in OLD_SOURCES or not path:
            ap.error(f'expected OLD_FWD=path, OLD_BLEND=path or '
                     f'OLD_BWD=path, got {item!r}')
        old[key] = path
    if not torch.cuda.is_available():
        print('ab_kernels: needs a CUDA card', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    native.build_all()
    gen = torch.Generator().manual_seed(opts.seed)
    for key, path in old.items():
        source, entries = OLD_SOURCES[key]
        fns = build_old(path, source, entries)
        {'OLD_FWD': ab_fwd, 'OLD_BLEND': ab_blend,
         'OLD_BWD': ab_bwd}[key](fns, opts.iters, gen, card)
    if opts.ablate:
        ablate(opts.iters, gen, card)
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
