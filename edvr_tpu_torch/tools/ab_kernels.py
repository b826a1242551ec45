"""Time earlier sources of the DCNv2 forward, the blend GEMM, the DCNv2
backward and the row gather against the current ones, on a CUDA card, in
one process.

    python -m edvr_tpu_torch.tools.ab_kernels [OLD_FWD=path]
        [OLD_BLEND=path] [OLD_BWD=path] [OLD_GATHER=path] [--iters 20]
        [--ablate [GROUP ...]]

``OLD_FWD`` is an earlier ``csrc/dcn_fwd.cu``, ``OLD_BLEND`` an earlier
``csrc/blend_matmul.cu`` (both its entries, fp32 and bf16), ``OLD_BWD`` an
earlier ``csrc/dcn_bwd.cu``, each with the C entry points of the current
one, and ``OLD_GATHER`` the ``csrc/row_gather.cu`` that takes an error
flag (the one before the device-side assertion, called as its wrapper
called it: a zeroed flag per call, read back by a synchronisation), with
the headers each includes beside it, e.g. from a git checkout::

    mkdir -p old && for f in dcn_fwd.cu blend_matmul.cu dcn_bwd.cu \
        row_gather.cu dcn_common.cuh mma_common.cuh; do
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
  blended strip beside it; its bf16 form there, at EDVR-L's L1 and at the
  packed bf16 training step's shapes (n=20; 64/32/16 px), with each
  launch's device time from ``torch.profiler``;
* the row gather at the packed training step's tables (fp32 and bf16,
  n=20; 64/32/16 px) and at the inference L1 of EDVR-M and EDVR-L, with
  each launch's device time and ``torch.index_select`` beside it;
* the backward at the training shapes L1/L2/L3 (n=20, 64/32/16 px), fp32
  and bf16, with each CUDA kernel's device time per call from
  ``torch.profiler`` (the old source's two launches apart).

With ``--ablate [GROUP ...]`` it also builds the current sources with
their measurement switches (:data:`ABLATIONS`: ``-DDCN_FWD_ONE_PRODUCT``,
``-DDCN_FWD_NO_MMA``; ``-DBLEND_ONE_PRODUCT``, ``-DBLEND_NO_SPLIT``;
``-DDCN_BWD_NO_ATOMICS``, ``-DDCN_BWD_NO_GATHER``, ``-DDCN_BWD_NO_MMA``,
``-DDCN_BWD_NO_ITEMS``, whose results are wrong by design and are not
checked; the bf16 blend's ``-DBLEND_BF16_NO_*``, wrong by design too)
and times each against the shipped build, in turns: the forward and the
fp32 blend at the L1 shapes, the backward at the training L1 shape and at
1, 2 and 4 blocks per SM, the bf16 blend at the packed route's shapes.

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
               'OLD_BLEND': ('blend_matmul', ('blend_matmul',
                                              'blend_matmul_bf16')),
               'OLD_BWD': ('dcn_bwd', ('dcn_bwd', 'dcn_bwd_bf16')),
               'OLD_GATHER': ('row_gather', ('row_gather',))}
ENTRIES = {source: entries for source, entries in OLD_SOURCES.values()}
# the C signature of the row gather that took an error flag (table, idx,
# out, flag, G, R, L, stream)
OLD_GATHER_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
# blocks per SM of the two-launch backward that the fused kernel replaced:
# its weight-gradient launch ran eight per SM
OLD_BWD_BLOCKS_PER_SM = 8


# the measurement switches of the current sources (--ablate), by group;
# each group's source and the kernel entries it binds
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
    # the shipped bf16 blend is checked beside them; these are not
    'blend_matmul_bf16': {
        'no_mma': ['-DBLEND_BF16_NO_MMA'],
        'no_blend': ['-DBLEND_BF16_NO_BLEND'],
        'no_b': ['-DBLEND_BF16_NO_B'],
        'no_mma_no_blend': ['-DBLEND_BF16_NO_MMA', '-DBLEND_BF16_NO_BLEND'],
        'no_mma_no_blend_no_b': ['-DBLEND_BF16_NO_MMA',
                                 '-DBLEND_BF16_NO_BLEND',
                                 '-DBLEND_BF16_NO_B']},
}
WRONG_BY_DESIGN = {'no_mma', 'no_blend', 'no_b', 'no_mma_no_blend',
                   'no_mma_no_blend_no_b'}
ABLATION_SOURCE = {'dcn_fwd': 'dcn_fwd', 'blend_matmul': 'blend_matmul',
                   'dcn_bwd': 'dcn_bwd', 'blend_matmul_bf16': 'blend_matmul'}
ABLATION_ENTRIES = {**ENTRIES, 'blend_matmul': ('blend_matmul',),
                    'blend_matmul_bf16': ('blend_matmul_bf16',)}


def _nvcc(path: str, so: str, defines=()):
    """Start nvcc on ``path`` into ``so``; returns the process."""
    os.makedirs(AB_DIR, exist_ok=True)
    return subprocess.Popen([native.nvcc_path(), *native.NVCC_FLAGS,
                             *defines, '-o', so, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _bind(so: str, source: str, entries, old: bool) -> dict:
    lib = ctypes.CDLL(so)
    fns = {}
    for entry in entries:
        symbol, argtypes = native.SIGNATURES[entry]
        fn = getattr(lib, symbol)
        if source == 'row_gather' and old:
            fn.argtypes, fn.restype = OLD_GATHER_ARGTYPES, ctypes.c_int
            fn = old_gather(fn)
        else:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[entry] = fn
    return fns


def build_many(specs) -> dict:
    """Build each of ``specs`` ({tag: (path, source, entries, defines,
    old)}) by one nvcc each, all started together, and bind its entries
    (``old``: the flag-taking row gather behind :func:`old_gather`);
    returns {tag: {entry: function}}."""
    procs = {tag: (_nvcc(path, osp.join(AB_DIR, f'lib{source}-{tag}.so'),
                         defines), source, entries, old)
             for tag, (path, source, entries, defines, old) in specs.items()}
    out = {}
    for tag, (proc, source, entries, old) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed to build {tag} (exit '
                               f'{proc.returncode}):\n{log}')
        out[tag] = _bind(osp.join(AB_DIR, f'lib{source}-{tag}.so'), source,
                         entries, old)
    return out


def build_old(path: str, source: str, entries, tag='old',
              defines=()) -> dict:
    """Build ``path`` (an earlier ``csrc/<source>.cu``, or the current one
    with ``defines``) and bind its ``entries``."""
    return build_many({tag: (path, source, entries, defines,
                             tag == 'old')})[tag]


def old_gather(fn):
    """The flag-taking row gather called as its wrapper called it: a zeroed
    int32 flag per call (a fill launch), the kernel, then the flag read
    back (a host synchronisation) and an ``IndexError`` when it is set."""
    def call(table, idx, out, G, R, L, stream):
        bad = torch.zeros(1, device='cuda', dtype=torch.int32)
        err = fn(table, idx, out, bad.data_ptr(), G, R, L, stream)
        if err == 0 and bad.item():
            raise IndexError('row_gather (old): an index lies outside '
                             f'[0, {R})')
        return err
    return call


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
    """Device ms per call of each CUDA kernel that ``fn`` launches: the
    profiler's mean time per launch of the kernel, times its launches per
    call (the count over ``calls``, at least one: the trace may miss a few
    launches of a run, which would otherwise read as a shorter kernel)."""
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
        if us > 0 and e.count:
            out[e.key[:80]] = (us / e.count * max(1, round(e.count / calls))
                               / 1e3)
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
    new_fns = {e: native.load(e) for e in old_fns}
    bf16 = torch.bfloat16
    train_gen = torch.Generator().manual_seed(chip_smoke.SEED + 11)
    cases = [(lv, hw, 64, 5, torch.float32, gen)
             for lv, hw in chip_smoke.LEVELS.items()]
    cases += [(lv, hw, 64, 5, bf16, gen)
              for lv, hw in chip_smoke.LEVELS.items()]
    cases.append(('L_L1', chip_smoke.LEVELS['L1'], 128, 5, bf16, gen))
    cases += [(f'train_{lv}', hw, 64, chip_smoke.TRAIN_N, bf16, train_gen)
              for lv, hw in chip_smoke.TRAIN_LEVELS.items()]
    for level, (h, w), c, n, dtype, case_gen in cases:
        low = dtype == bf16
        tol = chip_smoke.BLEND_BF16_TOL if low else chip_smoke.BLEND_TOL
        with torch.no_grad():
            dcn_args = [a.to(dtype) for a in chip_smoke.dcn_inputs(
                h, w, case_gen, n=n, c=c)]
            _, (*args, c_per) = chip_smoke.packed_kernel_inputs(dcn_args)
            del dcn_args
            want = dcn_blend.blend_matmul_group_plain(*args, c_per)
            scale = want.abs().max().item()
            runs, errs, profiles = {}, {}, {}
            for name, fns in (('old', old_fns), ('new', new_fns)):
                def run(fns=fns):
                    with bound_to(fns):
                        return dcn_blend.blend_matmul_cuda(*args, c_per)
                got = run()
                torch.cuda.synchronize()
                errs[name] = (got - want).abs().max().item()
                if not errs[name] <= tol * scale:
                    raise AssertionError(f'blend {name} {level}: max abs err '
                                         f'{errs[name]} > {tol} x {scale}')
                runs[name] = run
                profiles[name] = kernel_ms_per_call(run)
            del want, got
            timed = turns(runs, iters)
            blended = args[0] * args[1].repeat_interleave(c_per, 1)
            prev = args[3].to(blended.dtype)
            library_ms = chip_smoke.cuda_ms(
                lambda: torch.addmm(prev, blended, args[2]), iters)
            del blended, prev
            bound = chip_smoke.blend_bound(*args)
        print(json.dumps({
            'kernel': 'blend_matmul' + ('_bf16' if low else ''),
            'level': level, 'g_cat': list(args[0].shape), 'c_per': c_per,
            'cout': args[2].shape[1], **timed, 'kernel_ms_per_call': profiles,
            'library_ms': library_ms, 'max_abs_err': errs,
            'max_abs_out': scale, 'tol_rel_to_max_out': tol,
            'bound_ms': bound[0], 'bound_by': bound[1],
            'bound_ms_fp32_pipe': bound[4], 'card': card}), flush=True)
        del args


def ab_gather(old_fns, iters, gen, card):
    import chip_smoke
    from edvr_tpu_torch.ops import gather
    new_fns = {'row_gather': native.load('row_gather')}
    train_gen = torch.Generator().manual_seed(chip_smoke.SEED + 11)
    cases = [(f'train_{lv}', hw, 64, chip_smoke.TRAIN_N, dt, train_gen)
             for dt in (torch.float32, torch.bfloat16)
             for lv, hw in chip_smoke.TRAIN_LEVELS.items()]
    cases += [('L1', chip_smoke.LEVELS['L1'], 64, 5, torch.float32, gen),
              ('L_L1', chip_smoke.LEVELS['L1'], 128, 5, torch.float32, gen)]
    for level, (h, w), c, n, dtype, case_gen in cases:
        with torch.no_grad():
            dcn_args = [a.to(dtype) for a in chip_smoke.dcn_inputs(
                h, w, case_gen, n=n, c=c)]
            (table, idx), _ = chip_smoke.packed_kernel_inputs(dcn_args)
            del dcn_args
            want = table.index_select(0, idx)
            runs, profiles = {}, {}
            for name, fns in (('old', old_fns), ('new', new_fns)):
                def run(fns=fns):
                    with bound_to(fns):
                        return gather.row_gather_cuda(table, idx)
                got = run()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f'row_gather {name} {level}: not '
                                         'bitwise equal to index_select')
                runs[name] = run
                profiles[name] = kernel_ms_per_call(run)
            del want, got
            timed = turns(runs, iters)
            library_ms = chip_smoke.cuda_ms(
                lambda: torch.index_select(table, 0, idx), iters)
            library_kernel = kernel_ms_per_call(
                lambda: torch.index_select(table, 0, idx))
            bound = chip_smoke.gather_bound(table, idx)
        print(json.dumps({
            'kernel': 'row_gather', 'level': level,
            'dtype': str(dtype).replace('torch.', ''),
            'table': list(table.shape), 'gathers': idx.shape[0], **timed,
            'kernel_ms_per_call': profiles, 'library_ms': library_ms,
            'library_kernel_ms_per_call': library_kernel,
            'bitwise_equal': True, 'bound_ms': bound[0],
            'bound_by': bound[1], 'distinct_rows': bound[3], 'card': card}),
            flush=True)
        del table, idx


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


def ablate(iters, gen, card, groups=None):
    """The current kernels against their measurement builds (the groups of
    :data:`ABLATIONS` named in ``groups``, all by default), in turns
    (shipped, each variant, then back): the DCN forward and the fp32 blend
    at the L1 shapes, the backward at the training L1 shape (also at 1, 2
    and 4 blocks per SM), the bf16 blend at the packed route's shapes, with
    each build's device time per call."""
    import chip_smoke
    from edvr_tpu_torch.ops import dcn, dcn_blend
    groups = list(ABLATIONS if groups is None else groups)
    specs = {f'{group}-{name}': (
        osp.join(native.CSRC, f'{ABLATION_SOURCE[group]}.cu'),
        ABLATION_SOURCE[group], ABLATION_ENTRIES[group], defines, False)
        for group in groups for name, defines in ABLATIONS[group].items()}
    built = build_many(specs)
    variants = {group: {'shipped': {e: native.load(e)
                                    for e in ABLATION_ENTRIES[group]},
                        **{name: built[f'{group}-{name}']
                           for name in ABLATIONS[group]}}
                for group in groups}

    def timed(runs):
        order = list(runs) + list(runs)[::-1]
        each = {k: [] for k in runs}
        for name in order:
            each[name].append(chip_smoke.cuda_ms(runs[name], iters))
        return {k: sum(v) / len(v) for k, v in each.items()}

    if 'blend_matmul_bf16' in variants:
        train_gen = torch.Generator().manual_seed(chip_smoke.SEED + 11)
        cases = [(lv, chip_smoke.LEVELS[lv], 64, 5, gen)
                 for lv in ('L1', 'L2')]
        cases.append(('L_L1', chip_smoke.LEVELS['L1'], 128, 5, gen))
        cases += [(f'train_{lv}', hw, 64, chip_smoke.TRAIN_N, train_gen)
                  for lv, hw in chip_smoke.TRAIN_LEVELS.items()]
        for level, (h, w), c, n, case_gen in cases:
            with torch.no_grad():
                _, (*args, c_per) = chip_smoke.packed_kernel_inputs(
                    [a.to(torch.bfloat16) for a in chip_smoke.dcn_inputs(
                        h, w, case_gen, n=n, c=c)])
                want = dcn_blend.blend_matmul_group_plain(*args, c_per)
                tol = chip_smoke.BLEND_BF16_TOL * want.abs().max().item()
                runs, kernel_ms = {}, {}
                for name, fns in variants['blend_matmul_bf16'].items():
                    def run(fns=fns):
                        with bound_to(fns):
                            return dcn_blend.blend_matmul_cuda(*args, c_per)
                    err = (run() - want).abs().max().item()
                    if name not in WRONG_BY_DESIGN and not err <= tol:
                        raise AssertionError(f'blend bf16 {name} {level}: '
                                             f'{err} > {tol}')
                    runs[name] = run
                    kernel_ms[name] = sum(kernel_ms_per_call(run).values())
                del want
                print(json.dumps({'ablate': 'blend_matmul_bf16',
                                  'level': level, 'ms': timed(runs),
                                  'kernel_ms': kernel_ms,
                                  'bound_ms': chip_smoke.blend_bound(*args)[0],
                                  'card': card}), flush=True)
                del args
    h, w = chip_smoke.LEVELS['L1']
    for dname, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        if 'dcn_fwd' not in variants:
            break
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
    if 'blend_matmul' in variants:
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
        if 'dcn_bwd' not in variants:
            break
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
                    metavar='OLD_FWD=path|OLD_BLEND=path|OLD_BWD=path|'
                            'OLD_GATHER=path')
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--ablate', nargs='*', default=None,
                    choices=sorted(ABLATIONS), metavar='GROUP',
                    help='time the measurement builds of the current '
                         'kernels (these groups of them; all without a '
                         'name)')
    opts = ap.parse_args(argv)
    old = {}
    for item in opts.sources:
        key, _, path = item.partition('=')
        if key not in OLD_SOURCES or not path:
            ap.error(f'expected OLD_FWD=path, OLD_BLEND=path, '
                     f'OLD_BWD=path or OLD_GATHER=path, got {item!r}')
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
        {'OLD_FWD': ab_fwd, 'OLD_BLEND': ab_blend, 'OLD_BWD': ab_bwd,
         'OLD_GATHER': ab_gather}[key](fns, opts.iters, gen, card)
    if opts.ablate is not None:
        ablate(opts.iters, gen, card, opts.ablate or None)
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
