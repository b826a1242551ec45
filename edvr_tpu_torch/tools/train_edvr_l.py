"""EDVR-L training on a CUDA card through the training CLI's code path:
ms per step, peak memory and a validation pass, under each cuDNN choice.

    python -m edvr_tpu_torch.tools.train_edvr_l [--steps 4] [--out FILE]
        [--only NAME ...]

Writes a seeded synthetic REDS tree as PNGs (one 100-frame training clip,
GT 256x256 and its 4x box-downsampled LQ; one validation clip of
``VAL_FRAMES`` frames, LQ 180x320 and GT 720x1280), then runs each
configuration of :func:`runs` in a child process of its own, because
cuDNN's algorithm choice is read once per process: the shipped YAMLs
(``options/train/EDVR/train_EDVR_L_x4_SR_REDS{,_woTSA}.yml``, and the
EDVR-M one for comparison) with the cuts of :func:`cli_args` given to
``edvr_tpu_torch.train.parse_options`` as ``--force_yml``. The child runs
``main``'s steps in order: ``parse_options``, the cuDNN choice (the CLI's
own, ``train.use_train_cudnn_policy``, which caps EDVR-L in fp32 only and
leaves bf16 runs PyTorch's default, or one of :data:`POLICIES`: PyTorch's
default, ``test.INFERENCE_CUDNN_ENV`` or either of its two variables
alone), ``create_train_val_dataloader``,
``create_model`` (seeded; each DCN pack's ``conv_offset`` weights drawn
so the samples move), then ``--steps`` timed steps (``feed_data`` +
``optimize_parameters``, host clock around work that ends in
``torch.cuda.synchronize()``) after warm-up steps, and, where asked, two
passes of ``validation`` (the second timed). The ``c6_halves_*`` runs
first compute every wide 3x3 convolution in halves
(:func:`halve_wide_convs`, a measurement). Prints one JSON line per run
(ms per step, peak bytes of the steps and of validation, ms per
validation window, the DCN launches per step, the cuDNN environment) and
the card's name and power limit; with ``--out``, also writes the lines
there. A run that exhausts the card's memory reports ``"oom": true``.
The set-up and the loop (:func:`build`, :func:`run_steps`,
:func:`run_validation`) are also those of ``chip_smoke.py``'s
``edvr_l_train`` phase, which adds its checks to them.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edvr_tpu_torch.test import INFERENCE_CUDNN_ENV
from edvr_tpu_torch.tools.synthetic import (TRAIN_GT, VAL_FRAMES, VAL_LQ,
                                            write_reds_tree)

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
YML = {name: osp.join(REPO, 'options', 'train', 'EDVR', f'{name}.yml')
       for name in ('train_EDVR_L_x4_SR_REDS',
                    'train_EDVR_L_x4_SR_REDS_woTSA',
                    'train_EDVR_M_x4_SR_REDS')}
WARMUP_STEPS = 2
OFFSET_STD = 0.01    # conv_offset weights of each DCN pack, N(0, 0.01)


def cli_args(yml, root, batch, remat=False, mp='bf16', tsa_iter=None,
             total_iter=100):
    """``-opt`` and the ``--force_yml`` cuts of a run of ``yml`` on the
    synthetic tree at ``root``: (args, cuts). ``batch`` 32 is the shipped
    4 per GPU x 8 GPUs, batched in one process; ``tsa_iter`` None keeps
    the YAML's."""
    num_gpu = batch // 4
    forces = {
        'path:pretrain_network_g': '~',
        'num_gpu': str(num_gpu),
        'network_g:remat': str(bool(remat)).lower(),
        'train:mixed_precision': mp if mp else '~',
        'train:total_iter': str(total_iter),
        'datasets:train:dataroot_gt': f'{root}/train/gt',
        'datasets:train:dataroot_lq': f'{root}/train/lq',
        'datasets:train:meta_info_file': f'{root}/meta_info.txt',
        'datasets:train:num_worker_per_gpu': '0',
        'datasets:val:dataroot_gt': f'{root}/val/gt',
        'datasets:val:dataroot_lq': f'{root}/val/lq',
        'datasets:val:meta_info_file': '~',
    }
    if tsa_iter is not None:
        forces['train:tsa_iter'] = str(tsa_iter)
    cuts = [
        'path.pretrain_network_g -> null (the woTSA checkpoint is not in '
        'the repo): seeded weights, each DCN pack\'s conv_offset weights '
        f'drawn from N(0, {OFFSET_STD})',
        f'num_gpu 8 -> {num_gpu} (batch_size_per_gpu 4 kept: batch '
        f'{batch} in one process)',
        'REDS -> a seeded synthetic REDS tree of PNGs (one 100-frame '
        f'training clip of {TRAIN_GT}x{TRAIN_GT} GT; validation: one clip '
        f'of {VAL_FRAMES} frames of {VAL_LQ[0]}x{VAL_LQ[1]} LQ)',
        'num_worker_per_gpu 3 -> 0 (the loader in the main process)',
        f'train.total_iter 600000 -> {total_iter}',
    ]
    if remat:
        cuts.append('network_g.remat: true (not in the YAML)')
    if mp != 'bf16':
        cuts.append('train.mixed_precision: bf16 -> null (fp32, TF32 off)')
    if tsa_iter is not None:
        cuts.append(f'train.tsa_iter -> {tsa_iter}')
    args = ['-opt', yml, '--device', 'cuda', '--force_yml',
            *(f'{k}={v}' for k, v in forces.items())]
    return args, cuts


def seed_offsets(net, seed=0):
    """Draw each DCN pack's ``conv_offset`` weights (zero in a fresh EDVR)
    from N(0, OFFSET_STD), so the DCN samples move and its offset convs
    learn."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if 'conv_offset.weight' in name:
                p.copy_((torch.randn(p.shape, generator=gen)
                         * OFFSET_STD).to(p.device))


# cuDNN choices a run can force (the environment set before the first
# convolution): PyTorch's default; the test CLI's INFERENCE_CUDNN_ENV
# ('capped': the v7 API and a 1 GiB workspace cap); each of its two parts
# alone
POLICIES = {'default': {}, 'capped': INFERENCE_CUDNN_ENV,
            **{name: {key: INFERENCE_CUDNN_ENV[key]} for name, key in (
                ('wscap', 'CUDNN_CONV_WSCAP_DBG'),
                ('v7', 'TORCH_CUDNN_V8_API_DISABLED'))}}


def halve_wide_convs():
    """Measurement of C.6's alternative, which was not adopted: every 3x3
    ``nn.Conv2d`` of 128 or more input channels in this process computes
    as two convolutions over the halves of its input channels, the form
    ``archs.edvr_arch.conv_cat`` gives PCD's concatenated inputs in
    float32 (which call ``F.conv2d`` themselves, so they are not halved
    again)."""
    conv_forward = nn.Conv2d._conv_forward

    def halves(self, x, w, b):
        if (w.shape[1] < 128 or w.shape[2:] != (3, 3) or self.groups != 1
                or self.padding_mode != 'zeros'):
            return conv_forward(self, x, w, b)
        c = w.shape[1] // 2
        geo = (self.stride, self.padding, self.dilation)
        return (F.conv2d(x[:, :c], w[:, :c], None, *geo)
                + F.conv2d(x[:, c:], w[:, c:], b, *geo))

    nn.Conv2d._conv_forward = halves


def runs():
    """The configurations: (name, yml, batch, remat, mp, policy, val,
    halves)."""
    out = []
    # C.5: EDVR-L and EDVR-M steps and validation under each choice
    for net, yml in (('L', 'train_EDVR_L_x4_SR_REDS'),
                     ('M', 'train_EDVR_M_x4_SR_REDS')):
        for mp in ('fp32', 'bf16'):
            for policy in POLICIES:
                out.append((f'c5_{net}_{mp}_{policy}', yml, 4, False, mp,
                            policy, True, False))
    # C.6: EDVR-L at the shipped batch of 32 under PyTorch's default; and
    # every wide 3x3 convolution in halves under it
    for mp in ('fp32', 'bf16'):
        out.append((f'c6_L_b32_{mp}_default', 'train_EDVR_L_x4_SR_REDS', 32,
                    False, mp, 'default', False, False))
    for net, yml in (('L', 'train_EDVR_L_x4_SR_REDS'),
                     ('M', 'train_EDVR_M_x4_SR_REDS')):
        for batch in (4, 32) if net == 'L' else (4,):
            for mp in ('fp32', 'bf16'):
                out.append((f'c6_halves_{net}_b{batch}_{mp}', yml, batch,
                            False, mp, 'default', batch == 4, True))
    # the EDVR-L YAMLs under the CLI's own choice (train_cudnn_env: capped
    # in fp32, the default in bf16), with a validation pass at batch 4
    for yml in ('train_EDVR_L_x4_SR_REDS_woTSA', 'train_EDVR_L_x4_SR_REDS'):
        for batch in (4, 32):
            for remat in (False, True):
                for mp in ('bf16', 'fp32'):
                    tag = 'woTSA' if yml.endswith('woTSA') else 'TSA'
                    out.append((f'{tag}_b{batch}_{mp}'
                                f'{"_remat" if remat else ""}', yml, batch,
                                remat, mp, 'cli', batch == 4 and not remat,
                                False))
    return out


def build(yml, root, batch, policy='cli', remat=False, mp='bf16',
          tsa_iter=None, total_iter=100, seed=0):
    """A run of the YAML named ``yml`` on the synthetic tree at ``root``, set
    up as ``python -m edvr_tpu_torch.train`` sets it up (in a process that
    must not have run a convolution): ``parse_options`` on
    :func:`cli_args`, the cuDNN choice (``policy`` 'cli': the CLI's own,
    ``train.use_train_cudnn_policy``; else a name of :data:`POLICIES`),
    ``create_train_val_dataloader`` and ``create_model``, its offsets
    drawn by :func:`seed_offsets`. ``mp`` is 'bf16' or None (fp32).
    Returns (opt, cudnn_env, cuts, loaders, model); ``cudnn_env`` holds the
    policy's variables as the process now has them."""
    from edvr_tpu_torch import train
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.utils import get_root_logger
    args, cuts = cli_args(YML[yml], root, batch, remat, mp, tsa_iter,
                          total_iter)
    opt = train.parse_options(is_train=True, args=args)
    if policy == 'cli':
        train.use_train_cudnn_policy(opt)
    else:
        os.environ.update(POLICIES[policy])
    env = {k: os.environ.get(k) for k in INFERENCE_CUDNN_ENV}
    loaders = train.create_train_val_dataloader(opt, get_root_logger())
    model = create_model(opt)
    seed_offsets(model.net_g, seed)
    return opt, env, cuts, loaders, model


def prefetch(loaders):
    """The training loader of ``loaders`` (as :func:`build` returns them)
    as the CLI reads it: a ``CPUPrefetcher`` at epoch 0."""
    from edvr_tpu_torch.data import CPUPrefetcher
    prefetcher = CPUPrefetcher(loaders[0])
    loaders[1].set_epoch(0)
    prefetcher.reset()
    return prefetcher


def run_steps(model, loaders, steps, warmup=0, on_step=None):
    """``warmup`` untimed training steps, then ``steps`` timed ones, as the
    CLI's loop takes them (``feed_data`` + ``optimize_parameters``; host
    clock around work that ends in ``torch.cuda.synchronize()``; the peak
    counted from the first timed step). ``on_step(it)`` runs after each
    step, untimed. Returns the readings: ms per step, peak bytes, losses,
    and the kernel launches of each step (the nonzero ones)."""
    from edvr_tpu_torch import native
    prefetcher = prefetch(loaders)
    secs, losses, launches = [], [], []
    for it in range(1, warmup + steps + 1):
        if it == warmup + 1:
            torch.cuda.reset_peak_memory_stats()
        batch = prefetcher.next()
        before = dict(native.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.optimize_parameters(it)
        torch.cuda.synchronize()
        if it > warmup:
            secs.append(time.perf_counter() - t0)
        launches.append({k: v - before[k] for k, v in native.LAUNCHES.items()
                         if v != before[k]})
        losses.append(float(model.log_dict['l_pix']))
        if on_step is not None:
            on_step(it)
    ms = sorted(s * 1e3 for s in secs)
    return dict(batch_lq=list(batch['lq'].shape),
                ms_per_step_median=ms[len(ms) // 2],
                ms_per_step_all=[s * 1e3 for s in secs],
                peak_mem_bytes_steps=torch.cuda.max_memory_allocated(),
                losses=losses, losses_finite=bool(np.isfinite(losses).all()),
                launches_per_step=launches[-1], launches_all=launches)


def run_validation(model, loaders):
    """Two passes of the CLI's ``validation`` on the validation loader, the
    second timed, with the peak counted over it. Returns ms per window,
    peak bytes and the PSNR of each frame of clip 000."""
    val_loader = loaders[2]
    model.validation(val_loader, 'warmup', None, False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.validation(val_loader, 'timed', None, False)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    psnr = model.metric_results['000'][:, 0]
    return dict(val_frames=VAL_FRAMES, val_lq=list(VAL_LQ),
                val_ms_per_window=val_s / VAL_FRAMES * 1e3,
                peak_mem_bytes_val=torch.cuda.max_memory_allocated(),
                val_psnr=[float(v) for v in psnr],
                val_psnr_mean=float(np.mean(psnr)),
                val_psnr_finite=bool(np.isfinite(psnr).all()))


def child(spec):
    """One run (in this process, which must not have run a convolution):
    returns its readings."""
    if spec['halves']:
        halve_wide_convs()
    _, env, cuts, loaders, model = build(
        spec['yml'], spec['root'], spec['batch'], spec['policy'],
        spec['remat'], spec['mp'] if spec['mp'] == 'bf16' else None)
    result = dict(spec, root=None, cuts=cuts, cudnn_env=env,
                  cudnn_version=torch.backends.cudnn.version(),
                  params=sum(p.numel() for p in model.net_g.parameters()))
    try:
        steps = run_steps(model, loaders, spec['steps'], WARMUP_STEPS)
    except torch.cuda.OutOfMemoryError as e:
        result.update(oom=True, oom_message=str(e)[:300])
        return result
    steps.pop('launches_all')
    result.update(oom=False, **steps)
    if spec['val']:
        result.update(run_validation(model, loaders))
    return result


def smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--steps', type=int, default=4)
    parser.add_argument('--out', default=None)
    parser.add_argument('--only', nargs='+', default=None,
                        help='run only these configurations, by name')
    parser.add_argument('--child', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('train_edvr_l: needs a CUDA card', file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(json.loads(args.child))), flush=True)
        return 0
    card = smi()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        root = write_reds_tree(osp.join(tmp, 'reds'))
        env = {k: v for k, v in os.environ.items()
               if k not in INFERENCE_CUDNN_ENV}
        env['PYTHONPATH'] = os.pathsep.join(
            [REPO, os.environ.get('PYTHONPATH', '')])
        for name, yml, batch, remat, mp, policy, val, halves in runs():
            if args.only and name not in args.only:
                continue
            spec = dict(name=name, yml=yml, batch=batch, remat=remat, mp=mp,
                        policy=policy, val=val, halves=halves,
                        steps=args.steps, root=root)
            proc = subprocess.run(
                [sys.executable, '-m', 'edvr_tpu_torch.tools.train_edvr_l',
                 '--child', json.dumps(spec)], cwd=tmp, env=env,
                capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f'{name} failed (exit {proc.returncode})'
                                   f':\n{proc.stderr[-4000:]}')
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            line['card'] = card
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            f.writelines(json.dumps(line) + '\n' for line in lines)
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
