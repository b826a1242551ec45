"""The training CLI with and without ``--launcher pytorch`` on one card::

    python -m edvr_tpu_torch.tools.dist_train [--pretrain EDVR_M.pth]
        [--steps 14] [--turns] [--out FILE]

runs ``python -m edvr_tpu_torch.train`` three times on the shipped EDVR-M
YAML (bf16, as shipped; :func:`write_yml` lists its cuts) over a seeded
packed REDS (``tools/data_layer.py::write_packed_reds``), each run a
process of its own from the same weights (``--pretrain``, else seeded):
twice with ``--launcher none`` (the second with TensorBoard and a
``logger.profile`` window) and once with ``--launcher pytorch`` at world
size 1 (NCCL; ``RANK=0 WORLD_SIZE=1 LOCAL_RANK=0``, a free
``MASTER_PORT``), with the same window. It prints one JSON line: each
run's ms per step (the median of the CLI's logged iteration times after
the window), the largest parameter gap between the runs (the DCN
backward's dx is summed by atomics, so two ``none`` runs differ too), and
from the profiled steps of each window the all-reduces (host ops and NCCL
kernels, count and ms a step) and the DCN kernels' launches a step. The
profiler leaves later steps slower, so ``--turns`` times the step instead:
plain runs (no window, no TensorBoard) in turns, none, pytorch, pytorch,
none, each its median from iteration WARMUP on. Its functions are also
``chip_smoke.py``'s dist_train and tb_profile phases.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import re
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

from edvr_tpu_torch.tools.data_layer import EDVR_M_YML, write_packed_reds

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
STEPS = 14
PROFILE = (4, 6)  # the profiled iterations (3), after cuDNN has chosen
TSA_ITER = 4
WARMUP = 8  # --turns: the iterations before the timed ones, and then some
_ITER_LOG = re.compile(r'iter:\s*([\d,]+), lr:.*time \(data\): ([\d.]+)')


def write_yml(root, name, gt_pak, lq_pak, pretrain, steps=STEPS,
              **logger):
    """The shipped EDVR-M training YAML as ``root/<name>.yml`` with its
    cuts (returned beside the path) and ``logger`` options added."""
    import yaml
    with open(EDVR_M_YML) as f:
        opt = yaml.safe_load(f)
    opt['name'] = name
    opt['num_gpu'] = 1
    opt['path']['pretrain_network_g'] = pretrain
    opt['datasets']['train'].update(
        type='REDSPackedDataset', dataroot_gt=gt_pak, dataroot_lq=lq_pak,
        meta_info_file=None, num_worker_per_gpu=0)
    del opt['datasets']['val'], opt['val']
    opt['train'].update(total_iter=steps, tsa_iter=TSA_ITER)
    opt['logger'].update(print_freq=1, save_checkpoint_freq=10**9,
                         use_tb_logger=False)
    opt['logger'].update(logger)
    path = osp.join(root, f'{name}.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    cuts = ['num_gpu 8 -> 1 (batch 4)',
            f'path.pretrain_network_g -> {pretrain}',
            'datasets.train: REDSDataset on REDS -> REDSPackedDataset on a '
            'seeded .tpak (tools/data_layer.py::write_packed_reds), '
            'num_worker_per_gpu 3 -> 0',
            'datasets.val and val: taken out',
            f'train.total_iter 600000 -> {steps}, tsa_iter 50000 -> '
            f'{TSA_ITER}',
            'logger.print_freq 100 -> 1, save_checkpoint_freq -> never '
            '(the latest is saved at the end)']
    return path, cuts


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_train(yml, launcher, cwd, timeout=900):
    """``python -m edvr_tpu_torch.train -opt yml --launcher launcher`` in
    ``cwd`` (the run's root); ``pytorch`` as rank 0 of 1. Returns its
    standard error (the log); raises with its tail on failure."""
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                        'MASTER_PORT')}
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (REPO, env.get('PYTHONPATH')) if p)
    if launcher == 'pytorch':
        env.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=str(free_port()))
    out = subprocess.run(
        [sys.executable, '-m', 'edvr_tpu_torch.train', '-opt', yml,
         '--launcher', launcher], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout)
    if out.returncode:
        raise RuntimeError(f'train --launcher {launcher} exited '
                           f'{out.returncode}:\n{out.stderr[-4000:]}')
    return out.stderr


def step_ms(log, first):
    """The logged iteration times (ms) from iteration ``first`` on."""
    return [float(t) * 1e3 for it, t in _ITER_LOG.findall(log)
            if int(it.replace(',', '')) >= first]


def trace_summary(path, steps):
    """From a Chrome trace of ``steps`` profiled iterations: the
    all-reduces (host ops whose name holds ``all_reduce`` / ``allreduce``,
    NCCL kernels) and the DCN kernels, as {name: [count a step, ms a
    step]}."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    out = {}
    for e in events:
        name, cat = e.get('name', ''), e.get('cat', '')
        low = name.lower()
        if cat == 'kernel':
            key = next((k for k in ('dcn_fwd_kernel', 'dcn_bwd_kernel')
                        if k in name), 'nccl_kernels' if 'nccl' in low
                       else None)
        elif 'all_reduce' in low or 'allreduce' in low:
            key = name
        else:
            key = None
        if key is not None:
            count, ms = out.get(key, (0, 0.0))
            out[key] = (count + 1, ms + e.get('dur', 0) / 1e3)
    return {k: [c / steps, ms / steps] for k, (c, ms) in out.items()}


def latest_params(root, name):
    path = osp.join(root, 'experiments', name, 'models', 'net_g_latest.pth')
    return torch.load(path, map_location='cpu', weights_only=True)['params']


def max_gap(a, b):
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def run_all(root, pretrain, steps=STEPS, seed=0):
    """The three runs in ``root``; returns their readings (the traces and
    event files stay in ``root``)."""
    gt_pak, lq_pak = write_packed_reds(osp.join(root, 'packed'), seed=seed)
    window = dict(start_iter=PROFILE[0], end_iter=PROFILE[1])
    profiled = PROFILE[1] - PROFILE[0] + 1
    runs = {'none_a': ('none', {}),
            'none_b': ('none', dict(use_tb_logger=True, profile=window)),
            'pytorch': ('pytorch', dict(profile=window))}
    out, params = {'runs': {}}, {}
    for name, (launcher, logger) in runs.items():
        yml, out['cuts'] = write_yml(root, f'dist_{name}', gt_pak, lq_pak,
                                     pretrain, steps, **logger)
        log = run_train(yml, launcher, root)
        ms = step_ms(log, PROFILE[1] + 2)
        run = dict(launcher=launcher,
                   ms_per_step_median=float(np.median(ms)), ms_per_step=ms,
                   log_tail=log[-600:])
        trace = osp.join(root, 'experiments', f'dist_{name}', 'profile',
                         'trace_rank0.json')
        if logger.get('profile'):
            run['trace'] = trace
            run['window'] = trace_summary(trace, profiled)
        if logger.get('use_tb_logger'):
            tb = osp.join(root, 'tb_logger', f'dist_{name}')
            run['tb_events'] = (sorted(os.listdir(tb)) if osp.isdir(tb)
                                else [])
            run['tb_missing_warning'] = \
                'TensorBoard cannot be imported' in log
        params[name] = latest_params(root, f'dist_{name}')
        out['runs'][name] = run
    out['gap_none'] = max_gap(params['none_a'], params['none_b'])
    out['gap_pytorch'] = max_gap(params['none_a'], params['pytorch'])
    out['extra_ms_per_step'] = (out['runs']['pytorch']['ms_per_step_median']
                                - out['runs']['none_a']['ms_per_step_median'])
    return out


def time_turns(root, pretrain, steps, seed=0):
    """Plain runs in turns (none, pytorch, pytorch, none): each run's
    median ms per step from iteration WARMUP on, and the pytorch runs'
    mean median less the none runs'."""
    gt_pak, lq_pak = write_packed_reds(osp.join(root, 'packed'), seed=seed)
    medians = {'none': [], 'pytorch': []}
    for turn, launcher in enumerate(('none', 'pytorch', 'pytorch', 'none')):
        yml, _ = write_yml(root, f'turn{turn}_{launcher}', gt_pak, lq_pak,
                           pretrain, steps)
        ms = step_ms(run_train(yml, launcher, root), WARMUP)
        medians[launcher].append(float(np.median(ms)))
    return dict(turns=medians, steps=steps, timed_from=WARMUP,
                extra_ms_per_step=float(np.mean(medians['pytorch'])
                                        - np.mean(medians['none'])))


def seeded_pretrain(path, seed=0):
    """A seeded EDVR-M ``.pth`` (the shipped YAML's network)."""
    import yaml

    from edvr_tpu_torch.archs import define_network
    with open(EDVR_M_YML) as f:
        net_opt = yaml.safe_load(f)['network_g']
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = define_network(net_opt)
    torch.save({'params': net.state_dict()}, path)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--pretrain', default=None,
                        help='EDVR-M weights (.pth); seeded when not given')
    parser.add_argument('--steps', type=int, default=STEPS)
    parser.add_argument('--turns', action='store_true',
                        help='time plain none and pytorch runs in turns')
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('this tool times the card; CUDA is not available')
    with tempfile.TemporaryDirectory() as root:
        pretrain = args.pretrain or seeded_pretrain(
            osp.join(root, 'edvr_m_seeded.pth'))
        run = time_turns if args.turns else run_all
        result = run(root, osp.abspath(pretrain), args.steps)
    result['card'] = torch.cuda.get_device_name(0)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
