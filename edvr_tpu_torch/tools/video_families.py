"""The video families' shipped test YAMLs (DUF-52 and TOFlow on Vid4)
through the test CLI's functions on a seeded Vid4-layout tree, with their
times, and the networks' window times under each cuDNN choice.

    python -m edvr_tpu_torch.tools.video_families [--policy default capped]
        [--out FILE]

:func:`write_vid4_tree` writes one folder (``calendar``) of seeded
frames as Vid4 lays them out: ``GT`` at calendar's 576x720, ``BIx4``
made from it by the port's MATLAB ``imresize`` at x1/4 and
``BIx4up_direct`` by ``imresize`` of ``BIx4`` at x4, each rounded to
8 bits, which is how Vid4's inputs are defined. :func:`run_test` runs one
YAML (``create_dataset`` -> ``create_model`` -> ``validation``, from a
seeded ``.pth`` written by :func:`seeded_pth`) in the current directory,
whose ``datasets/Vid4`` the YAMLs name, and reads the engine's ms per
frame (dataset items on the host, the network, ``tensor2img``, the PSNR
and the PNGs) apart from the network's and the dataset items' alone.
``chip_smoke.py --video-families`` runs its phases on these functions.

The CLI runs each cuDNN choice in a child process of its own, because
cuDNN's choice is read once per process: ``default`` is PyTorch's,
``capped`` the test CLI's (``test.INFERENCE_CUDNN_ENV``). A child times
each network on one window of the tree (CUDA events over a few calls
after a warm-up, then one call's kernels by ``torch.profiler``), reckons
its operations (:func:`reckoned_tflop`) and prints one JSON line; the
parent adds the card's name and power limit.
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

from edvr_tpu_torch.test import INFERENCE_CUDNN_ENV

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
# name: the shipped test YAML under options/test
TEST_YML = {'DUF': 'DUF/test_DUF_official.yml',
            'TOF': 'TOF/test_TOF_official.yml'}
VID4_GT = (576, 720)   # calendar's GT frame size
FRAMES = 10            # of calendar's 41
FOLDER = 'calendar'
ITEMS_TIMED = 3        # dataset items timed alone on the host
WINDOW_CALLS = 5       # timed calls of a network on one window
POLICIES = {'default': {}, 'capped': INFERENCE_CUDNN_ENV}
CUTS = ['pretrain_network_g: the official checkpoints are not in the '
        'repository -> seeded weights (BasicSR init, torch seed 0; the '
        'BatchNorm running statistics drawn), saved as a .pth and loaded '
        'strictly',
        f'data: Vid4 (not in the repository) -> one seeded folder '
        f'({FOLDER}, GT {VID4_GT[0]}x{VID4_GT[1]}) with its BIx4 and '
        'BIx4up_direct made by the port\'s imresize; '
        f'{FRAMES} of calendar\'s 41 frames']


def write_vid4_tree(root, frames=FRAMES, gt_hw=VID4_GT, seed=0,
                    folder=FOLDER):
    """``root/{GT,BIx4,BIx4up_direct}/<folder>/%08d.png``: seeded smooth
    moving GT frames and their MATLAB-bicubic x1/4 and x1/4-then-x4
    versions, each rounded to 8 bits. Returns ``root``."""
    import cv2

    from edvr_tpu_torch.tools.synthetic import seeded_clip
    from edvr_tpu_torch.utils.matlab_functions import imresize

    def to_u8(img):
        return np.clip(np.round(img * 255.), 0, 255).astype(np.uint8)

    gen = torch.Generator().manual_seed(seed)
    _, gt = seeded_clip(frames, gt_hw[0] // 4, gt_hw[1] // 4, gen)
    for sub in ('GT', 'BIx4', 'BIx4up_direct'):
        os.makedirs(osp.join(root, sub, folder), exist_ok=True)
    for t in range(frames):
        hr = to_u8(gt[t].permute(1, 2, 0).numpy()[:, :, ::-1])  # BGR
        lr = to_u8(imresize(hr / 255., 1 / 4))
        up = to_u8(imresize(lr / 255., 4))
        for sub, img in (('GT', hr), ('BIx4', lr), ('BIx4up_direct', up)):
            path = osp.join(root, sub, folder, f'{t:08d}.png')
            if not cv2.imwrite(path, img):
                raise IOError(f'cannot write {path}')
    return root


def seeded_network(net_opt, seed=0):
    """``net_opt``'s network from torch seed ``seed`` (BasicSR's init),
    its BatchNorm running statistics drawn (mean N(0, 0.1^2), variance
    U(0.5, 1.5)) so that they matter, in eval mode on the CPU."""
    from edvr_tpu_torch.archs import define_network
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = define_network(dict(net_opt))
        with torch.no_grad():
            for name, t in net.state_dict().items():
                if name.endswith('running_mean'):
                    t.normal_(0, 0.1)
                elif name.endswith('running_var'):
                    t.uniform_(0.5, 1.5)
    return net.eval()


def seeded_pth(net_opt, path, seed=0):
    """:func:`seeded_network`'s state dict under ``params`` at ``path``."""
    torch.save({'params': seeded_network(net_opt, seed).state_dict()},
               path)
    return path


def options(name, device, force=()):
    """``options/test/<TEST_YML[name]>`` parsed as the test CLI parses it
    (TF32 off, the seed set), then ``force`` (``--force_yml``
    entries)."""
    from edvr_tpu_torch.train import parse_options
    args = ['-opt', osp.join(REPO, 'options', 'test', TEST_YML[name]),
            '--device', device]
    return parse_options(False, [*args, '--force_yml', *force] if force
                         else args)


def median_ms(fn, device, calls=WINDOW_CALLS):
    """Median ms of ``calls`` calls of ``fn`` after one warm-up: CUDA
    events around each call on the card, the host's clock on the CPU."""
    fn()
    sync(device)
    times = []
    for _ in range(calls):
        if torch.device(device).type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def run_test(name, device='cuda', seed=0):
    """The YAML of ``name`` through the test CLI's functions in the current
    directory (``datasets/Vid4`` under it; the results written as the
    YAML says), its network from a seeded ``.pth``: the network alone on
    the first window (twice, the second timed), the first ITEMS_TIMED
dataset items alone, then the timed pass.
    Returns (model, loader, readings)."""
    from edvr_tpu_torch.data import create_dataloader, create_dataset
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.utils import make_exp_dirs
    with open(osp.join(REPO, 'options', 'test', TEST_YML[name])) as f:
        import yaml
        net_opt = yaml.safe_load(f)['network_g']
    pth = seeded_pth(net_opt, osp.abspath(f'{name}_seeded.pth'), seed)
    opt = options(name, device, [f'path:pretrain_network_g={pth}'])
    make_exp_dirs(opt)
    dataset_opt = opt['datasets']['test_1']
    loader = create_dataloader(create_dataset(dataset_opt), dataset_opt)
    model = create_model(opt)
    lq = loader.dataset[0]['lq'][None].to(device)
    with torch.no_grad():
        net_ms = median_ms(lambda: model.net_g(lq), device)
    # the host's share: reading (and for DUF downsampling) the first
    # windows' items
    t0 = time.perf_counter()
    for i in range(ITEMS_TIMED):
        loader.dataset[i]
    item_ms = (time.perf_counter() - t0) / ITEMS_TIMED * 1e3
    on_card = torch.device(device).type == 'cuda'
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.validation(loader, opt['name'], None, opt['val']['save_img'])
    sync(device)
    secs = time.perf_counter() - t0
    vis = osp.join(opt['path']['visualization'], dataset_opt['name'])
    frames = len(loader.dataset)
    psnr = {folder: table[:, 0].tolist()
            for folder, table in model.metric_results.items()}
    readings = dict(
        yml=f'options/test/{TEST_YML[name]}', network=opt['network_g'],
        frames=frames, lq_shape=list(lq.shape[1:]),
        out_hw=list(loader.dataset[0]['gt'].shape[1:]),
        ms_per_frame=secs / frames * 1e3, network_ms_per_frame=net_ms,
        item_ms_per_frame=item_ms,
        peak_mem_bytes=torch.cuda.max_memory_allocated() if on_card
        else None,
        saved=sum(len(fs) for _, _, fs in os.walk(vis)), psnr=psnr)
    return model, loader, readings


def profile_window(net, lq, top=10):
    """One call of ``net`` on ``lq`` under torch.profiler: its wall ms, the
    device ms of all its kernels and of its ``top`` kernels by name."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net(lq)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, 'self_device_time_total', None)
            if us is None:
                us = e.self_cuda_time_total
            kernels[e.key[:100]] = (us / 1e3, e.count)
    top_kernels = dict(sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top])
    return dict(wall_ms=wall, kernel_ms=sum(v[0] for v in kernels.values()),
                kernel_launches=sum(v[1] for v in kernels.values()),
                top_kernels_ms_count=top_kernels)


def reckoned_tflop(net_opt, *shapes):
    """TFLOP of one call of ``net_opt``'s network on inputs of ``shapes``,
    counted by ``torch.utils.flop_counter`` on the meta device (from the
    shapes alone, nothing computed); a multiply-add is two."""
    from torch.utils.flop_counter import FlopCounterMode

    from edvr_tpu_torch.archs import define_network
    net = define_network(dict(net_opt)).to('meta').eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(*(torch.empty(s, device='meta') for s in shapes))
    return counter.get_total_flops() / 1e12


def child(spec):
    """One cuDNN choice (in this process, which must not have run a
    convolution): each YAML's network on the first window of the tree at
    ``spec['root']``, its ms per call, its kernels and its reckoned TFLOP
    and TFLOP/s; SpyNet's TFLOP on a VID4_GT pair."""
    from edvr_tpu_torch.data import create_dataset
    from edvr_tpu_torch.tools.ablate_dcn import cuda_ms
    for key, value in POLICIES[spec['policy']].items():
        os.environ.setdefault(key, value)
    out = dict(policy=spec['policy'], cudnn_env=POLICIES[spec['policy']])
    os.chdir(spec['root'])
    for name in TEST_YML:
        opt = options(name, 'cuda')
        lq = create_dataset(opt['datasets']['test_1'])[0]['lq'][None].cuda()
        net = seeded_network(opt['network_g']).cuda()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = cuda_ms(lambda: net(lq), iters=WINDOW_CALLS)
        tflop = reckoned_tflop(opt['network_g'], lq.shape)
        out[name] = dict(window_ms=ms, lq_shape=list(lq.shape[1:]),
                         peak_mem_bytes=torch.cuda.max_memory_allocated(),
                         tflop=tflop, tflop_per_s=tflop / ms * 1e3,
                         profile=profile_window(net, lq))
        del net, lq
    pair = (1, 3, *VID4_GT)
    out['SpyNet'] = dict(hw=list(VID4_GT), tflop=reckoned_tflop(
        {'type': 'SpyNet'}, pair, pair))
    return out


def smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--policy', nargs='+', default=list(POLICIES),
                        choices=list(POLICIES))
    parser.add_argument('--out', default=None)
    parser.add_argument('--child', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('video_families: needs a CUDA card', file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(json.loads(args.child))), flush=True)
        return 0
    card = smi()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        write_vid4_tree(osp.join(tmp, 'datasets', 'Vid4'))
        env = {k: v for k, v in os.environ.items()
               if k not in INFERENCE_CUDNN_ENV}
        env['PYTHONPATH'] = os.pathsep.join(
            [REPO, os.environ.get('PYTHONPATH', '')])
        for policy in args.policy:
            spec = dict(policy=policy, root=tmp)
            proc = subprocess.run(
                [sys.executable, '-m', 'edvr_tpu_torch.tools.video_families',
                 '--child', json.dumps(spec)], cwd=tmp, env=env,
                capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f'{policy} failed (exit '
                                   f'{proc.returncode}):\n'
                                   f'{proc.stderr[-4000:]}')
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
