"""StyleGAN2 training on a CUDA card through the training CLI's code path:
ms per iteration (plain, with path-length regularisation, with both
regularisers, and amortised over a 16-iteration cycle) and peak memory of
the shipped 256 Cmul2 YAML, under each cuDNN choice.

    python -m edvr_tpu_torch.tools.stylegan2 [--policy default capped]
        [--out FILE] [--profile]

Writes ``IMAGES`` seeded 256 px PNGs named as FFHQ's
(``tools/synthetic.py::write_ffhq_tree``), then runs each cuDNN choice in
a child process of its own, because cuDNN's choice is read once per
process: ``default`` is PyTorch's (the training CLI's for StyleGAN2,
``train.train_cudnn_env``), ``capped`` the test CLI's
(``test.INFERENCE_CUDNN_ENV``). The child parses
``options/train/StyleGAN/train_StyleGAN2_256_Cmul2_FFHQ.yml`` as the CLI
does with the cuts of :data:`CUTS` (``--force_yml``), builds the dataset
and ``create_model``, feeds the global batch of 24 (3 x 8 GPUs in one
process) read by ``FFHQDataset``, runs one 16-iteration cycle to warm up
and times the next (:func:`run_cycle`: host clock around ``feed_data`` +
``optimize_parameters`` ending in ``torch.cuda.synchronize()``). Prints
one JSON line per choice and the card's name and power limit; with
``--profile`` also, for one iteration of each kind, the device time of
its top kernels and of its top operators (``torch.profiler``,
:func:`profile_iteration`). The set-up,
the cycle and the gradient pair (:func:`grad_pair`) are also those of
``chip_smoke.py``'s stylegan2 phases.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time

import torch

from edvr_tpu_torch.test import INFERENCE_CUDNN_ENV

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
YML = osp.join(REPO, 'options', 'train', 'StyleGAN',
               'train_StyleGAN2_256_Cmul2_FFHQ.yml')
IMAGES = 48   # seeded FFHQ-named PNGs: two global batches
CYCLE = 16    # net_d_reg_every: R1 once a cycle, path length every 4
POLICIES = {'default': {}, 'capped': INFERENCE_CUDNN_ENV}
CUTS = ['datasets.train.io_backend: lmdb (not ported, ROADMAP A.9; no '
        'lmdb module on the card\'s machine) -> disk',
        f'datasets.train.dataroot_gt: FFHQ (not in the repository) -> '
        f'{IMAGES} seeded 256 px PNGs named as FFHQ\'s',
        'datasets.train.num_worker_per_gpu: 6 x 8 -> 0 (the items are '
        'read by FFHQDataset in this process)',
        'network weights: the option file\'s seed (trained from scratch, '
        'as the YAML does)']


def options(device, root):
    """The shipped YAML parsed as the training CLI parses it, with the
    cuts of :data:`CUTS`."""
    from edvr_tpu_torch.train import parse_options
    return parse_options(True, [
        '-opt', YML, '--device', device, '--force_yml',
        'datasets:train:io_backend={type: disk}',
        f'datasets:train:dataroot_gt={root}',
        'datasets:train:num_worker_per_gpu=0'])


def build(root, device='cuda', policy='default'):
    """The cuDNN choice (before any convolution), the options, the
    training set and the engine. Returns (opt, cudnn env, dataset,
    model)."""
    from edvr_tpu_torch.data import create_dataset
    from edvr_tpu_torch.models import create_model
    env = POLICIES[policy]
    for key, value in env.items():
        os.environ.setdefault(key, value)
    opt = options(device, root)
    d_opt = dict(opt['datasets']['train'], phase='train',
                 seed=opt['manual_seed'])
    return opt, env, create_dataset(d_opt), create_model(opt)


def batch_of(dataset, opt, start=0, num_images=IMAGES):
    """One global batch (``batch_size_per_gpu`` x ``num_gpu``) of dataset
    items ``start``, ``start + 1``, ... (modulo ``num_images``, the PNGs
    on disk)."""
    d = opt['datasets']['train']
    n = d['batch_size_per_gpu'] * max(opt['num_gpu'], 1)
    items = [dataset[(start + i) % num_images] for i in range(n)]
    return {'gt': torch.stack([it['gt'] for it in items])}


def kind_of(model, it):
    r1 = it % model.net_d_reg_every == 0
    path = it % model.net_g_reg_every == 0
    return {(False, False): 'plain', (False, True): 'path',
            (True, False): 'r1', (True, True): 'both'}[(r1, path)]


def run_cycle(model, batches, start, iters=CYCLE):
    """Iterations ``start`` .. ``start + iters - 1`` (each fed the next of
    ``batches`` in turn), each timed on the host clock around ``feed_data``
    + ``optimize_parameters`` ending in a synchronise. Returns the
    readings: ms per iteration by kind (the median of each), the
    amortised ms (the cycle's total over ``iters``), the peak memory of
    the cycle, and every iteration's log."""
    sync = torch.cuda.synchronize if model.device.type == 'cuda' else (
        lambda: None)
    on_card = model.device.type == 'cuda'
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    by_kind, logs, total = {}, [], 0.
    for i, it in enumerate(range(start, start + iters)):
        sync()
        t0 = time.perf_counter()
        model.feed_data(batches[i % len(batches)])
        model.optimize_parameters(it)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        total += ms
        by_kind.setdefault(kind_of(model, it), []).append(ms)
        logs.append(model.get_current_log())
    med = {k: sorted(v)[len(v) // 2] for k, v in by_kind.items()}
    return dict(iters=[start, start + iters - 1],
                ms_per_iter={k: med[k] for k in sorted(med)},
                ms_all={k: v for k, v in sorted(by_kind.items())},
                ms_amortised=total / iters,
                peak_mem_bytes=torch.cuda.max_memory_allocated()
                if on_card else None, logs=logs)


def grad_pair(model, real, seed=0):
    """The D, R1, G and path-length gradients of the engine's networks on
    ``real`` (a small batch), with explicit noise (codes, injected noise
    and path noise drawn from ``seed`` on the CPU), computed as the engine
    computes them (no mixing, mean path length 0) on the engine's device,
    on the CPU in float32 and on the CPU in float64. Returns {'card' |
    'cpu' | 'fp64': {'d' | 'r1' | 'g' | 'path': {name: float64 grad on the
    CPU}}}."""
    from edvr_tpu_torch.models.losses import g_path_regularize, r1_penalty
    gen = torch.Generator().manual_seed(seed)
    net_g = model.net_g
    b, size = real.shape[0], real.shape[-1]
    z = torch.randn(b, net_g.num_style_feat, generator=gen)
    noise = [torch.randn(b, 1, 2**((i + 5) // 2), 2**((i + 5) // 2),
                         generator=gen) for i in range(net_g.num_layers)]
    path_noise = torch.randn(b, 3, size, size, generator=gen) / size
    cri = model.cri_gan
    runs = {'card': (model.net_g, model.net_d, model.device, torch.float32),
            'cpu': (None, None, torch.device('cpu'), torch.float32),
            'fp64': (None, None, torch.device('cpu'), torch.float64)}
    out = {}
    for name, (g, d, device, dtype) in runs.items():
        if g is None:
            g = copy.deepcopy(model.net_g).to(device, dtype)
            d = copy.deepcopy(model.net_d).to(device, dtype)
        g_params, d_params = list(g.parameters()), list(d.parameters())
        cast = lambda t: t.to(device, dtype)  # noqa: E731
        nz = [cast(n) for n in noise]
        x = cast(real)

        def grads(loss, params, names):
            gs = torch.autograd.grad(loss, params, allow_unused=True)
            return {n: (torch.zeros_like(p) if gr is None else gr).detach()
                    .cpu().double() for n, p, gr in zip(names, params, gs)}

        g_names = [n for n, _ in g.named_parameters()]
        d_names = [n for n, _ in d.named_parameters()]
        res = {}
        with torch.no_grad():
            fake, _ = g([cast(z)], noise=nz)
        res['d'] = grads(cri(d(x), True, is_disc=True)
                         + cri(d(fake), False, is_disc=True), d_params,
                         d_names)
        xr = x.detach().requires_grad_(True)
        res['r1'] = grads(r1_penalty(d(xr), xr), d_params, d_names)
        d.requires_grad_(False)
        fake, _ = g([cast(z)], noise=nz)
        res['g'] = grads(cri(d(fake), True, is_disc=False), g_params,
                         g_names)
        latent = g.style_mlp(cast(z))[:, None].repeat(1, g.num_latent, 1)
        img, _ = g([latent], input_is_latent=True, noise=nz)
        pen, _, _ = g_path_regularize(img, latent, cast(path_noise),
                                      torch.zeros((), device=device,
                                                  dtype=dtype))
        res['path'] = grads(pen, g_params, g_names)
        d.requires_grad_(True)
        out[name] = res
        del g, d
    return out


def profile_iteration(model, batch, it, top=12):
    """Iteration ``it`` under torch.profiler: its wall ms, the device ms
    of all its kernels, of its ``top`` kernels by name, and of its ``top``
    operators by device time (children included, so nested operators
    overlap)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    model.feed_data(batch)
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.optimize_parameters(it)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, ops = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, 'self_device_time_total', None)
            if us is None:
                us = e.self_cuda_time_total
            kernels[e.key[:100]] = (us / 1e3, e.count)
            continue
        us = getattr(e, 'device_time_total', None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            ops[e.key[:80]] = (us / 1e3, e.count)

    def order(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1][0])[:top])

    return dict(iteration=it, kind=kind_of(model, it), wall_ms=wall,
                kernel_ms=sum(v[0] for v in kernels.values()),
                kernel_launches=sum(v[1] for v in kernels.values()),
                top_kernels_ms_count=order(kernels),
                top_ops_ms_count=order(ops))


def child(spec):
    """One cuDNN choice (in this process, which must not have run a
    convolution): returns its readings."""
    opt, env, dataset, model = build(spec['root'], 'cuda', spec['policy'])
    batches = [batch_of(dataset, opt, i * 24) for i in range(2)]
    run_cycle(model, batches, 1)
    r = run_cycle(model, batches, 1 + CYCLE)
    r.pop('logs')
    if spec.get('profile'):
        start = 1 + 2 * CYCLE
        r['profile'] = [profile_iteration(model, batches[0], it)
                        for it in (start, start + 3, start + CYCLE - 1)]
    return dict(spec, root=None, cudnn_env=env, cuts=CUTS,
                batch=tuple(batches[0]['gt'].shape),
                cudnn_version=torch.backends.cudnn.version(), **r)


def smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    from edvr_tpu_torch.tools.synthetic import write_ffhq_tree
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--policy', nargs='+', default=list(POLICIES),
                        choices=list(POLICIES))
    parser.add_argument('--out', default=None)
    parser.add_argument('--profile', action='store_true',
                        help='profile one iteration of each kind')
    parser.add_argument('--child', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('stylegan2: needs a CUDA card', file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(json.loads(args.child))), flush=True)
        return 0
    card = smi()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        root = write_ffhq_tree(osp.join(tmp, 'ffhq'), IMAGES)
        env = {k: v for k, v in os.environ.items()
               if k not in INFERENCE_CUDNN_ENV}
        env['PYTHONPATH'] = os.pathsep.join(
            [REPO, os.environ.get('PYTHONPATH', '')])
        for policy in args.policy:
            spec = dict(policy=policy, root=root, profile=args.profile)
            proc = subprocess.run(
                [sys.executable, '-m', 'edvr_tpu_torch.tools.stylegan2',
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
