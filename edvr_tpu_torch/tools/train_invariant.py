"""The fixed-batch learning invariant of EDVR training, the port's twin of
``scripts/dev/train_fast_invariant.py``::

    python -m edvr_tpu_torch.tools.train_invariant [--iters 900] [--seed 10]
        [--mp] [--calibrate] [--device cuda] [--out FILE]

trains a small EDVR (32 features, 5 frames, 4 deformable groups, 2 extract
and 4 reconstruct blocks, TSA, ``tsa_iter`` = iters // 10, Adam 4e-4 under
a cosine schedule, Charbonnier loss) on REDSDataset batches of 8 with 96 px
GT crops from three seeded 100-frame clips of a textured canvas moving 1-2
px a frame (:func:`make_video_dataset`, the LQ frames by the port's MATLAB
``imresize``). The first batch is held aside; every EVAL_EVERY iterations
the centre frame's PSNR on it is read (the network in eval mode, fp32).
With sampling noise removed, that curve rises from the first hundred
iterations, and a broken step (dead gradients, a wrong TSA mask, a DCN
backward fault) flattens it.

Two gates, calibrated by the JAX package on a TPU (its docstring: a total
gain of +0.93 / +0.86 dB and +0.30 / +0.33 after the warm-up at seeds 10 /
17): a total gain at 900 iterations of at least GATE_TOTAL_DB, and a gain
from iteration 100 to the last of at least GATE_POSTWARM_DB. The second
exists because the first ``tsa_iter`` iterations train only TSA's fusion:
a step that kills the other gradients would still bank the warm-up's gain.
``--mp`` runs the step under ``train.mixed_precision: bf16`` (the shipped
YAMLs' precision), same gates. ``--calibrate`` prints the curve without
the gates. Prints one JSON line with the curve, the gains, ms per
iteration and the card's name.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import tempfile
import time

import numpy as np
import torch

GATE_TOTAL_DB = 0.4
GATE_POSTWARM_DB = 0.1
EVAL_EVERY = 100
CLIP_FRAMES = 100  # REDSDataset draws centres from a 100-frame clip

# the JAX script's configuration; :func:`run`'s ``size`` cuts it
SIZE = dict(hw=96, clips=3, batch=8,
            net=dict(num_feat=32, deformable_groups=4, num_extract_block=2,
                     num_reconstruct_block=4))


def make_video_dataset(root, num_clips=3, frames=CLIP_FRAMES, hw=96,
                       scale=4, seed=0):
    """Clips of a textured canvas translating 1-2 px a frame, so that the
    neighbours carry sub-pixel detail the centre frame lacks; GT PNGs of
    ``hw`` px and their x1/``scale`` LQ by MATLAB's bicubic ``imresize``,
    with ``meta.txt`` (a copy of
    ``scripts/dev/train_edvr_smoke.py::make_video_dataset``)."""
    import cv2

    from edvr_tpu_torch.utils.matlab_functions import imresize
    rng = np.random.RandomState(seed)
    big = cv2.GaussianBlur(rng.rand(hw * 3, hw * 3, 3).astype(np.float32),
                           (5, 5), 1.0)
    big = np.clip(big / big.max(), 0, 1)
    for clip in range(num_clips):
        gt_dir = osp.join(root, 'train_sharp', f'{clip:03d}')
        lq_dir = osp.join(root, 'train_sharp_bicubic', f'{clip:03d}')
        os.makedirs(gt_dir, exist_ok=True)
        os.makedirs(lq_dir, exist_ok=True)
        x0, y0 = hw, hw
        vx, vy = rng.randint(1, 3), rng.randint(1, 3)
        for f in range(frames):
            gx = (x0 + f * vx) % (hw * 2)
            gy = (y0 + f * vy) % (hw * 2)
            gt = big[gy:gy + hw, gx:gx + hw]
            lq = np.clip(imresize(gt, 1.0 / scale), 0, 1)
            cv2.imwrite(osp.join(gt_dir, f'{f:08d}.png'),
                        (gt * 255).round().astype(np.uint8))
            cv2.imwrite(osp.join(lq_dir, f'{f:08d}.png'),
                        (lq * 255).round().astype(np.uint8))
    with open(osp.join(root, 'meta.txt'), 'w') as fh:
        for clip in range(num_clips):
            fh.write(f'{clip:03d} {frames} ({hw},{hw},3)\n')


def options(root, workdir, iters, seed, mp, device, size):
    """The training dataset's and the engine's options."""
    dataset_opt = dict(
        name='REDS', type='REDSDataset', phase='train', scale=4,
        dataroot_gt=f'{root}/train_sharp',
        dataroot_lq=f'{root}/train_sharp_bicubic',
        dataroot_flow=None, meta_info_file=f'{root}/meta.txt',
        val_partition='REDS4', io_backend=dict(type='disk'),
        num_frame=5, gt_size=size['hw'], interval_list=[1],
        random_reverse=False, use_flip=True, use_rot=True,
        use_shuffle=True, num_worker_per_gpu=0,
        batch_size_per_gpu=size['batch'], dataset_enlarge_ratio=100,
        prefetch_mode=None, seed=seed)
    opt = {
        'name': 'edvr_invariant', 'model_type': 'EDVRModel', 'scale': 4,
        'num_gpu': 1, 'manual_seed': seed, 'is_train': True, 'dist': False,
        'rank': 0, 'world_size': 1, 'device': device,
        'datasets': {'train': dataset_opt},
        'network_g': dict(type='EDVR', num_in_ch=3, num_out_ch=3,
                          num_frame=5, center_frame_idx=None, hr_in=False,
                          with_predeblur=False, with_tsa=True, **size['net']),
        'path': dict(pretrain_network_g=None, strict_load_g=False,
                     resume_state=None, root=workdir,
                     experiments_root=workdir, models=workdir,
                     training_states=workdir, log=workdir,
                     visualization=workdir),
        'train': dict(
            optim_g=dict(type='Adam', lr=4e-4, weight_decay=0,
                         betas=[0.9, 0.99]),
            scheduler=dict(type='CosineAnnealingRestartLR',
                           periods=[max(iters, 600)], restart_weights=[1],
                           eta_min=1e-6),
            total_iter=iters, warmup_iter=10,
            tsa_iter=max(iters // 10, 1), dcn_lr_mul=1,
            pixel_opt=dict(type='CharbonnierLoss', loss_weight=1.0,
                           reduction='mean'),
            mixed_precision='bf16' if mp else None),
        'val': None,
        'logger': dict(print_freq=10**9, save_checkpoint_freq=10**9,
                       use_tb_logger=False),
    }
    return dataset_opt, opt


def run(iters=900, seed=10, mp=False, device='cuda', size=None, log=print):
    """Train and read the fixed batch's PSNR curve. Returns the curve
    ([(iteration, dB)]), the total and post-warm-up gains, whether each
    gate holds, and ms per training iteration (the host clock around all
    of them, the evaluations taken out; on a card, ending in a
    synchronise). ``size`` cuts :data:`SIZE` (the JAX script's)."""
    from edvr_tpu_torch.data import create_dataloader, create_dataset
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.utils import set_random_seed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = torch.device(device).type == 'cuda'
    size = size or SIZE

    def sync():
        if on_card:
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory(prefix='edvr_invariant_') as workdir:
        root = osp.join(workdir, 'reds')
        make_video_dataset(root, num_clips=size['clips'], hw=size['hw'],
                           seed=0)
        dataset_opt, opt = options(root, workdir, iters, seed, mp, device,
                                   size)
        set_random_seed(seed)
        dataset = create_dataset(dataset_opt)
        loader = create_dataloader(dataset, dataset_opt, seed=seed)
        model = create_model(opt)
        # the held-aside batch: sampling noise removed, the PSNR trend is
        # the learning signal itself
        eval_batch = next(iter(loader))
        gt = eval_batch['gt'].double()

        def eval_psnr():
            model.feed_data({'lq': eval_batch['lq']})
            model.test()
            out = model.output.detach().cpu().double().clamp(0, 1)
            return float(-10.0 * torch.log10((out - gt).square().mean()))

        t0 = time.perf_counter()
        curve = [(0, eval_psnr())]
        log(f'iter {0:4d}  eval PSNR {curve[-1][1]:.3f} dB')
        it, train_s = 0, 0.0
        while it < iters:
            sync()
            t = time.perf_counter()
            for batch in loader:
                it += 1
                if it > iters:
                    break
                model.feed_data(batch)
                model.optimize_parameters(it)
                if it % EVAL_EVERY == 0 or it == iters:
                    sync()
                    train_s += time.perf_counter() - t
                    curve.append((it, eval_psnr()))
                    log(f'iter {it:4d}  eval PSNR {curve[-1][1]:.3f} dB  '
                        f'({time.perf_counter() - t0:.0f}s)')
                    t = time.perf_counter()
            sync()
            train_s += time.perf_counter() - t
    points = dict(curve)
    total = curve[-1][1] - curve[0][1]
    postwarm = curve[-1][1] - points.get(EVAL_EVERY, curve[0][1])
    return dict(iters=iters, seed=seed,
                mixed_precision='bf16' if mp else None, device=str(device),
                curve=curve, total_gain_db=total, postwarm_gain_db=postwarm,
                gate_total_db=GATE_TOTAL_DB,
                gate_postwarm_db=GATE_POSTWARM_DB,
                total_ok=total >= GATE_TOTAL_DB,
                postwarm_ok=postwarm >= GATE_POSTWARM_DB,
                ms_per_iter=train_s * 1e3 / iters)


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--iters', type=int, default=900,
                        help='the gates are calibrated at 900; at least '
                        f'{EVAL_EVERY}, so that the post-warm-up gate has '
                        f'its iteration-{EVAL_EVERY} point')
    parser.add_argument('--seed', type=int, default=10,
                        help='initialisation, sampling and eval-batch seed '
                        '(the data stay seed 0); calibrated at 10 and 17')
    parser.add_argument('--mp', action='store_true',
                        help='train under mixed_precision: bf16')
    parser.add_argument('--calibrate', action='store_true',
                        help='print the curve without the gates')
    parser.add_argument('--device', default='cuda',
                        help="torch device (default 'cuda')")
    parser.add_argument('--out', default=None,
                        help='also write the JSON line to this file')
    args = parser.parse_args(args)
    if not args.calibrate and args.iters < EVAL_EVERY:
        parser.error(f'--iters must be >= {EVAL_EVERY}: without the '
                     f'iteration-{EVAL_EVERY} point the post-warm-up gate '
                     'would fall into the total one')
    if torch.device(args.device).type == 'cuda' and \
            not torch.cuda.is_available():
        raise RuntimeError(f'--device {args.device}: CUDA is not available')
    result = run(args.iters, args.seed, args.mp, args.device,
                 log=lambda msg: print(msg, flush=True))
    if torch.device(args.device).type == 'cuda':
        result['card'] = torch.cuda.get_device_name(0)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    if args.calibrate:
        return result
    if not result['total_ok']:
        raise SystemExit(
            f'learning invariant failed: fixed-batch PSNR gain '
            f'{result["total_gain_db"]:+.3f} dB < +{GATE_TOTAL_DB}')
    if not result['postwarm_ok']:
        raise SystemExit(
            f'learning invariant failed: post-warm-up gain '
            f'{result["postwarm_gain_db"]:+.3f} dB < +{GATE_POSTWARM_DB} '
            '(the TSA warm-up learned, the full model did not)')
    print('OK: the learning invariant holds.', flush=True)
    return result


if __name__ == '__main__':
    main()
