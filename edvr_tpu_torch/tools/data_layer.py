"""The training data layer on a CUDA card: packed REDS through the training
CLI's functions with each prefetcher, and the loader's throughput.

    python -m edvr_tpu_torch.tools.data_layer [--out FILE]

writes a seeded REDS clip of 100 frames at REDS's size (GT 720x1280, LQ
180x320) as PNGs and as ``.tpak`` files, and prints the loader's items per
second (``REDSDataset`` from the PNGs, ``REDSPackedDataset`` from the
packed files) at the shipped EDVR-M crop (GT 256, 5 frames) with
``num_worker_per_gpu`` as shipped and with 0, in one JSON line with the
host's CPU count: after the batches the workers make ahead are taken, the
median of WINDOWS windows of WINDOW_S seconds each, and their spread. The functions are also ``chip_smoke.py``'s data_train
and loader_throughput phases: :func:`write_packed_reds`,
:func:`train_args`, :func:`build`, :func:`run_steps`,
:func:`loader_items_per_s`.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from edvr_tpu_torch.tools.synthetic import seeded_clip, write_png

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
EDVR_M_YML = osp.join(REPO, 'options', 'train', 'EDVR',
                      'train_EDVR_M_x4_SR_REDS.yml')
LQ_HW = (180, 320)  # REDS's LQ frame size (GT 720x1280)
SCALE = 4
# clips of the packed training set: outside REDS4's partition (000, 011,
# 015, 020), so the dataset keeps them all
PACKED_CLIPS = ('001', '002', '003', '004')
PACKED_FRAMES = 12
# the loader's timed windows and their length in seconds: some hundreds
# of packed batches, some tens of PNG ones, a window
WINDOWS = 3
WINDOW_S = 3.0


def _uint8_bgr(frames):
    """(T, 3, h, w) RGB in [0, 1] -> (T, h, w, 3) uint8 BGR, as cv2 reads
    a PNG of it (``synthetic.write_png``'s rounding)."""
    return (frames.permute(0, 2, 3, 1).numpy()[..., ::-1] * 255.).round(
    ).astype(np.uint8)


def write_packed_reds(root, seed=0, clips=PACKED_CLIPS, frames=PACKED_FRAMES,
                      lq_hw=LQ_HW):
    """Seeded REDS-layout clips (``frames`` frames of LQ ``lq_hw``, GT x4)
    as ``root/gt.tpak`` and ``root/lq.tpak``, written by the port's
    ``write_tpak``. Returns (gt path, lq path)."""
    from edvr_tpu_torch.native.tpak import write_tpak
    os.makedirs(root, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    data = {}
    for clip in clips:
        lq, gt = seeded_clip(frames, *lq_hw, gen)
        data[clip] = (_uint8_bgr(gt), _uint8_bgr(lq))
    paths = []
    for i, sub in enumerate(('gt', 'lq')):
        path = osp.join(root, f'{sub}.tpak')
        write_tpak(path, [(clip, pair[i]) for clip, pair in data.items()])
        paths.append(path)
    return tuple(paths)


def write_reds_clip(root, seed=0, lq_hw=LQ_HW):
    """One seeded 100-frame REDS clip ``001`` at ``lq_hw`` (GT x4) as
    ``root/{gt,lq}/001/<frame>.png`` with ``root/meta_info.txt``, and the
    same frames as ``root/{gt,lq}.tpak``. Returns ``root``."""
    from edvr_tpu_torch.native.tpak import write_tpak
    gen = torch.Generator().manual_seed(seed)
    lq, gt = seeded_clip(100, *lq_hw, gen)
    for sub, frames in (('gt', gt), ('lq', lq)):
        for i, frame in enumerate(frames):
            write_png(osp.join(root, sub, '001', f'{i:08d}.png'), frame)
        write_tpak(osp.join(root, f'{sub}.tpak'), [('001',
                                                     _uint8_bgr(frames))])
    with open(osp.join(root, 'meta_info.txt'), 'w') as f:
        f.write(f'001 100 ({SCALE * lq_hw[0]},{SCALE * lq_hw[1]},3)\n')
    return root


def train_args(gt_pak, lq_pak, golden_pth, mode, device='cuda'):
    """``-opt`` and ``--force_yml`` cuts of a run of the shipped EDVR-M
    training YAML on the packed files with ``prefetch_mode`` ``mode``:
    (args, cuts). Validation is taken out of the parsed options
    (:func:`build`)."""
    forces = {
        'num_gpu': '1',
        'path:pretrain_network_g': golden_pth,
        'datasets:train:type': 'REDSPackedDataset',
        'datasets:train:dataroot_gt': gt_pak,
        'datasets:train:dataroot_lq': lq_pak,
        'datasets:train:meta_info_file': '~',
        'datasets:train:prefetch_mode': mode,
    }
    cuts = [
        'path.pretrain_network_g -> the golden EDVR-M weights '
        '(tests/data/golden/arch_edvr_m_full.npz; the woTSA checkpoint is '
        'not in the repo)',
        'num_gpu 8 -> 1 (batch_size_per_gpu 4: batch 4)',
        'datasets.train: REDSDataset on REDS -> REDSPackedDataset on a '
        f'seeded .tpak of {len(PACKED_CLIPS)} clips x {PACKED_FRAMES} '
        f'frames, LQ {LQ_HW[0]}x{LQ_HW[1]} (clips {", ".join(PACKED_CLIPS)}'
        ', outside REDS4)',
        f'datasets.train.prefetch_mode: null -> {mode}',
        'datasets.val and val: taken out (no REDS4 clips in the repo)',
    ]
    args = ['-opt', EDVR_M_YML, '--device', device, '--force_yml',
            *(f'{k}={v}' for k, v in forces.items())]
    return args, cuts


def build(args):
    """A run as ``python -m edvr_tpu_torch.train`` sets it up:
    ``parse_options``, the cuDNN choice, ``create_train_val_dataloader``
    (validation taken out), ``create_model`` and ``create_prefetcher``.
    Returns (opt, cudnn env, train sampler, model, prefetcher)."""
    from edvr_tpu_torch import train
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.utils import get_root_logger
    opt = train.parse_options(is_train=True, args=args)
    opt['datasets'].pop('val', None)
    opt.pop('val', None)
    env = train.use_train_cudnn_policy(opt)
    train_loader, sampler, _, _, _ = train.create_train_val_dataloader(
        opt, get_root_logger())
    model = create_model(opt)
    return opt, env, sampler, model, train.create_prefetcher(opt,
                                                             train_loader)


def run_steps(model, sampler, prefetcher, steps, warmup=1):
    """``warmup`` + ``steps`` training steps as the CLI's loop takes them
    (``set_epoch``, ``reset``, ``next``, ``feed_data``,
    ``optimize_parameters``), the timed ones by the host clock around work
    that ends in ``torch.cuda.synchronize()``. Returns the readings and,
    per step, the batch as the model holds it (on the CPU), whether
    ``feed_data`` kept the prefetcher's tensors (no second copy) and the
    kernel launches."""
    from edvr_tpu_torch import native
    sampler.set_epoch(0)
    prefetcher.reset()
    secs, losses, launches, fed, kept = [], [], [], [], []
    for it in range(1, warmup + steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = prefetcher.next()
        before = dict(native.LAUNCHES)
        model.feed_data(batch)
        kept.append(model.lq.data_ptr() == batch['lq'].data_ptr()
                    and model.gt.data_ptr() == batch['gt'].data_ptr())
        model.optimize_parameters(it)
        torch.cuda.synchronize()
        if it > warmup:
            secs.append(time.perf_counter() - t0)
        launches.append({k: v - before[k] for k, v in native.LAUNCHES.items()
                         if v != before[k]})
        losses.append(float(model.log_dict['l_pix']))
        fed.append((batch['key'], model.lq.cpu(), model.gt.cpu()))
    ms = sorted(s * 1e3 for s in secs)
    return dict(ms_per_step_median=ms[len(ms) // 2],
                ms_per_step_all=[s * 1e3 for s in secs],
                batch_lq=list(model.lq.shape), losses=losses,
                launches=launches, feed_kept_tensors=kept), fed


def loader_items_per_s(dataset_opt, workers, windows=WINDOWS,
                       seconds=WINDOW_S, seed=0):
    """Items per second of the training loader (batch 4, ``workers``
    worker processes) on the host, ``dataset_opt`` a training dataset's
    options. The clock starts once the batches that the workers make
    before the first is taken (``workers`` x the loader's
    ``prefetch_factor``, at least one) have been taken, so that no timed
    batch was made before it; then ``windows`` windows, each as many
    batches as fill ``seconds``. Returns their median and every window's
    rate."""
    from edvr_tpu_torch.data import (EnlargedSampler, create_dataloader,
                                     create_dataset)
    opt = dict(dataset_opt, num_worker_per_gpu=workers, batch_size_per_gpu=4,
               phase='train')
    dataset = create_dataset(dict(opt, seed=seed))
    loader = create_dataloader(dataset, opt, sampler=EnlargedSampler(
        dataset, 1, 0, 1000), seed=seed)
    it = iter(loader)
    ahead = max(1, workers * (loader.prefetch_factor or 0))
    for _ in range(ahead):
        next(it)
    rates, counts = [], []
    for _ in range(windows):
        n = 0
        t0 = time.perf_counter()
        while True:
            batch = next(it)
            n += 1
            secs = time.perf_counter() - t0
            if secs >= seconds:
                break
        rates.append(n * 4 / secs)
        counts.append(n * 4)
    del it, loader
    return dict(items_per_s=sorted(rates)[len(rates) // 2],
                items_per_s_all=rates, items_per_window=counts,
                batches_before_clock=ahead, window_s=seconds,
                lq=list(batch['lq'].shape[1:]), gt=list(batch['gt'].shape[1:]))


def throughput(root, windows=WINDOWS, seconds=WINDOW_S):
    """The loader's items per second for REDSDataset (PNGs) and
    REDSPackedDataset on :func:`write_reds_clip`'s tree, at the shipped
    crop, with the shipped workers and with 0 (:func:`loader_items_per_s`).
    Returns a dict."""
    import yaml
    with open(EDVR_M_YML) as f:
        shipped = yaml.safe_load(f)['datasets']['train']
    base = dict(shipped, scale=SCALE, name='REDS')
    opts = {'REDSDataset': dict(base, dataroot_gt=osp.join(root, 'gt'),
                                dataroot_lq=osp.join(root, 'lq'),
                                meta_info_file=osp.join(root,
                                                        'meta_info.txt')),
            'REDSPackedDataset': dict(base, type='REDSPackedDataset',
                                      dataroot_gt=osp.join(root, 'gt.tpak'),
                                      dataroot_lq=osp.join(root, 'lq.tpak'))}
    out = {}
    for name, opt in opts.items():
        for workers in (shipped['num_worker_per_gpu'], 0):
            out[f'{name}_w{workers}'] = loader_items_per_s(
                opt, workers, windows, seconds)
    return dict(runs=out, cpus=os.cpu_count(), gt_size=base['gt_size'],
                num_frame=base['num_frame'], lq_frame=list(LQ_HW),
                batch=4)


def main(argv=None):
    import tempfile
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        result = throughput(write_reds_clip(tmp))
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
