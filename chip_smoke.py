"""Smoke run of the edvr_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's two paths at EDVR-M x4 full width (64 features, 5
frames, dg=8, 5+10 blocks, TSA, fp32 with TF32 off): whole-clip inference
(``options/test/EDVR/test_EDVR_M_x4_SR_REDS.yml``, window mode,
win_batch=1) and training (``options/train/EDVR/train_EDVR_M_x4_SR_REDS.yml``),
and checks every hand-written kernel of those paths against its plain
PyTorch version. Phases, each printing one flushed JSON line with its
``seconds``:

1. device: the card's name and power limit;
2. build: nvcc builds every kernel from ``edvr_tpu_torch/csrc``;
3. kernel_<level>: the DCNv2 kernel against the plain version at the
   EDVR-M pyramid levels L1/L2/L3 (n=5 frames of a 180x320 clip), with
   offsets beyond +-10 px; its time by CUDA events beside the bound;
4. golden: the reference's full-width EDVR-M output
   (tests/data/golden/arch_edvr_m_full.npz) reproduced on the card;
5. main_path: a seeded 12-frame 180x320 clip restored through
   ``create_model`` and the engine's ``_clip_validation``, scored by PSNR;
   the launch counts are zeroed just before and read just after it. The
   network alone is then timed over the same clip, and one window is
   checked against the plain CPU path;
6. kernel_bwd_<level>: the DCNv2 backward kernel (dx, d_offset, d_mask,
   dW) against autograd through the plain version, and the forward kernel
   against the plain forward, at the training shapes (n=20: 4 clips x 5
   frames of 64x64 LQ crops; L1/L2/L3 at 64, 32, 16 px) with offsets
   beyond +-10 px; times by CUDA events beside the bounds;
7. train: EDVR-M trained from the golden weights through ``create_model``,
   ``feed_data`` and ``optimize_parameters`` on batches of 4 made from
   seeded in-memory clips by the port's ``paired_random_crop`` and
   ``augment``; 4 forward and 4 backward DCN launches per step, finite
   losses, the TSA freeze and unfreeze, ms per step and peak memory, and
   one batch-1 step's gradients against the plain CPU path.

Then a ``{"kernels": [...]}`` line, the nvidia-smi name/power line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises,
and the script exits non-zero without that last line. It needs the repo
around it and a CUDA card.
"""

from __future__ import annotations

import json
import os.path as osp
import random
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = osp.dirname(osp.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
DCN_TOL = 1e-4     # kernel vs plain, fp32: same arithmetic, other order
GOLDEN_TOL = 3e-4  # as tests/test_arch_parity.py
# backward kernel vs plain autograd, each gradient relative to its largest
# entry: fp32, sums over K*c_per*cout (dcol), n*P (dW) and the scattered
# corners (dx, by atomics in an order that varies from run to run)
BWD_TOL = 1e-4
# one batch-1 EDVR-M step, card vs plain CPU path, each parameter's
# gradient relative to its largest entry: fp32 through ~60 layers and 4
# DCNs with cuDNN's and the CPU's conv algorithms. A sample coordinate that
# differs by ~1e-6 px between the two can fall on the other side of an
# integer, where d sample / d offset jumps (floor), and that moves the
# gradients upstream of the offsets: up to 5e-4 of a tensor's max in the
# runs so far (conv_l3_1.bias)
STEP_GRAD_TOL = 5e-3
# H100 SXM published peaks (NVIDIA data sheet), the bound's denominators
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# EDVR-M pyramid levels of a 180x320 clip, 5 frames per window
LEVELS = {'L1': (180, 320), 'L2': (90, 160), 'L3': (45, 80)}
# training: batch 4 x 5 frames folded into the PCD batch, 64x64 LQ crops
TRAIN_N = 20
TRAIN_LEVELS = {'L1': (64, 64), 'L2': (32, 32), 'L3': (16, 16)}
TRAIN_STEPS, TSA_ITER, BATCH = 10, 3, 4

# options/test/EDVR/test_EDVR_M_x4_SR_REDS.yml as a dict (the card's
# Python may lack yaml); weights come from the golden state dict instead
# of the pretrained checkpoint, no image is written
EDVR_M_OPT = {
    'name': 'EDVR_M_x4_SR_REDS', 'model_type': 'VideoBaseModel', 'scale': 4,
    'num_gpu': 1, 'manual_seed': 0,
    'datasets': {'test_1': {
        'name': 'REDS4', 'type': 'VideoTestDataset',
        'dataroot_gt': None, 'dataroot_lq': None, 'meta_info_file': None,
        'io_backend': {'type': 'disk'}, 'cache_data': True, 'num_frame': 5,
        'padding': 'reflection_circle'}},
    'network_g': {'type': 'EDVR', 'num_in_ch': 3, 'num_out_ch': 3,
                  'num_feat': 64, 'num_frame': 5, 'deformable_groups': 8,
                  'num_extract_block': 5, 'num_reconstruct_block': 10,
                  'center_frame_idx': None, 'hr_in': False,
                  'with_predeblur': False, 'with_tsa': True},
    'path': {'pretrain_network_g': None, 'strict_load_g': True},
    'val': {'save_img': False, 'suffix': None, 'clip_mode': True,
            'clip_win_batch': 1,
            'metrics': {'psnr': {'type': 'calculate_psnr', 'crop_border': 0,
                                 'test_y_channel': False}}},
}


# options/train/EDVR/train_EDVR_M_x4_SR_REDS.yml as a dict, with the cuts
# listed in CUTS; the REDS datasets are replaced by seeded in-memory clips
EDVR_M_TRAIN_OPT = {
    'name': '102_EDVR_M_x4_SR_REDS_600k_B4G8_101pretrain',
    'model_type': 'EDVRModel', 'scale': 4, 'num_gpu': 1, 'manual_seed': 10,
    'network_g': EDVR_M_OPT['network_g'],
    'path': {'pretrain_network_g': None, 'strict_load_g': True,
             'resume_state': None},
    'train': {'optim_g': {'type': 'Adam', 'lr': 4e-4, 'weight_decay': 0,
                          'betas': [0.9, 0.99]},
              'scheduler': {'type': 'CosineAnnealingRestartLR',
                            'periods': [3, 6, 9, 9, 9],
                            'restart_weights': [1, 1, 1, 1, 1],
                            'eta_min': 1e-7},
              'total_iter': TRAIN_STEPS, 'warmup_iter': -1, 'dcn_lr_mul': 1,
              'mixed_precision': None,
              'pixel_opt': {'type': 'CharbonnierLoss', 'loss_weight': 1.0,
                            'reduction': 'sum'},
              'tsa_iter': TSA_ITER},
}
CUTS = ['train.mixed_precision: bf16 -> null (fp32, TF32 off)',
        f'train.tsa_iter: 50000 -> {TSA_ITER}',
        f'train.total_iter: 600000 -> {TRAIN_STEPS} steps',
        'scheduler periods [50000, 100000, 150000x3] -> [3, 6, 9x3]',
        'pretrain: woTSA checkpoint -> golden EDVR-M weights, strict load',
        'num_gpu 8 -> 1 card (batch_size_per_gpu 4 kept)',
        'REDS on disk -> seeded in-memory clips, same crop and augment']


class Phase:
    """Times a block and prints one flushed JSON line when it ends."""

    def __init__(self, name):
        self.name = name
        self.info = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            line = {'phase': self.name,
                    'seconds': time.perf_counter() - self.t0, **self.info}
            print(json.dumps(line), flush=True)
        return False


def cuda_ms(fn, iters):
    """Mean ms of ``fn`` over ``iters`` launches by CUDA events, warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dcn_inputs(h, w, gen, n=5, c=64, dg=8, K=9):
    """Seeded DCN inputs of one EDVR-M level; 5% of the offsets lie
    10-25 px away, beyond any window a banded kernel would assume."""
    x = torch.randn(n, c, h, w, generator=gen)
    off = torch.rand(n, dg * 2 * K, h, w, generator=gen) * 4 - 2
    far = torch.rand(off.shape, generator=gen) < 0.05
    far_off = ((torch.rand(off.shape, generator=gen) * 15 + 10)
               * torch.sign(torch.rand(off.shape, generator=gen) - 0.5))
    off = torch.where(far, far_off, off)
    mask = torch.sigmoid(torch.randn(n, dg * K, h, w, generator=gen))
    bound = 1 / (c * K) ** 0.5
    weight = (torch.rand(c, c, 3, 3, generator=gen) * 2 - 1) * bound
    bias = torch.randn(c, generator=gen) * 0.1
    return [t.cuda() for t in (x, off, mask, weight, bias)]


def dcn_bound(x, off, mask, weight, bias):
    """Least time the card could take: compulsory bytes over the memory
    rate vs fp32 operations over the fp32 peak, the larger."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    K = weight.shape[2] * weight.shape[3]
    flops = 2 * n * h * w * cout * cin * K
    nbytes = 4 * (x.numel() + off.numel() + mask.numel() + weight.numel()
                  + bias.numel() + n * cout * h * w)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes)


def dcn_bwd_bound(x, off, mask, weight):
    """The backward's bound: two contractions (dcol = W^T dout and dW),
    each as many operations as the forward's; bytes of x, offset, mask,
    weight and dout read once, dx, d_offset, d_mask and dW written once."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    K = weight.shape[2] * weight.shape[3]
    flops = 2 * 2 * n * h * w * cout * cin * K
    nbytes = 4 * 2 * (x.numel() + off.numel() + mask.numel()
                      + weight.numel()) + 4 * n * cout * h * w
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes)


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def load_golden():
    data = np.load(osp.join(ROOT, 'tests', 'data', 'golden',
                            'arch_edvr_m_full.npz'))
    state = {k: torch.from_numpy(data[k]) for k in data.files
             if not k.startswith('__')}
    config = json.loads(bytes(data['__config__']).decode())
    return state, config, data['__input__'], data['__output__']


def seeded_clip(T, h, w, gen):
    """A moving, smooth seeded GT clip (T, 3, 4h, 4w) and its 4x
    box-downsampled LQ clip (T, 3, h, w), both in [0, 1]."""
    field = torch.rand(1, 3, h // 8 + T, w // 8 + T, generator=gen)
    field = F.interpolate(field, scale_factor=32, mode='bicubic',
                          align_corners=False).clamp(0, 1)
    gt = torch.cat([field[:, :, 4 * t:4 * t + 4 * h, 4 * t:4 * t + 4 * w]
                    for t in range(T)])
    lq = F.avg_pool2d(gt, 4)
    return lq.contiguous(), gt.contiguous()


def train_batches(gen, steps, batch, rng):
    """``steps`` batches of ``batch`` REDS-style items: 5-frame LQ windows
    and their centre GT frame cut from seeded in-memory clips by the port's
    ``paired_random_crop`` (gt_size 256) and ``augment`` (flip, rot)."""
    from edvr_tpu_torch.data.transforms import augment, paired_random_crop
    lq_clip, gt_clip = seeded_clip(12, 96, 160, gen)
    hwc = lambda t: [f.permute(1, 2, 0).numpy() for f in t]
    lqs, gts = hwc(lq_clip), hwc(gt_clip)
    chw = lambda a: torch.from_numpy(a).permute(2, 0, 1)
    batches = []
    for _ in range(steps):
        items_lq, items_gt = [], []
        for _ in range(batch):
            c = rng.randint(2, len(lqs) - 3)
            gt, win = paired_random_crop(gts[c], lqs[c - 2:c + 3], 256, 4,
                                         rng)
            frames = augment(win + [gt], rng, True, True)
            items_lq.append(torch.stack([chw(f) for f in frames[:-1]]))
            items_gt.append(chw(frames[-1]))
        batches.append({'lq': torch.stack(items_lq),
                        'gt': torch.stack(items_gt)})
    return batches


class InMemoryClips:
    """What ``_clip_validation`` reads of a VideoTestDataset built with
    ``cache_data: true``: one folder of (T, 3, h, w) LQ and GT tensors."""

    def __init__(self, opt, lq, gt, folder='000'):
        self.opt = opt
        self.cache_data = True
        self.imgs_lq, self.imgs_gt = {folder: lq}, {folder: gt}
        T = lq.shape[0]
        self.data_info = {'folder': [folder] * T,
                          'lq_path': [f'{folder}/{i:08d}.png'
                                      for i in range(T)]}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this run '
              'needs a CUDA card', file=sys.stderr)
        return 1
    from edvr_tpu_torch import native
    from edvr_tpu_torch.archs import define_network
    from edvr_tpu_torch.archs.edvr_arch import (clip_window_indices,
                                                make_clip_restore_fn)
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.ops import dcn
    from edvr_tpu_torch.utils.options import parse_dict

    # fp32 everywhere: the reference is compared at full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)

    with Phase('device') as ph:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        ph.info.update(kind=kind, count=torch.cuda.device_count(),
                       nvidia_smi=smi, torch=torch.__version__,
                       cuda=torch.version.cuda)

    with Phase('build') as ph:
        logs = native.build_all()
        ph.info['ptxas'] = {
            name: [ln.split(':', 1)[1].strip() for ln in log.splitlines()
                   if re.search(r'Used \d+ registers', ln)]
            for name, log in logs.items()}

    results = {}
    for level, (h, w) in LEVELS.items():
        with Phase(f'kernel_{level}') as ph, torch.no_grad():
            args = dcn_inputs(h, w, gen)
            geo = (1, 1, 1)  # stride, padding, dilation
            got = dcn.dcn_fwd_cuda(*args, *geo, 8)
            want = dcn.modulated_deform_conv_plain(*args, *geo, 1, 8)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not err <= DCN_TOL:
                raise AssertionError(f'dcn_fwd {level}: max abs err {err} '
                                     f'> {DCN_TOL}')
            ms = cuda_ms(lambda: dcn.dcn_fwd_cuda(*args, *geo, 8), 20)
            plain_ms = cuda_ms(
                lambda: dcn.modulated_deform_conv_plain(*args, *geo, 1, 8),
                5)
            bound_ms, bound_by, flops, nbytes = dcn_bound(*args)
            results[level] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
            ph.info.update(shape=list(args[0].shape), tol=DCN_TOL,
                           gflop=flops / 1e9, mbytes=nbytes / 1e6,
                           **results[level])

    state, config, x_gold, y_gold = load_golden()
    with Phase('golden') as ph, torch.no_grad():
        net = define_network(config)
        net.load_state_dict(state, strict=True)
        net = net.cuda().eval()
        out = net(torch.from_numpy(x_gold).cuda()).cpu().numpy()
        err = float(np.abs(out - y_gold).max())
        if not (out.shape == y_gold.shape and err <= GOLDEN_TOL):
            raise AssertionError(f'golden EDVR-M: shape {out.shape}, max '
                                 f'abs err {err} > {GOLDEN_TOL}')
        ph.info.update(shape=list(out.shape), max_abs_err=err,
                       tol=GOLDEN_TOL)
        del net

    T, h, w = 12, 180, 320
    lq, gt = seeded_clip(T, h, w, gen)
    with Phase('main_path') as ph, tempfile.TemporaryDirectory() as tmp:
        opt = parse_dict(json.loads(json.dumps(EDVR_M_OPT)), is_train=False,
                         root=tmp)
        opt['device'] = 'cuda'
        ckpt = osp.join(tmp, 'edvr_m_golden.pth')
        torch.save({'params': state}, ckpt)
        opt['path']['pretrain_network_g'] = ckpt
        model = create_model(opt)
        clips = InMemoryClips(opt['datasets']['test_1'], lq, gt)
        # first pass: cuDNN's algorithm choice and the lazy kernel load
        model._clip_validation(clips, 'warmup', None, save_img=False)

        dcn.LAUNCHES.update({k: 0 for k in dcn.LAUNCHES})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model._clip_validation(clips, opt['name'], None, save_img=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(dcn.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()

        if launches['dcn_fwd'] != 4 * T:
            raise AssertionError(f'main path launched dcn_fwd '
                                 f'{launches["dcn_fwd"]} times, expected '
                                 f'4 x {T} windows')
        psnr = model.metric_results['000'][:, 0]
        if not (psnr.shape == (T,) and np.isfinite(psnr).all()):
            raise AssertionError(f'PSNR table not finite: {psnr}')

        # the network alone over the same clip, without the host's
        # uint8 conversion and scoring
        idx = clip_window_indices(T, 5, 'reflection_circle')
        restore = make_clip_restore_fn(model.net_g)
        lq_card = lq.cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(lq_card, idx)
        torch.cuda.synchronize()
        net_secs = time.perf_counter() - t0

        # one window of the main path against the plain CPU path
        win = lq[idx[0]][None]
        with torch.no_grad():
            on_card = restore(lq_card, idx[:1])
            on_cpu = model.net_g.cpu()(win)
        on_card = on_card.cpu()
        win_err = (on_card - on_cpu).abs().max().item()
        if not (on_card.shape == (1, 3, 4 * h, 4 * w)
                and torch.isfinite(on_card).all()
                and win_err <= GOLDEN_TOL):
            raise AssertionError(f'main-path window vs plain CPU path: '
                                 f'shape {tuple(on_card.shape)}, max abs '
                                 f'err {win_err} > {GOLDEN_TOL}')
        ph.info.update(frames=T, lq_hw=[h, w], windows=T, win_batch=1,
                       dcn_launches=launches['dcn_fwd'],
                       seconds_restore=secs, ms_per_window=secs / T * 1e3,
                       fps=T / secs, peak_mem_bytes=peak,
                       network_ms_per_window=net_secs / T * 1e3,
                       psnr_mean=float(psnr.mean()),
                       window_vs_cpu_max_abs_err=win_err,
                       card=smi)

    bwd_results, fwd_train = {}, {}
    for level, (h, w) in TRAIN_LEVELS.items():
        with Phase(f'kernel_bwd_{level}') as ph:
            args = dcn_inputs(h, w, gen, n=TRAIN_N)
            geo = (1, 1, 1)  # stride, padding, dilation
            with torch.no_grad():
                out = dcn.dcn_fwd_cuda(*args, *geo, 8)
                want = dcn.modulated_deform_conv_plain(*args, *geo, 1, 8)
            fwd_err = (out - want).abs().max().item()
            if not fwd_err <= DCN_TOL:
                raise AssertionError(f'dcn_fwd train {level}: max abs err '
                                     f'{fwd_err} > {DCN_TOL}')
            dout = torch.randn(out.shape, generator=gen).cuda()
            got = dcn.dcn_bwd_cuda(dout, *args[:4], *geo, 8)
            leaves = [a.clone().requires_grad_() for a in args[:4]]
            plain_out = dcn.modulated_deform_conv_plain(*leaves, args[4],
                                                        *geo, 1, 8)
            want = torch.autograd.grad(plain_out, leaves, dout,
                                       retain_graph=True)
            torch.cuda.synchronize()
            errs = {}
            for name, g, w_ in zip(('dx', 'd_offset', 'd_mask', 'd_weight'),
                                   got, want):
                errs[name] = dict(max_abs_err=(g - w_).abs().max().item(),
                                  rel_err=rel_err(g, w_))
                if not (g.shape == w_.shape
                        and errs[name]['rel_err'] <= BWD_TOL):
                    raise AssertionError(f'dcn_bwd {level} {name}: '
                                         f'{errs[name]} > {BWD_TOL}')
            ms = cuda_ms(lambda: dcn.dcn_bwd_cuda(dout, *args[:4], *geo, 8),
                         20)
            plain_ms = cuda_ms(lambda: torch.autograd.grad(
                plain_out, leaves, dout, retain_graph=True), 5)
            fwd_ms = cuda_ms(lambda: dcn.dcn_fwd_cuda(*args, *geo, 8), 20)
            with torch.no_grad():
                fwd_plain_ms = cuda_ms(
                    lambda: dcn.modulated_deform_conv_plain(*args, *geo, 1,
                                                            8), 5)
            bound_ms, bound_by, flops, nbytes = dcn_bwd_bound(*args[:4])
            f_bound_ms, f_bound_by, _, _ = dcn_bound(*args)
            bwd_results[level] = dict(
                max_abs_err=max(e['max_abs_err'] for e in errs.values()),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)
            fwd_train[level] = dict(max_abs_err=fwd_err, ms=fwd_ms,
                                    plain_ms=fwd_plain_ms,
                                    bound_ms=f_bound_ms, bound_by=f_bound_by)
            ph.info.update(shape=list(args[0].shape), tol=BWD_TOL,
                           gradients=errs, gflop=flops / 1e9,
                           mbytes=nbytes / 1e6, **bwd_results[level],
                           fwd=fwd_train[level], fwd_tol=DCN_TOL)
            del leaves, plain_out, want, got

    with Phase('train') as ph, tempfile.TemporaryDirectory() as tmp:
        opt = parse_dict(json.loads(json.dumps(EDVR_M_TRAIN_OPT)),
                         is_train=True, root=tmp)
        opt['device'] = 'cuda'
        ckpt = osp.join(tmp, 'edvr_m_golden.pth')
        torch.save({'params': state}, ckpt)
        opt['path']['pretrain_network_g'] = ckpt
        model = create_model(opt)
        rng = random.Random(SEED)
        batches = train_batches(gen, TRAIN_STEPS, BATCH, rng)
        params = dict(model.net_g.named_parameters())

        def snapshot():
            return {n: p.detach().clone() for n, p in params.items()}

        losses, step_secs, per_step = [], [], []
        before = snapshot()
        dcn.LAUNCHES.update({k: 0 for k in dcn.LAUNCHES})
        for it, batch in enumerate(batches, 1):
            if it == TSA_ITER:  # warm-up over: only fusion.* has moved
                now = snapshot()
                frozen_moved = [n for n in params if 'fusion' not in n
                                and not torch.equal(now[n], before[n])]
                fusion_still = [n for n in params if 'fusion' in n
                                and torch.equal(now[n], before[n])]
                if frozen_moved or fusion_still:
                    raise AssertionError(
                        f'TSA warm-up: frozen parameters moved '
                        f'{frozen_moved[:3]}, fusion parameters did not '
                        f'{fusion_still[:3]}')
                before = now
            if it == 4:  # cuDNN has chosen its algorithms: time from here
                torch.cuda.reset_peak_memory_stats()
            counts = dict(dcn.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.feed_data(batch)
            model.optimize_parameters(it)
            torch.cuda.synchronize()
            step_secs.append(time.perf_counter() - t0)
            per_step.append({k: dcn.LAUNCHES[k] - counts[k] for k in counts})
            losses.append(float(model.log_dict['l_pix']))
            if it == TSA_ITER:  # the first step after the warm-up
                now = snapshot()
                still = [n for n in params if torch.equal(now[n], before[n])]
                if still:
                    raise AssertionError(f'after tsa_iter parameters did '
                                         f'not move: {still[:3]}')
        train_launches = dict(dcn.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)):
            raise AssertionError(f'training losses not finite: {losses}')
        if any(c != {'dcn_fwd': 4, 'dcn_bwd': 4} for c in per_step):
            raise AssertionError(f'DCN launches per step: {per_step}')

        # one batch-1 step's gradients: the card against the plain CPU path
        one = {k: v[:1] for k, v in batches[-1].items()}
        cpu_opt = json.loads(json.dumps(opt))
        cpu_opt['device'] = 'cpu'
        cpu_opt['path']['pretrain_network_g'] = None
        cpu_model = create_model(cpu_opt)
        cpu_model.net_g.load_state_dict(model.net_g.state_dict())
        grads = {}
        for name, m in (('cuda', model), ('cpu', cpu_model)):
            m.feed_data(one)
            m.optimize_parameters(TRAIN_STEPS + 1)
            grads[name] = {n: p.grad.detach().cpu()
                           for n, p in m.net_g.named_parameters()}
        grad_errs = {n: rel_err(grads['cuda'][n], g)
                     for n, g in grads['cpu'].items()}
        worst = max(grad_errs, key=grad_errs.get)
        if not grad_errs[worst] <= STEP_GRAD_TOL:
            raise AssertionError(f'card vs CPU gradients: {worst} rel err '
                                 f'{grad_errs[worst]} > {STEP_GRAD_TOL}')

        timed = sorted(step_secs[3:])
        step_ms = timed[len(timed) // 2] * 1e3
        dcn_ms = sum(fwd_train[lv]['ms'] + bwd_results[lv]['ms']
                     for lv in ('L1', 'L1', 'L2', 'L3'))  # L1 twice: cascade
        ph.info.update(
            steps=TRAIN_STEPS, batch=BATCH, lq_crop=64, gt_crop=256,
            pcd_n=TRAIN_N, cuts=CUTS, losses=losses,
            dcn_launches=train_launches, launches_per_step=per_step[0],
            ms_per_step_median=step_ms,
            ms_per_step_all=[t * 1e3 for t in step_secs],
            peak_mem_bytes=peak, dcn_ms_per_step=dcn_ms,
            dcn_share_of_step=dcn_ms / step_ms,
            grad_vs_cpu_worst=[worst, grad_errs[worst]],
            grad_tol=STEP_GRAD_TOL, card=smi)
        del model, cpu_model

    l1 = results['L1']
    kernel = {'name': 'dcn_fwd', 'route': 'cuda',
              'source': 'edvr_tpu_torch/csrc/dcn_fwd.cu',
              'replaces': 'edvr_tpu/ops/dcn_band.py:281',
              'replaces_function': 'edvr_tpu/ops/dcn_band.py::band_forward',
              'launches': launches['dcn_fwd'],
              'max_abs_err': max(r['max_abs_err'] for r in results.values()),
              'ms': l1['ms'], 'plain_ms': l1['plain_ms'],
              'bound_ms': l1['bound_ms'], 'bound_by': l1['bound_by'],
              'library_ms': None}
    for level, r in results.items():
        kernel.update({f'ms_{level}': r['ms'],
                       f'plain_ms_{level}': r['plain_ms'],
                       f'bound_ms_{level}': r['bound_ms']})
    kernel['launches_train'] = train_launches['dcn_fwd']
    kernel['max_abs_err'] = max(kernel['max_abs_err'],
                                *(r['max_abs_err'] for r in fwd_train.values()))
    for level, r in fwd_train.items():
        kernel.update({f'ms_train_{level}': r['ms'],
                       f'plain_ms_train_{level}': r['plain_ms'],
                       f'bound_ms_train_{level}': r['bound_ms']})
    b1 = bwd_results['L1']
    kernel_bwd = {'name': 'dcn_bwd', 'route': 'cuda',
                  'source': 'edvr_tpu_torch/csrc/dcn_bwd.cu',
                  'replaces': 'edvr_tpu/ops/dcn_band.py:608',
                  'replaces_function':
                      'edvr_tpu/ops/dcn_band.py::band_backward',
                  'launches': train_launches['dcn_bwd'],
                  'max_abs_err': max(r['max_abs_err']
                                     for r in bwd_results.values()),
                  'ms': b1['ms'], 'plain_ms': b1['plain_ms'],
                  'bound_ms': b1['bound_ms'], 'bound_by': b1['bound_by'],
                  'library_ms': None}
    for level, r in bwd_results.items():
        kernel_bwd.update({f'ms_{level}': r['ms'],
                           f'plain_ms_{level}': r['plain_ms'],
                           f'bound_ms_{level}': r['bound_ms']})
    print(json.dumps({'kernels': [kernel, kernel_bwd]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
