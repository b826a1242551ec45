"""Smoke run of the edvr_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths at EDVR-M x4 full width (64 features, 5 frames,
dg=8, 5+10 blocks, TSA; fp32 with TF32 off, and the bf16 mixed-precision
training step of the shipped YAML), and EDVR-L's test configurations at
theirs (128 features, 5 + 40 blocks; x4 SR, deblur with HR input, SRblur,
Vimeo90K per window, pyramid clip mode, the packed route): whole-clip inference
(``options/test/EDVR/test_EDVR_M_x4_SR_REDS.yml``, window mode,
win_batch=1) and training (``options/train/EDVR/train_EDVR_M_x4_SR_REDS.yml``)
on the direct DCN kernels, both again through the packed DCN route
(``EDVR_TPU_DCN_PALLAS=1``: row gather + blend GEMM kernels), and training
of the tap_shared variant
(``options/train/EDVR/train_EDVR_M_x4_SR_REDS_tapshared.yml``), training
in bf16 (``mixed_precision: bf16`` kept) and the DCN forward's ablation
variants through their timing tool; and checks every hand-written kernel
of those paths against its plain PyTorch version. Phases, each printing
one flushed JSON line with its ``seconds``:

1. device: the card's name and power limit;
2. build: nvcc builds every kernel from ``edvr_tpu_torch/csrc``, one
   process per source, all started together;
3. kernel_<level>: the DCNv2 kernel against the plain version at the
   EDVR-M pyramid levels L1/L2/L3 (n=5 frames of a 180x320 clip), with
   offsets beyond +-10 px; its time by CUDA events beside the bound (the
   contraction as 3xTF32 on the tensor cores, the kernel's arithmetic,
   against the bytes; the fp32-pipe bound beside it) and the GEMM alone
   (``torch.mm`` of a materialized column, a part of the function);
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
   beyond +-10 px; times by CUDA events beside the bounds (the
   operations as 3xTF32 on the tensor cores, the kernels' arithmetic,
   and beside them the bounds on the fp32 pipe, named as such);
7. train: EDVR-M trained from the golden weights through ``create_model``,
   ``feed_data`` and ``optimize_parameters`` on batches of 4 made from
   seeded in-memory clips by the port's ``paired_random_crop`` and
   ``augment``; 4 forward and 4 backward DCN launches per step, finite
   losses, the TSA freeze and unfreeze, ms per step and peak memory, and
   one batch-1 step's gradients against the plain CPU path, with the
   sample coordinates of that step that lie within 1e-5 px of an integer
   (and whose floor differs between card and CPU) counted per DCN call;
8. kernel_blend_<level>: the packed route's blend GEMM kernel against its
   plain version on one deformable group at the inference shapes (NP =
   5 x P, width 9 x 128, cout 64), and at a ragged NP; times beside the
   bound (3xTF32 operations vs bytes, and the fp32-pipe bound beside it),
   the plain version and the GEMM alone (``torch.addmm``);
9. kernel_gather_<shape>: the row-gather kernel, bitwise against
   ``index_select``, at the three shapes of
   ``scripts/dev/probe_mosaic_gather.py`` (3600/14400/57600 rows of 128,
   G = 4096 and G = 8 x rows) and at the packed route's L1 shape;
10. packed_main_path: a seeded 6-frame 180x320 clip restored through
    ``create_model`` and ``_clip_validation`` on the packed route (8 gathers
    and 8 blends per DCN call, no dcn_fwd), one window against the direct
    route on the card and the plain CPU path;
11. packed_train: EDVR-M training steps at batch 4 on the packed route
    (32 gathers and 32 blends per step, no dcn_fwd/dcn_bwd), and one
    batch-1 step's gradients against the direct route on the card;
12. tapshared_train: tap_shared EDVR-M training steps on the direct
    kernels (4 K=1 dcn_fwd and 4 dcn_bwd launches per step), and one
    batch-1 step's gradients against the plain CPU path;
13. kernel_bf16_<level>: the bf16 DCNv2 forward kernel against the bf16
    plain version at L1/L2/L3 and at the training shapes (train_L1/L2/L3),
    offsets beyond +-10 px, and at the training shapes the bf16 backward
    kernel against autograd through the bf16 plain version; times beside
    the bf16 bounds (the forward's two exact products per column entry,
    its hi and lo, against the bytes), the bf16 GEMM alone and the fp32
    kernels' times;
14. mp_train: the same training with ``mixed_precision: bf16`` kept
    (MP_CUTS): 10 steps at batch 4, 4 dcn_fwd_bf16 and 4 dcn_bwd_bf16
    launches per step and no fp32 DCN launch, the TSA freeze and unfreeze,
    f32 master parameters and Adam state, ms per step and peak memory,
    then 3 steps under torch.profiler (kernel time by category, launches,
    busy share); and from the golden weights and one batch, two bf16 steps
    against two fp32 steps on the card: the first step's gradients within
    5e-2 over all parameters (relative L2) and a cosine of at least 0.5
    for each tensor, beside what a negated gradient and another batch's
    read; loss per element within 5e-3 and parameters within 1.6e-3;
15. ablate_l1: every ablation variant of ``dcn_fwd.cu``
    (``ops/dcn_ablate.py``) against its plain version at EDVR-M L1 in fp32
    and bf16, then the timing table of
    ``python -m edvr_tpu_torch.tools.ablate_dcn``, one line per variant.
16-21 run in a child process (``chip_smoke.py --edvr-l OUT``) under the
test CLI's cuDNN policy (``edvr_tpu_torch.test.INFERENCE_CUDNN_ENV``, read
at a process's first convolution), as ``python -m edvr_tpu_torch.test``
runs them; the phases before keep PyTorch's default, as the training CLI
does.

16. kernel_l_<level>: the DCNv2 forward kernel at EDVR-L's shapes (128
    features, dg 8: c_per 16, cout 128) at L1/L2/L3 of 5 frames and at L1
    of 7 (L1_n7), as kernel_<level>;
17. edvr_l_main_path: EDVR-L (``options/test/EDVR/test_EDVR_L_x4_SR_REDS.yml``,
    5 + 40 blocks, TSA) with seeded weights (``seeded_edvr``: offsets of up
    to 24 px) loaded strictly from a .pth, restoring the 12-frame clip
    through ``create_model`` and ``_clip_validation`` (4 dcn_fwd per
    window); ms per window, network ms per window, peak memory, and one
    window against the plain CPU path;
18. edvr_l_pyramid: the same clip through ``make_clip_restore_fn`` in
    pyramid mode against window mode (1e-5), EDVR-L and EDVR-M, each mode
    timed in turns (window, pyramid, pyramid, window);
19. edvr_l_deblur: ``test_EDVR_L_deblur_REDS.yml`` (HR input and
    pre-deblur) on a seeded 6-frame 720x1280 clip through the engine, one
    window's HR crop against the plain CPU path; and
    ``test_EDVR_L_x4_SRblur_REDS.yml`` (pre-deblur on LQ input) on one
    window, an LQ crop of it against the CPU;
20. edvr_l_vimeo: ``test_EDVR_L_x4_SR_Vimeo90K.yml`` (7 frames, the
    per-window protocol) over seeded septuplets on disk (LQ 64x112, GT
    256x448) through ``VideoTestVimeo90KDataset`` and ``validation``:
    PSNR and ms per sequence, each window's result against the direct
    forward of the same window;
21. packed_edvr_l: the blend GEMM (L1/L2/L3) and row-gather (L1) kernels
    at EDVR-L's packed shapes (4 pixels per 128-lane row, width 9 x 128,
    cout 128) against their plain versions, then EDVR-L on the packed route
    (``EDVR_TPU_DCN_PALLAS=1``) on a 5-frame clip against the direct route.

Then a ``{"kernels": [...]}`` line, the nvidia-smi name/power line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises,
and the script exits non-zero without that last line. It needs the repo
around it and a CUDA card.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import os.path as osp
import random
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

ROOT = osp.dirname(osp.abspath(__file__))
sys.path.insert(0, ROOT)

# the H100's peak rates, the bounds' denominators, and the CUDA-event timer
# are the ablation tool's, so every kernel is bounded against one table
from edvr_tpu_torch.tools.ablate_dcn import (  # noqa: E402
    PEAK_BYTES, PEAK_OPS, PEAK_TF32, cuda_ms)

SEED = 0
DCN_TOL = 1e-4     # kernel vs plain, fp32: same arithmetic, other order
GOLDEN_TOL = 3e-4  # as tests/test_arch_parity.py
# backward kernel vs plain autograd, each gradient relative to its largest
# entry: fp32, sums over K*c_per*cout (dcol), n*P (dW) and the scattered
# corners (dx, by atomics in an order that varies from run to run)
BWD_TOL = 1e-4
# one batch-1 EDVR-M step, card vs plain CPU path, each parameter's
# gradient relative to its largest entry: fp32 through ~60 layers and 4
# DCNs with cuDNN's and the CPU's conv algorithms. Readings so far reach
# 5.9e-4 (pcd_align.offset_conv2.l3.weight) and 5.1e-4 (tap_shared,
# conv_l3_2.weight). No sample coordinate of those steps takes another
# floor on the card than on the CPU (the train and tapshared_train phases
# count them); against float64 the tap_shared gap is cuDNN's convolution
# gradients (it vanishes with cuDNN off, tapshared_train's probes)
STEP_GRAD_TOL = 1e-3
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

# the packed DCN route (EDVR_TPU_DCN_PALLAS=1) and the tap_shared variant
PACKED_T = 6        # frames of the packed route's clip (main_path: 12)
PACKED_STEPS = 3    # training steps on the packed route and of tap_shared
# blend kernel vs plain, relative to max|out|: fp32, the same products
# summed in another order over a width of 1152
BLEND_TOL = 1e-5
# scripts/dev/probe_mosaic_gather.py: (R, 128) tables of the three EDVR-M
# levels' pixel counts, G = 4096 and G = 8 x R gathered rows
PROBE_ROWS = (3600, 14400, 57600)
PROBE_LANES = 128
# options/train/EDVR/train_EDVR_M_x4_SR_REDS_tapshared.yml as a dict, with
# the cuts of CUTS and TAPSHARED_CUTS
EDVR_M_TAPSHARED_OPT = dict(
    EDVR_M_TRAIN_OPT, name='103_EDVR_M_x4_SR_REDS_tapshared_600k_B4G8',
    network_g=dict(EDVR_M_OPT['network_g'], align_variant='tap_shared'),
    path={'pretrain_network_g': None, 'strict_load_g': False,
          'resume_state': None})
TAPSHARED_CUTS = [f'train.total_iter: 600000 -> {PACKED_STEPS} steps',
                  'pretrain: none -> seeded init with the conv_offset '
                  'weights drawn from N(0, 0.01), so the warp moves']

# the bf16 kernels against the bf16 plain version, relative to each
# result's largest entry. Forward: the same rounding points (coefficient
# and per-corner product in bf16), the float32 contraction summed in
# another order, which moves the bf16 output rounding by one ulp (2^-8).
# Backward: the kernel sums in float32 where autograd through the plain
# version rounds each op's gradient to bf16; the bound
# tests/test_mixed_precision.py holds the bf16 band path to.
BF16_FWD_TOL = 1e-2
BF16_BWD_TOL = 4e-2
# options/train/EDVR/train_EDVR_M_x4_SR_REDS.yml with mixed_precision: bf16
# kept, and the other cuts of CUTS
EDVR_M_MP_OPT = dict(EDVR_M_TRAIN_OPT, train=dict(EDVR_M_TRAIN_OPT['train'],
                                                 mixed_precision='bf16'))
MP_CUTS = CUTS[1:]
# the bf16 step against the fp32 step on the card, from the golden weights
# and one batch over two steps (TSA off, so every parameter moves): the
# loss per element and the parameters within the bounds of
# tests/test_mixed_precision.py:59-68 with the YAML's lr of 4e-4. Neither
# sees the gradient (an Adam step moves a parameter by about lr whatever
# its gradient), so the gate is the first step's gradient: |g - g32| /
# |g32| (L2 norms) over all parameters, and the cosine of g and g32 for
# each parameter tensor; the bounds of tests/test_torch_bf16.py (sound
# runs read 2.5e-3-2.4e-2 and cosines >= 0.87; 1.5 x the gradient reads
# 0.5, a negated one 2, a dropped tensor cosine 0)
MP_LOSS_TOL = 5e-3
MP_PARAM_TOL = 4 * 4e-4
MP_GRAD_TOL = 5e-2
MP_LEAF_COS_MIN = 0.5
# ablation variants vs their plain versions (ops/dcn_ablate.py), relative
# to max|out|: float32 the same products in another order; bf16 one
# output ulp
ABLATE_TOL = {'fp32': 1e-5, 'bf16': 1e-2}
# what the DCN forward's library_ms times: a part of its function
GEMM_ONLY = ('torch.mm of a materialized column by the weights, the GEMM '
             'only (cuBLAS, the inputs\' dtype)')


# EDVR-L, the paper's published models (options/test/EDVR/test_EDVR_L_*.yml)
# at full width: 128 features, dg 8 (c_per 16, cout 128 in every DCN), 5 +
# 40 blocks, TSA. The published checkpoints are not in the repo, so the
# weights are seeded (seeded_edvr) and the REDS4, Vimeo90K data synthetic
EDVR_L_NET = dict(EDVR_M_OPT['network_g'], num_feat=128,
                  num_reconstruct_block=40)
EDVR_L_OPT = dict(EDVR_M_OPT, name='EDVR_L_x4_SR_REDS', network_g=EDVR_L_NET)
# test_EDVR_L_deblur_REDS.yml (deblurcomp is the same network) and
# test_EDVR_L_x4_SRblur_REDS.yml
EDVR_L_DEBLUR_OPT = dict(EDVR_M_OPT, name='EDVR_L_deblur_REDS',
                         network_g=dict(EDVR_L_NET, hr_in=True,
                                        with_predeblur=True))
EDVR_L_SRBLUR_NET = dict(EDVR_L_NET, with_predeblur=True)
# test_EDVR_L_x4_SR_Vimeo90K.yml: 7 frames, per-window validation
EDVR_L_VIMEO_OPT = {
    'name': 'EDVR_L_x4_SR_Vimeo90K', 'model_type': 'VideoBaseModel',
    'scale': 4, 'num_gpu': 1, 'manual_seed': 0,
    'datasets': {'test_1': {
        'name': 'Vimeo90K', 'type': 'VideoTestVimeo90KDataset',
        'dataroot_gt': None, 'dataroot_lq': None, 'meta_info_file': None,
        'io_backend': {'type': 'disk'}, 'cache_data': False, 'num_frame': 7,
        'padding': 'reflection_circle'}},
    'network_g': dict(EDVR_L_NET, num_frame=7),
    'path': {'pretrain_network_g': None, 'strict_load_g': True},
    'val': {'save_img': False, 'suffix': None,
            'metrics': EDVR_M_OPT['val']['metrics']},
}
# a fresh EDVR's conv_offset is zero (so its DCNs would sample on the grid):
# the seeded packs' offset rows are scaled until the largest |offset| each
# sends on the phase's first window is this many pixels
OFFSET_PX = 24.0
# pyramid against window clip mode on the card: the same ops on the same
# windows, batched otherwise
MODE_TOL = 1e-5
L_CLIP = (12, 180, 320)             # frames, LQ height, width (REDS4's size)
DEBLUR_T = 6                        # frames of the 720x1280 HR deblur clip
DEBLUR_CPU_CROP = (256, 256)        # HR crop of the deblur window's CPU check
SRBLUR_CPU_CROP = (96, 160)         # LQ crop of the SRblur window's CPU check
VIMEO_SEQS = 4                      # synthetic septuplets, LQ 64x112
PACKED_L_T = 5                      # frames of packed_edvr_l's clip (>= 5)
L_CUTS = ['pretrain: the published EDVR-L checkpoint (not in the repo) -> '
          'seeded weights (torch seed 0, BasicSR init) with each DCN pack\'s '
          f'offset rows drawn and scaled to offsets of up to {OFFSET_PX} px, '
          'strict load from a .pth',
          'data: REDS4 / Vimeo90K (not in the repo) -> seeded synthetic '
          'clips']


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
    """The forward's bound: compulsory bytes (each input read once, the
    output written once) over the memory rate vs the contraction's
    operations as the kernel takes them on the tensor cores, the larger:
    fp32 in 3xTF32 (three TF32 products per fp32 product, at the TF32
    rate), bf16 as two exact bf16 products per column entry (its hi and
    lo) at the bf16 rate. The fifth value is the bound with the operations
    on the fp32 pipe (the CUDA cores: a contraction in fp32 FMAs), for
    comparison."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    K = weight.shape[2] * weight.shape[3]
    flops = 2 * n * h * w * cout * cin * K
    nbytes = x.element_size() * (
        x.numel() + off.numel() + mask.numel() + weight.numel()
        + bias.numel() + n * cout * h * w)
    t_ops = (3 * flops / PEAK_TF32 if x.dtype == torch.float32
             else 2 * flops / PEAK_OPS[x.dtype])
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes,
            max(flops / PEAK_OPS[torch.float32], t_bytes) * 1e3)


def gemm_only_ms(x, weight, iters=20):
    """The forward's "GEMM only" yardstick: one ``torch.mm`` of a
    materialized column of the call's shape (n*h*w, cin*K) by the (cin*K,
    cout) weights, in the inputs' dtype (cuBLAS; TF32 off in fp32), timed
    by CUDA events. It computes a part of the function (no sampling, no
    column build); the port never calls it."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    col = torch.randn(n * h * w, weight[0].numel(), device=x.device,
                      dtype=x.dtype)
    wm = weight.reshape(cout, -1).t().contiguous()
    ms = cuda_ms(lambda: torch.mm(col, wm), iters)
    del col
    return ms


def dcn_bwd_bound(x, off, mask, weight):
    """The backward's bound: two contractions (dcol = W^T dout and dW),
    each as many operations as the forward's, in fp32 taken as 3xTF32 on
    the tensor cores (three TF32 products per fp32 product), in bf16 at the
    bf16 rate; bytes of x, offset, mask, weight and dout read once, dx,
    d_offset, d_mask and dW written once. The fifth value is the bound
    with the operations on the fp32 pipe (the CUDA cores), that of a
    contraction in fp32 FMAs, for comparison."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    K = weight.shape[2] * weight.shape[3]
    flops = 2 * 2 * n * h * w * cout * cin * K
    nbytes = x.element_size() * (
        2 * (x.numel() + off.numel() + mask.numel() + weight.numel())
        + n * cout * h * w)
    t_ops = (3 * flops / PEAK_TF32 if x.dtype == torch.float32
             else flops / PEAK_OPS[x.dtype])
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes,
            max(flops / PEAK_OPS[torch.float32], t_bytes) * 1e3)


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def grad_gaps(got, want):
    """|got - want| / |want| (L2 norms) over every parameter tensor
    together, and the cosine of got and want for each one (0 where either
    is 0)."""
    num = den = 0.0
    cosines = {}
    for n, w in want.items():
        g, w = got[n].double().ravel(), w.double().ravel()
        num += (g - w).square().sum().item()
        den += w.square().sum().item()
        cosines[n] = (g @ w / (g.norm() * w.norm()).clamp_min(1e-300)
                      ).item()
    return (num / den) ** 0.5, cosines


def launch_counts(**counts):
    """The launch counts of a path: the given kernel entries, every other
    entry of ``native.LAUNCHES`` 0."""
    from edvr_tpu_torch import native
    return {k: counts.get(k, 0) for k in native.LAUNCHES}


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


@contextlib.contextmanager
def packed_route():
    """``EDVR_TPU_DCN_PALLAS=1`` (the JAX package's switch) for a block:
    the port's DCN takes the packed route."""
    old = os.environ.get('EDVR_TPU_DCN_PALLAS')
    os.environ['EDVR_TPU_DCN_PALLAS'] = '1'
    try:
        yield
    finally:
        if old is None:
            del os.environ['EDVR_TPU_DCN_PALLAS']
        else:
            os.environ['EDVR_TPU_DCN_PALLAS'] = old


def packed_kernel_inputs(args):
    """The inputs of the first deformable group's row gather (table, idx)
    and blend GEMM (g_cat, cs_cat, wexp_g, out_prev, c_per) in one packed
    DCN call on these DCN inputs, as the route builds them."""
    from edvr_tpu_torch.ops import dcn
    seen = {}
    real_gather, real_blend = dcn.row_gather, dcn.blend_matmul_group

    def gather_spy(*a):
        seen.setdefault('gather', a)
        return real_gather(*a)

    def blend_spy(*a):
        seen.setdefault('blend', a)
        return real_blend(*a)

    dcn.row_gather, dcn.blend_matmul_group = gather_spy, blend_spy
    try:
        with packed_route(), torch.no_grad():
            dcn.modulated_deform_conv(*args, 1, 1, 1, 1, 8)
    finally:
        dcn.row_gather, dcn.blend_matmul_group = real_gather, real_blend
    return seen['gather'], seen['blend']


def blend_bound(g_cat, cs_cat, wexp_g, out_prev):
    """The blend GEMM's bound: 2*NP*width*cout fp32 operations taken as
    3xTF32 on the tensor cores (three TF32 products each) vs its inputs
    read once and its output written once. The fifth value is the bound
    with the operations on the fp32 pipe (a GEMM in fp32 FMAs), for
    comparison."""
    NP, width = g_cat.shape
    cout = wexp_g.shape[1]
    flops = 2 * NP * width * cout
    nbytes = 4 * (g_cat.numel() + cs_cat.numel() + wexp_g.numel()
                  + 2 * out_prev.numel())
    t_ops, t_bytes = 3 * flops / PEAK_TF32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes,
            max(flops / PEAK_OPS[torch.float32], t_bytes) * 1e3)


def gather_bound(table, idx):
    """The row gather's bound: each table row that these indices name read
    once, the G output rows of L floats written once, and the G indices
    read; no arithmetic."""
    G, L = idx.shape[0], table.shape[1]
    rows_read = torch.unique(idx).numel()
    nbytes = rows_read * L * 4 + G * L * 4 + G * 4
    return nbytes / PEAK_BYTES * 1e3, 'bytes', nbytes, rows_read


def dcn_packs(net):
    """An EDVR's four alignment packs (L3, L2, L1, cascade) by name."""
    align = net.pcd_align
    packs = {f'dcn_pack.{lv}': align.dcn_pack[lv] for lv in ('l3', 'l2', 'l1')}
    packs['cas_dcnpack'] = align.cas_dcnpack
    return packs


def record_sample_coords(net):
    """Forward hooks on every alignment pack's ``conv_offset`` of an EDVR:
    each call appends the float32 sample coordinates (cy, cx) of every
    (frame, group, tap, pixel), as the DCN computes them, under the pack's
    name. A DCNv2Pack (3x3 taps, padding 1) samples at pixel + tap +
    offset; a WarpAlignPack's K=1 warp (padding 0) at pixel + (dy, dx).
    Returns (records, handles)."""
    from edvr_tpu_torch.archs.arch_util import WarpAlignPack
    records, handles = {}, []

    def hook(name, K):
        def fn(module, inputs, out):
            o1, o2, _ = torch.chunk(out.detach(), 3, dim=1)
            n, _, h, w = o1.shape
            if K == 1:  # dy, dx of each group
                off = torch.stack((o1, o2), dim=2).view(n, -1, 1, 2, h, w)
            else:       # interleaved (dy, dx) per tap of each group
                off = torch.cat((o1, o2), dim=1).view(n, -1, K, 2, h, w)
            taps = torch.arange(K, device=off.device)
            pad = 1 if K == 9 else 0
            ys = (torch.arange(h, device=off.device).view(1, 1, 1, h, 1)
                  - pad + (taps // 3).view(1, 1, K, 1, 1)).float()
            xs = (torch.arange(w, device=off.device).view(1, 1, 1, 1, w)
                  - pad + (taps % 3).view(1, 1, K, 1, 1)).float()
            records.setdefault(name, []).append(
                ((ys + off[:, :, :, 0]).cpu(), (xs + off[:, :, :, 1]).cpu()))
        return fn

    for name, pack in dcn_packs(net).items():
        K = 1 if isinstance(pack, WarpAlignPack) else 9
        handles.append(pack.conv_offset.register_forward_hook(hook(name, K)))
    return records, handles


def coordinate_counts(card, cpu, tol=1e-5):
    """Per DCN call: the sample coordinates on the card within ``tol`` px of
    an integer, and those whose floor differs between card and CPU."""
    counts = {}
    for name in card:
        (cy, cx), (py, px) = card[name][0], cpu[name][0]
        near = lambda t: (t - t.round()).abs() < tol
        counts[name] = dict(
            samples=cy.numel(),
            near_integer=int((near(cy) | near(cx)).sum()),
            floor_differs=int(((cy.floor() != py.floor())
                               | (cx.floor() != px.floor())).sum()),
            max_coord_diff=float(torch.maximum((cy - py).abs().max(),
                                               (cx - px).abs().max())))
    return counts


def fp64_grads(net, batch):
    """The batch's gradients of every parameter of a float64 CPU copy of
    ``net`` under the engine's loss (Charbonnier, sum): the reference
    that tells a card/CPU gap from fp32 rounding."""
    from edvr_tpu_torch.models.losses import CharbonnierLoss
    ref = copy.deepcopy(net).cpu().double()
    out = ref(batch['lq'].double())
    CharbonnierLoss(loss_weight=1.0, reduction='sum')(
        out, batch['gt'].double()).backward()
    return {n: p.grad for n, p in ref.named_parameters()}


def fp64_check(grads, ref, names):
    """Each named gradient's distance from the float64 one, relative to
    the latter's largest entry, for each run in ``grads``."""
    return {n: {dev: rel_err(g[n].double(), ref[n])
                for dev, g in grads.items()} for n in names}


def kernel_category(name):
    """The category of a CUDA kernel, by its name in a profiler trace."""
    low = name.lower()
    for key in ('dcn_fwd', 'dcn_bwd'):
        if key in low:
            return key
    for category, keys in (
            ('layout_convert', ('nchwtonhwc', 'nhwctonchw')),
            ('optimizer', ('multi_tensor', 'adam')),
            ('conv_wgrad', ('wgrad',)), ('conv_dgrad', ('dgrad',)),
            ('conv_fprop_gemm', ('conv', 'cudnn', 'xmma', 'gemm', 'fprop',
                                 'winograd', 'implicit')),
            ('reduction', ('reduce',)),
            ('elementwise', ('elementwise', 'vectorized'))):
        if any(k in low for k in keys):
            return category
    return 'other'


def profile_steps(step, steps):
    """``steps`` calls of ``step`` under torch.profiler: kernel ms per step
    by category, launches per step, the top kernels, and the device's busy
    share of the profiled wall time (the profiler's own host overhead
    lowers it)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = osp.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    by_cat, by_name = {}, {}
    for e in kernels:
        cat = kernel_category(e['name'])
        by_cat[cat] = by_cat.get(cat, 0.) + e['dur']
        by_name[e['name'][:90]] = by_name.get(e['name'][:90], 0.) + e['dur']
    busy = sum(by_cat.values())
    per_step = lambda d: {k: v / steps / 1e3 for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])}
    return dict(steps=steps, launches_per_step=len(kernels) / steps,
                kernel_ms_per_step=busy / steps / 1e3,
                wall_ms_per_step=wall_us / steps / 1e3,
                busy_share_profiled=busy / wall_us,
                ms_per_step_by_category=per_step(by_cat),
                top_kernels_ms_per_step=dict(list(per_step(by_name)
                                                  .items())[:10]))


def step_grads(model, batch, it):
    """One training step's gradients of every parameter, on the CPU."""
    model.feed_data(batch)
    model.optimize_parameters(it)
    return {n: p.grad.detach().cpu() for n, p in
            model.net_g.named_parameters()}


def dcn_fwd_check(args, tag, ph):
    """The fp32 DCN forward kernel against the plain version on ``args``
    (x, offset, mask, weight, bias; stride, padding and dilation 1, dg 8):
    max abs error (fails above DCN_TOL), ms by CUDA events beside the
    plain version's, the bound and the GEMM alone. Returns the readings
    and puts them in the phase's line."""
    from edvr_tpu_torch.ops import dcn
    geo = (1, 1, 1)  # stride, padding, dilation
    with torch.no_grad():
        got = dcn.dcn_fwd_cuda(*args, *geo, 8)
        want = dcn.modulated_deform_conv_plain(*args, *geo, 1, 8)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= DCN_TOL:
            raise AssertionError(f'dcn_fwd {tag}: max abs err {err} > '
                                 f'{DCN_TOL}')
        del got, want
        ms = cuda_ms(lambda: dcn.dcn_fwd_cuda(*args, *geo, 8), 20)
        plain_ms = cuda_ms(
            lambda: dcn.modulated_deform_conv_plain(*args, *geo, 1, 8), 5)
    bound_ms, bound_by, flops, nbytes, fp32_pipe_ms = dcn_bound(*args)
    result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=bound_by,
                  bound_ms_fp32_pipe=fp32_pipe_ms,
                  library_ms=gemm_only_ms(args[0], args[3]))
    ph.info.update(shape=list(args[0].shape), tol=DCN_TOL,
                   gflop=flops / 1e9, mbytes=nbytes / 1e6, **result)
    return result


def blend_check(cases, c_per, tag, ph):
    """The blend GEMM kernel against its plain version on each case of
    (g_cat, cs_cat, wexp_g, out_prev) (fails above BLEND_TOL of max|out|),
    then ms of the first case by CUDA events beside the plain version, the
    bound and ``torch.addmm`` (the GEMM alone). Returns the readings and
    puts them in the phase's line."""
    from edvr_tpu_torch.ops import dcn_blend
    errs = {}
    with torch.no_grad():
        for case_tag, a in cases.items():
            got = dcn_blend.blend_matmul_cuda(*a, c_per)
            want = dcn_blend.blend_matmul_group_plain(*a, c_per)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            errs[f'err{case_tag}'] = err
            errs[f'max_abs_out{case_tag}'] = scale
            if not err <= BLEND_TOL * scale:
                raise AssertionError(
                    f'blend_matmul {tag}{case_tag}: max abs err {err} > '
                    f'{BLEND_TOL} x max|out| {scale}')
            del got, want
        args = cases['']
        ms = cuda_ms(lambda: dcn_blend.blend_matmul_cuda(*args, c_per), 20)
        plain_ms = cuda_ms(lambda: dcn_blend.blend_matmul_group_plain(
            *args, c_per), 5)
        blended = args[0] * args[1].repeat_interleave(c_per, 1)
        library_ms = cuda_ms(
            lambda: torch.addmm(args[3], blended, args[2]), 20)
        del blended
    bound_ms, bound_by, flops, nbytes, fp32_pipe_ms = blend_bound(*args)
    result = dict(max_abs_err=max(v for k, v in errs.items()
                                  if k.startswith('err')),
                  ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, bound_ms_fp32_pipe=fp32_pipe_ms,
                  library_ms=library_ms)
    ph.info.update(
        g_cat=list(args[0].shape), cs_cat=list(args[1].shape),
        wexp_g=list(args[2].shape), c_per=c_per,
        tol_rel_to_max_out=BLEND_TOL, gflop=flops / 1e9,
        mbytes=nbytes / 1e6, **errs, **result,
        library='torch.addmm(out_prev, blended, wexp_g): the GEMM alone, '
                'the blend formed beforehand')
    return result


def gather_check(table, rows, tag, ph):
    """The row-gather kernel, bitwise against ``index_select``, then ms by
    CUDA events beside the plain version, the bound and
    ``torch.index_select``. Returns the readings and puts them in the
    phase's line."""
    from edvr_tpu_torch.ops import gather
    with torch.no_grad():
        got = gather.row_gather_cuda(table, rows)
        want = gather.row_gather_plain(table, rows)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f'row_gather {tag}: not bitwise equal to '
                                 'index_select')
        err = (got - want).abs().max().item()
        del got, want
        ms = cuda_ms(lambda: gather.row_gather_cuda(table, rows), 20)
        plain_ms = cuda_ms(lambda: gather.row_gather_plain(table, rows), 20)
        library_ms = cuda_ms(lambda: torch.index_select(table, 0, rows), 20)
    bound_ms, bound_by, nbytes, rows_read = gather_bound(table, rows)
    result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=library_ms)
    ph.info.update(table=list(table.shape), gathers=rows.shape[0],
                   distinct_rows=rows_read, bitwise_equal=True,
                   mbytes=nbytes / 1e6, **result,
                   library='torch.index_select(table, 0, idx)')
    return result


def offset_ranges(net, window):
    """The least and largest offset that each DCN pack of an EDVR sends on
    ``window`` (the offset rows of its ``conv_offset`` output)."""
    ranges, handles = {}, []
    for name, pack in dcn_packs(net).items():
        def hook(module, inputs, out, name=name):
            off = out[:, :out.shape[1] * 2 // 3]
            ranges[name] = [off.min().item(), off.max().item()]
        handles.append(pack.conv_offset.register_forward_hook(hook))
    try:
        with torch.no_grad():
            net(window)
    finally:
        for handle in handles:
            handle.remove()
    return ranges


def seeded_edvr(net_opt, window, gen):
    """An EDVR of ``net_opt`` on the card with seeded weights: BasicSR's
    init from torch seed SEED (as ``create_model`` draws it), then each DCN
    pack's ``conv_offset`` weights (zero in a fresh EDVR) drawn from
    N(0, 1e-3) and its offset rows scaled, pack by pack on ``window``, so
    that the largest |offset| the pack sends is OFFSET_PX; the mask rows
    keep their small draw. Returns the net and each pack's offset range."""
    from edvr_tpu_torch.archs import define_network
    torch.manual_seed(SEED)
    net = define_network(copy.deepcopy(net_opt)).cuda().eval()
    packs = dcn_packs(net)
    with torch.no_grad():
        for pack in packs.values():
            w = pack.conv_offset.weight
            w.copy_(torch.randn(w.shape, generator=gen) * 1e-3)
        # two rounds: the cascade's input moves with L1's output
        for _ in range(2):
            ranges = offset_ranges(net, window)
            for name, pack in packs.items():
                rows = pack.conv_offset.weight.shape[0] * 2 // 3
                pack.conv_offset.weight[:rows] *= (
                    OFFSET_PX / max(abs(v) for v in ranges[name]))
    return net, offset_ranges(net, window)


def restore_ms(restore, clip, idx):
    """ms per window of one whole-clip restore, host clock around work
    that ends in ``torch.cuda.synchronize()``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore(clip, idx)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(idx) * 1e3


def engine_run(run):
    """``run(name)`` (one validation pass of the engine) timed after a
    warm-up pass (cuDNN's algorithm choice, the lazy kernel load), the
    launch counts set to 0 just before it and read just after: (seconds,
    launches, peak device bytes)."""
    from edvr_tpu_torch import native
    run('warmup')
    native.LAUNCHES.update({k: 0 for k in native.LAUNCHES})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run('timed')
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, dict(native.LAUNCHES),
            torch.cuda.max_memory_allocated())


def engine_model(opt_template, state, tmp, name):
    """``create_model`` of the option dict with ``state`` saved as its
    ``pretrain_network_g`` (.pth, strict load), on the card."""
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.utils.options import parse_dict
    opt = parse_dict(json.loads(json.dumps(opt_template)), is_train=False,
                     root=tmp)
    opt['device'] = 'cuda'
    ckpt = osp.join(tmp, f'{name}.pth')
    torch.save({'params': {k: v.cpu() for k, v in state.items()}}, ckpt)
    opt['path']['pretrain_network_g'] = ckpt
    return opt, create_model(opt)


def window_vs_cpu(net, net_opt, window):
    """One window through ``net`` on the card and through the plain CPU
    path with the same weights: (max abs err, card output, CPU seconds)."""
    from edvr_tpu_torch.archs import define_network
    with torch.no_grad():
        on_card = net(window.cuda()).cpu()
        cpu_net = define_network(copy.deepcopy(net_opt)).eval()
        cpu_net.load_state_dict({k: v.cpu() for k, v in
                                 net.state_dict().items()}, strict=True)
        t0 = time.perf_counter()
        on_cpu = cpu_net(window)
        cpu_secs = time.perf_counter() - t0
    err = (on_card - on_cpu).abs().max().item()
    if not (on_card.shape == on_cpu.shape and torch.isfinite(on_card).all()
            and err <= GOLDEN_TOL):
        raise AssertionError(f'window vs plain CPU path: shape '
                             f'{tuple(on_card.shape)}, max abs err {err} > '
                             f'{GOLDEN_TOL}')
    return err, on_card, cpu_secs


def write_png(path, frame):
    """A (3, h, w) RGB frame in [0, 1] as an 8-bit BGR PNG."""
    import cv2
    img = (frame.permute(1, 2, 0).numpy()[:, :, ::-1] * 255.).round()
    os.makedirs(osp.dirname(path), exist_ok=True)
    if not cv2.imwrite(path, img.astype(np.uint8)):
        raise IOError(f'cannot write {path}')


def write_vimeo(root, gen, seqs, lq_hw):
    """Seeded Vimeo90K septuplets on disk: ``<lq|gt>/<seq>/im1..im7.png``
    (LQ, the 4x box-downsampled GT) with ``im4.png`` as GT, and a meta-info
    file listing them."""
    h, w = lq_hw
    write = write_png
    for seq in seqs:
        lq, gt = seeded_clip(7, h, w, gen)
        for i in range(7):
            write(osp.join(root, 'lq', seq, f'im{i + 1}.png'), lq[i])
        write(osp.join(root, 'gt', seq, 'im4.png'), gt[3])
    meta = osp.join(root, 'meta_info.txt')
    with open(meta, 'w') as f:
        f.writelines(f'{s} ({4 * h},{4 * w},3)\n' for s in seqs)
    return meta


def edvr_l_phases(gen, smi, golden_state, golden_config):
    """The EDVR-L phases (kernel_l_*, edvr_l_main_path, edvr_l_pyramid,
    edvr_l_deblur, edvr_l_vimeo, packed_edvr_l); returns their readings
    for the kernels line."""
    from edvr_tpu_torch import native
    from edvr_tpu_torch.archs import define_network
    from edvr_tpu_torch.archs.edvr_arch import (clip_window_indices,
                                                make_clip_restore_fn)
    from edvr_tpu_torch.data import create_dataloader, create_dataset
    from edvr_tpu_torch.metrics import calculate_psnr
    from edvr_tpu_torch.utils import tensor2img
    out = {'kernel': {}, 'launches': {}, 'blend': {}, 'gather': {}}

    # the DCN forward at EDVR-L's shapes: c_per 16, cout 128
    levels = [(lv, hw, 5) for lv, hw in LEVELS.items()]
    levels.append(('L1_n7', LEVELS['L1'], 7))  # Vid4 / Vimeo90K windows
    for level, (h, w), n in levels:
        with Phase(f'kernel_l_{level}') as ph:
            out['kernel'][level] = dcn_fwd_check(
                dcn_inputs(h, w, gen, n=n, c=128), f'EDVR-L {level}', ph)
            ph.info['card'] = smi

    T, h, w = L_CLIP
    idx = clip_window_indices(T, 5, 'reflection_circle')
    with Phase('edvr_l_main_path') as ph, tempfile.TemporaryDirectory() as tmp:
        # the REDS4 protocol from disk: a seeded clip written as PNGs, read
        # by VideoTestDataset (cache_data), restored by the engine's
        # validation in clip mode
        lq_clip, gt_clip = seeded_clip(T, h, w, gen)
        root = osp.join(tmp, 'reds4')
        for i in range(T):
            write_png(osp.join(root, 'lq', '000', f'{i:08d}.png'),
                      lq_clip[i])
            write_png(osp.join(root, 'gt', '000', f'{i:08d}.png'),
                      gt_clip[i])
        l_opt = json.loads(json.dumps(EDVR_L_OPT))
        l_opt['datasets']['test_1'].update(dataroot_gt=f'{root}/gt',
                                           dataroot_lq=f'{root}/lq')
        dataset_opt = dict(l_opt['datasets']['test_1'], phase='test')
        dataset = create_dataset(dataset_opt)
        loader = create_dataloader(dataset, dataset_opt)
        lq = dataset.imgs_lq['000']
        net, ranges = seeded_edvr(EDVR_L_NET, lq[idx[0]][None].cuda(), gen)
        state = net.state_dict()
        del net
        opt, model = engine_model(l_opt, state, tmp, 'edvr_l_seeded')
        secs, launches, peak = engine_run(
            lambda name: model.validation(loader, name, None, False))
        if launches != launch_counts(dcn_fwd=4 * T):
            raise AssertionError(f'EDVR-L main path launches {launches}, '
                                 f'expected dcn_fwd 4 x {T} windows')
        psnr = model.metric_results['000'][:, 0]
        if not (psnr.shape == (T,) and np.isfinite(psnr).all()):
            raise AssertionError(f'EDVR-L PSNR table not finite: {psnr}')
        net = model.net_g
        lq_card = lq.cuda()
        net_ms = restore_ms(make_clip_restore_fn(net), lq_card, idx)
        err, _, cpu_secs = window_vs_cpu(net, EDVR_L_NET, lq[idx[0]][None])
        out['launches']['edvr_l_main_path'] = launches['dcn_fwd']
        ph.info.update(frames=T, lq_hw=[h, w], windows=T, win_batch=1,
                       network=EDVR_L_NET, cuts=L_CUTS + [
                           'REDS4 100 frames -> a seeded 12-frame clip on '
                           'disk'],
                       offset_range_px=ranges, dcn_launches=launches['dcn_fwd'],
                       seconds_restore=secs, ms_per_window=secs / T * 1e3,
                       fps=T / secs, peak_mem_bytes=peak,
                       network_ms_per_window=net_ms,
                       psnr_mean=float(psnr.mean()),
                       window_vs_cpu_max_abs_err=err, tol=GOLDEN_TOL,
                       cpu_window_seconds=cpu_secs, card=smi)
        del model

    with Phase('edvr_l_pyramid') as ph:
        m_net = define_network(golden_config)
        m_net.load_state_dict(golden_state, strict=True)
        nets = {'edvr_l': net, 'edvr_m': m_net.cuda().eval()}
        modes = {}
        for name, model_net in nets.items():
            fns = {mode: make_clip_restore_fn(model_net, mode=mode)
                   for mode in ('window', 'pyramid')}
            outs = {mode: fn(lq_card, idx) for mode, fn in fns.items()}
            err = (outs['pyramid'] - outs['window']).abs().max().item()
            del outs
            if not err <= MODE_TOL:
                raise AssertionError(f'{name} pyramid vs window mode: max '
                                     f'abs err {err} > {MODE_TOL}')
            ms = {'window': [], 'pyramid': []}
            for mode in ('window', 'pyramid', 'pyramid', 'window'):
                ms[mode].append(restore_ms(fns[mode], lq_card, idx))
            native.LAUNCHES.update({k: 0 for k in native.LAUNCHES})
            torch.cuda.reset_peak_memory_stats()
            fns['pyramid'](lq_card, idx)
            torch.cuda.synchronize()
            launches = dict(native.LAUNCHES)
            if launches != launch_counts(dcn_fwd=4 * T):
                raise AssertionError(f'{name} pyramid launches {launches}')
            modes[name] = dict(max_abs_err_vs_window=err,
                               window_ms_per_window=ms['window'],
                               pyramid_ms_per_window=ms['pyramid'],
                               pyramid_peak_mem_bytes=(
                                   torch.cuda.max_memory_allocated()),
                               pyramid_dcn_launches=launches['dcn_fwd'])
        out['launches']['edvr_l_pyramid'] = modes['edvr_l'][
            'pyramid_dcn_launches']
        ph.info.update(frames=T, lq_hw=[h, w], win_batch=1, tol=MODE_TOL,
                       order='window, pyramid, pyramid, window',
                       store_dtype='float32', **modes, card=smi)
        del nets, m_net

    # the deblur configuration: HR input and pre-deblur, 720x1280 frames
    lq_s, gt_d = seeded_clip(DEBLUR_T, h, w, gen)
    blur = F.interpolate(lq_s, scale_factor=4, mode='bilinear',
                         align_corners=False)
    idx_d = clip_window_indices(DEBLUR_T, 5, 'reflection_circle')
    with Phase('edvr_l_deblur') as ph, tempfile.TemporaryDirectory() as tmp:
        d_net_opt = EDVR_L_DEBLUR_OPT['network_g']
        d_net, ranges = seeded_edvr(d_net_opt, blur[idx_d[0]][None].cuda(),
                                    gen)
        state = d_net.state_dict()
        del d_net
        opt, model = engine_model(EDVR_L_DEBLUR_OPT, state, tmp,
                                  'edvr_l_deblur_seeded')
        clips = InMemoryClips(opt['datasets']['test_1'], blur, gt_d)
        secs, launches, peak = engine_run(
            lambda name: model._clip_validation(clips, name, None, False))
        if launches != launch_counts(dcn_fwd=4 * DEBLUR_T):
            raise AssertionError(f'deblur launches {launches}')
        psnr = model.metric_results['000'][:, 0]
        if not (psnr.shape == (DEBLUR_T,) and np.isfinite(psnr).all()):
            raise AssertionError(f'deblur PSNR table not finite: {psnr}')
        net_ms = restore_ms(make_clip_restore_fn(model.net_g), blur.cuda(),
                            idx_d)
        ch, cw = DEBLUR_CPU_CROP
        err, _, cpu_secs = window_vs_cpu(
            model.net_g, d_net_opt, blur[idx_d[0]][None, :, :, :ch, :cw])
        out['launches']['edvr_l_deblur'] = launches['dcn_fwd']
        del model

        # test_EDVR_L_x4_SRblur_REDS.yml: pre-deblur on LQ input
        sb_net, sb_ranges = seeded_edvr(EDVR_L_SRBLUR_NET,
                                        lq[idx[0]][None].cuda(), gen)
        native.LAUNCHES.update({k: 0 for k in native.LAUNCHES})
        with torch.no_grad():
            full = sb_net(lq_card[idx[0]][None])
        torch.cuda.synchronize()
        sb_launches = dict(native.LAUNCHES)
        if not (sb_launches == launch_counts(dcn_fwd=4)
                and full.shape == (1, 3, 4 * h, 4 * w)
                and torch.isfinite(full).all()):
            raise AssertionError(f'SRblur window: {tuple(full.shape)}, '
                                 f'launches {sb_launches}')
        sh, sw = SRBLUR_CPU_CROP
        sb_err, _, sb_cpu_secs = window_vs_cpu(
            sb_net, EDVR_L_SRBLUR_NET, lq[idx[0]][None, :, :, :sh, :sw])
        ph.info.update(
            frames=DEBLUR_T, hr_hw=list(blur.shape[-2:]), windows=DEBLUR_T,
            network=d_net_opt, cuts=L_CUTS + [
                f'REDS4 blurred 100 frames -> {DEBLUR_T} seeded frames, '
                'the blur a 4x bilinear upsampling of the 4x box-downsampled '
                'GT',
                f'CPU check on an HR crop {list(DEBLUR_CPU_CROP)} of the '
                'first window (the CPU path at 720x1280 takes minutes)'],
            offset_range_px=ranges, dcn_launches=launches['dcn_fwd'],
            ms_per_window=secs / DEBLUR_T * 1e3,
            network_ms_per_window=net_ms, peak_mem_bytes=peak,
            psnr_mean=float(psnr.mean()), crop_vs_cpu_max_abs_err=err,
            cpu_crop_seconds=cpu_secs, tol=GOLDEN_TOL,
            srblur=dict(network=EDVR_L_SRBLUR_NET, lq_hw=[h, w],
                        offset_range_px=sb_ranges,
                        dcn_launches=sb_launches['dcn_fwd'],
                        cpu_crop_lq_hw=list(SRBLUR_CPU_CROP),
                        crop_vs_cpu_max_abs_err=sb_err,
                        cpu_crop_seconds=sb_cpu_secs),
            card=smi)
        del sb_net, full

    with Phase('edvr_l_vimeo') as ph, tempfile.TemporaryDirectory() as tmp:
        seqs = [f'{i + 1:05d}/0001' for i in range(VIMEO_SEQS)]
        root = osp.join(tmp, 'vimeo')
        meta = write_vimeo(root, gen, seqs, (64, 112))
        v_opt = json.loads(json.dumps(EDVR_L_VIMEO_OPT))
        v_opt['datasets']['test_1'].update(dataroot_gt=f'{root}/gt',
                                           dataroot_lq=f'{root}/lq',
                                           meta_info_file=meta)
        dataset_opt = dict(v_opt['datasets']['test_1'], phase='test')
        dataset = create_dataset(dataset_opt)
        v_net, ranges = seeded_edvr(v_opt['network_g'],
                                    dataset[0]['lq'][None].cuda(), gen)
        state = v_net.state_dict()
        del v_net
        opt, model = engine_model(v_opt, state, tmp, 'edvr_l_vimeo_seeded')
        loader = create_dataloader(dataset, dataset_opt)
        results = []
        visuals = model.get_current_visuals
        model.get_current_visuals = lambda: results.append(visuals()) or \
            results[-1]
        model.validation(loader, 'warmup', None, save_img=False)
        results.clear()
        native.LAUNCHES.update({k: 0 for k in native.LAUNCHES})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.validation(loader, opt['name'], None, save_img=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(native.LAUNCHES)
        if launches != launch_counts(dcn_fwd=4 * VIMEO_SEQS):
            raise AssertionError(f'Vimeo90K launches {launches}')
        psnr = model.metric_results['vimeo90k'][:, 0]
        if not (psnr.shape == (VIMEO_SEQS,) and np.isfinite(psnr).all()):
            raise AssertionError(f'Vimeo90K PSNR table: {psnr}')
        # each per-window result is the direct forward of its window
        direct_errs, psnr_direct = [], []
        for i, vis in enumerate(results):
            item = dataset[i]
            with torch.no_grad():
                direct = model.net_g(item['lq'][None].cuda()).cpu()
            direct_errs.append((vis['result'] - direct).abs().max().item())
            psnr_direct.append(calculate_psnr(tensor2img(direct),
                                              tensor2img(item['gt']), 0))
        if not (len(results) == VIMEO_SEQS and max(direct_errs) <= 1e-6
                and np.allclose(psnr_direct, psnr, rtol=1e-5)):
            raise AssertionError(f'Vimeo90K per-window vs direct forward: '
                                 f'{direct_errs}, PSNR {psnr} vs '
                                 f'{psnr_direct}')
        out['launches']['edvr_l_vimeo'] = launches['dcn_fwd']
        ph.info.update(sequences=VIMEO_SEQS, lq_hw=[64, 112],
                       gt_hw=[256, 448], num_frame=7, protocol='per-window',
                       network=v_opt['network_g'], cuts=L_CUTS + [
                           f'Vimeo90K test 7824 septuplets -> {VIMEO_SEQS} '
                           'seeded synthetic ones'],
                       offset_range_px=ranges,
                       dcn_launches=launches['dcn_fwd'],
                       psnr_per_sequence=[float(p) for p in psnr],
                       ms_per_sequence=secs / VIMEO_SEQS * 1e3,
                       vs_direct_forward_max_abs_err=max(direct_errs),
                       card=smi)
        del model, results

    with Phase('packed_edvr_l') as ph:
        # the packed route's kernels at EDVR-L's shapes: PX = 4 pixels per
        # 128-lane row, blend width 9 x 128, cout 128
        kernels = {}
        for level, (lh, lw) in LEVELS.items():
            dcn_args = dcn_inputs(lh, lw, gen, c=128)
            gather_args, (*args, c_per) = packed_kernel_inputs(dcn_args)
            del dcn_args
            sub = types.SimpleNamespace(info={})
            out['blend'][level] = blend_check({'': args}, c_per, level, sub)
            kernels[f'blend_{level}'] = sub.info
            del args
            if level == 'L1':
                sub = types.SimpleNamespace(info={})
                out['gather']['L1'] = gather_check(*gather_args, 'L1', sub)
                kernels['gather_L1'] = sub.info
            del gather_args
        T3 = PACKED_L_T
        lq3, idx3 = lq_card[:T3].contiguous(), clip_window_indices(
            T3, 5, 'reflection_circle')
        restore = make_clip_restore_fn(net)
        direct = restore(lq3, idx3)
        direct_ms = restore_ms(restore, lq3, idx3)
        with packed_route():
            restore(lq3, idx3)  # warm-up
            native.LAUNCHES.update({k: 0 for k in native.LAUNCHES})
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            packed = restore(lq3, idx3)
            torch.cuda.synchronize()
            packed_ms = (time.perf_counter() - t0) / T3 * 1e3
            launches = dict(native.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
        expect = launch_counts(row_gather=32 * T3, blend_matmul=32 * T3)
        if launches != expect:
            raise AssertionError(f'packed EDVR-L launches {launches}, '
                                 f'expected {expect}')
        err = (packed - direct).abs().max().item()
        if not (torch.isfinite(packed).all() and err <= GOLDEN_TOL):
            raise AssertionError(f'packed vs direct EDVR-L: max abs err '
                                 f'{err} > {GOLDEN_TOL}')
        out['launches']['packed_edvr_l'] = launches
        ph.info.update(frames=T3, lq_hw=[h, w], windows=T3,
                       launches=launches, ms_per_window=packed_ms,
                       direct_ms_per_window=direct_ms, peak_mem_bytes=peak,
                       vs_direct_route_max_abs_err=err, tol=GOLDEN_TOL,
                       kernels=kernels, card=smi)
        del packed, direct, net
    return out


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this run '
              'needs a CUDA card', file=sys.stderr)
        return 1
    from edvr_tpu_torch import native
    from edvr_tpu_torch.archs import arch_util, define_network
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
        with Phase(f'kernel_{level}') as ph:
            results[level] = dcn_fwd_check(dcn_inputs(h, w, gen), level, ph)

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

        if launches != launch_counts(dcn_fwd=4 * T):
            raise AssertionError(f'main path launches {launches}, expected '
                                 f'dcn_fwd 4 x {T} windows and no other')
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
            bound_ms, bound_by, flops, nbytes, fp32_pipe_ms = dcn_bwd_bound(
                *args[:4])
            f_bound_ms, f_bound_by, _, _, f_fp32_pipe_ms = dcn_bound(*args)
            bwd_results[level] = dict(
                max_abs_err=max(e['max_abs_err'] for e in errs.values()),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_ms_fp32_pipe=fp32_pipe_ms)
            fwd_train[level] = dict(max_abs_err=fwd_err, ms=fwd_ms,
                                    plain_ms=fwd_plain_ms,
                                    bound_ms=f_bound_ms, bound_by=f_bound_by,
                                    bound_ms_fp32_pipe=f_fp32_pipe_ms)
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
        if any(c != launch_counts(dcn_fwd=4, dcn_bwd=4) for c in per_step):
            raise AssertionError(f'DCN launches per step: {per_step}')

        # one batch-1 step's gradients: the card against the plain CPU path
        one = {k: v[:1] for k, v in batches[-1].items()}
        cpu_opt = json.loads(json.dumps(opt))
        cpu_opt['device'] = 'cpu'
        cpu_opt['path']['pretrain_network_g'] = None
        cpu_model = create_model(cpu_opt)
        cpu_model.net_g.load_state_dict(model.net_g.state_dict())
        ref64 = fp64_grads(cpu_model.net_g, one)
        grads, coords = {}, {}
        for name, m in (('cuda', model), ('cpu', cpu_model)):
            coords[name], handles = record_sample_coords(m.net_g)
            grads[name] = step_grads(m, one, TRAIN_STEPS + 1)
            for handle in handles:
                handle.remove()
        grad_errs = {n: rel_err(grads['cuda'][n], g)
                     for n, g in grads['cpu'].items()}
        worst = max(grad_errs, key=grad_errs.get)
        top5 = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:5]
        # does the gap come with sample coordinates at an integer, where
        # d sample / d offset jumps and card and CPU may take other floors?
        # and is the card or the CPU the farther from float64?
        coord_counts = coordinate_counts(coords['cuda'], coords['cpu'])
        vs_fp64 = fp64_check(grads, ref64, [n for n, _ in top5[:3]])
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
            grad_vs_cpu_top5=top5, grad_vs_fp64=vs_fp64,
            grad_tol=STEP_GRAD_TOL, sample_coords=coord_counts, card=smi)
        del model, cpu_model

    blend_results, gather_in = {}, {}
    for level, (h, w) in LEVELS.items():
        with Phase(f'kernel_blend_{level}') as ph, torch.no_grad():
            dcn_args = dcn_inputs(h, w, gen)
            gather_args, (*args, c_per) = packed_kernel_inputs(dcn_args)
            if level == 'L1':
                gather_in['L1'] = gather_args
            cases = {'': args}
            if level == 'L1':  # a ragged last block of rows
                cases['_ragged'] = [a[:1013].contiguous() if a.shape[0] ==
                                    args[0].shape[0] else a for a in args]
            blend_results[level] = blend_check(cases, c_per, level, ph)
            del dcn_args, gather_args, args, cases

    gather_results = {}
    probe_gen = torch.Generator().manual_seed(SEED + 2)
    for rows in PROBE_ROWS:
        for G in (4096, 8 * rows):
            gather_in[f'probe_{rows}x{G}'] = (
                torch.rand(rows, PROBE_LANES, generator=probe_gen).cuda(),
                torch.randint(0, rows, (G,), generator=probe_gen,
                              dtype=torch.int32).cuda())
    for tag in [t for t in gather_in if t != 'L1'] + ['L1']:
        table, rows = gather_in[tag]
        with Phase(f'kernel_gather_{tag}') as ph:
            gather_results[tag] = gather_check(table, rows, tag, ph)
    del gather_in, table, rows

    T2 = PACKED_T
    lq2, gt2 = lq[:T2].contiguous(), gt[:T2].contiguous()
    with Phase('packed_main_path') as ph, tempfile.TemporaryDirectory() as tmp, \
            packed_route():
        opt = parse_dict(json.loads(json.dumps(EDVR_M_OPT)), is_train=False,
                         root=tmp)
        opt['device'] = 'cuda'
        ckpt = osp.join(tmp, 'edvr_m_golden.pth')
        torch.save({'params': state}, ckpt)
        opt['path']['pretrain_network_g'] = ckpt
        model = create_model(opt)
        clips = InMemoryClips(opt['datasets']['test_1'], lq2, gt2)
        model._clip_validation(clips, 'warmup', None, save_img=False)

        dcn.LAUNCHES.update({k: 0 for k in dcn.LAUNCHES})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model._clip_validation(clips, opt['name'], None, save_img=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        packed_launches = dict(dcn.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()

        # 8 deformable groups: one gather and one blend each per DCN call,
        # 4 DCN calls per window
        expect = launch_counts(row_gather=32 * T2, blend_matmul=32 * T2)
        if packed_launches != expect:
            raise AssertionError(f'packed main path launches '
                                 f'{packed_launches}, expected {expect}')
        psnr = model.metric_results['000'][:, 0]
        if not (psnr.shape == (T2,) and np.isfinite(psnr).all()):
            raise AssertionError(f'PSNR table not finite: {psnr}')

        idx2 = clip_window_indices(T2, 5, 'reflection_circle')
        restore = make_clip_restore_fn(model.net_g)
        lq2_card = lq2.cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(lq2_card, idx2)
        torch.cuda.synchronize()
        net_secs = time.perf_counter() - t0

        # main_path's first window on the packed route, against the direct
        # route on the card and the plain CPU path
        packed_win = restore(lq_card, idx[:1]).cpu()
        errs = {'vs_direct_route_card': (packed_win - on_card).abs().max()
                .item(),
                'vs_plain_cpu': (packed_win - on_cpu).abs().max().item()}
        if not (torch.isfinite(packed_win).all()
                and max(errs.values()) <= GOLDEN_TOL):
            raise AssertionError(f'packed window: max abs err {errs} > '
                                 f'{GOLDEN_TOL}')
        ph.info.update(frames=T2, lq_hw=list(lq2.shape[-2:]), windows=T2,
                       win_batch=1, launches=packed_launches,
                       launches_per_dcn_call={'row_gather': 8,
                                              'blend_matmul': 8},
                       seconds_restore=secs, ms_per_window=secs / T2 * 1e3,
                       fps=T2 / secs, peak_mem_bytes=peak,
                       network_ms_per_window=net_secs / T2 * 1e3,
                       psnr_mean=float(psnr.mean()),
                       window_max_abs_err=errs, tol=GOLDEN_TOL, card=smi)
        del model, restore

    with Phase('packed_train') as ph, tempfile.TemporaryDirectory() as tmp, \
            packed_route():
        opt = parse_dict(json.loads(json.dumps(EDVR_M_TRAIN_OPT)),
                         is_train=True, root=tmp)
        opt['train']['total_iter'] = PACKED_STEPS
        opt['device'] = 'cuda'
        ckpt = osp.join(tmp, 'edvr_m_golden.pth')
        torch.save({'params': state}, ckpt)
        opt['path']['pretrain_network_g'] = ckpt
        model = create_model(opt)
        batches = train_batches(gen, PACKED_STEPS, BATCH,
                                random.Random(SEED + 1))
        losses, step_secs, per_step = [], [], []
        torch.cuda.reset_peak_memory_stats()
        dcn.LAUNCHES.update({k: 0 for k in dcn.LAUNCHES})
        for it, batch in enumerate(batches, 1):
            counts = dict(dcn.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.feed_data(batch)
            model.optimize_parameters(it)
            torch.cuda.synchronize()
            step_secs.append(time.perf_counter() - t0)
            per_step.append({k: dcn.LAUNCHES[k] - counts[k] for k in counts})
            losses.append(float(model.log_dict['l_pix']))
        packed_train_launches = dict(dcn.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)):
            raise AssertionError(f'packed training losses not finite: '
                                 f'{losses}')
        if any(c != launch_counts(row_gather=32, blend_matmul=32)
               for c in per_step):
            raise AssertionError(f'packed launches per step: {per_step}')

        # one batch-1 step's gradients: the packed route against the
        # direct route, both on the card, from the same parameters
        one = {k: v[:1] for k, v in batches[-1].items()}
        direct_opt = json.loads(json.dumps(opt))
        direct_opt['path']['pretrain_network_g'] = None
        direct = create_model(direct_opt)
        direct.net_g.load_state_dict(model.net_g.state_dict())
        packed_grads = step_grads(model, one, PACKED_STEPS + 1)
        os.environ.pop('EDVR_TPU_DCN_PALLAS')
        direct_grads = step_grads(direct, one, PACKED_STEPS + 1)
        os.environ['EDVR_TPU_DCN_PALLAS'] = '1'
        grad_errs = {n: rel_err(packed_grads[n], g)
                     for n, g in direct_grads.items()}
        worst_p = max(grad_errs, key=grad_errs.get)
        if not grad_errs[worst_p] <= STEP_GRAD_TOL:
            raise AssertionError(f'packed vs direct gradients: {worst_p} '
                                 f'rel err {grad_errs[worst_p]} > '
                                 f'{STEP_GRAD_TOL}')
        timed = sorted(step_secs)
        ph.info.update(
            steps=PACKED_STEPS, batch=BATCH, lq_crop=64, pcd_n=TRAIN_N,
            cuts=CUTS[:2] + [f'train.total_iter: 600000 -> {PACKED_STEPS} '
                             'steps'] + CUTS[3:],
            losses=losses, launches=packed_train_launches,
            launches_per_step=per_step[0],
            ms_per_step_median=timed[len(timed) // 2] * 1e3,
            ms_per_step_all=[t * 1e3 for t in step_secs],
            peak_mem_bytes=peak,
            grad_vs_direct_worst=[worst_p, grad_errs[worst_p]],
            grad_tol=STEP_GRAD_TOL, card=smi)
        del model, direct, packed_grads, direct_grads

    with Phase('tapshared_train') as ph, tempfile.TemporaryDirectory() as tmp:
        opt = parse_dict(json.loads(json.dumps(EDVR_M_TAPSHARED_OPT)),
                         is_train=True, root=tmp)
        opt['train']['total_iter'] = PACKED_STEPS
        opt['device'] = 'cuda'
        torch.manual_seed(SEED)
        model = create_model(opt)
        with torch.no_grad():
            for name, p in model.net_g.named_parameters():
                if 'conv_offset.weight' in name:
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
        batches = train_batches(gen, PACKED_STEPS, BATCH,
                                random.Random(SEED + 2))
        losses, step_secs, per_step = [], [], []
        torch.cuda.reset_peak_memory_stats()
        dcn.LAUNCHES.update({k: 0 for k in dcn.LAUNCHES})
        for it, batch in enumerate(batches, 1):
            counts = dict(dcn.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.feed_data(batch)
            model.optimize_parameters(it)
            torch.cuda.synchronize()
            step_secs.append(time.perf_counter() - t0)
            per_step.append({k: dcn.LAUNCHES[k] - counts[k] for k in counts})
            losses.append(float(model.log_dict['l_pix']))
        tap_launches = dict(dcn.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)):
            raise AssertionError(f'tap_shared losses not finite: {losses}')
        if any(c != launch_counts(dcn_fwd=4, dcn_bwd=4) for c in per_step):
            raise AssertionError(f'tap_shared launches per step: {per_step}')

        one = {k: v[:1] for k, v in batches[-1].items()}
        cpu_opt = json.loads(json.dumps(opt))
        cpu_opt['device'] = 'cpu'
        cpu_model = create_model(cpu_opt)
        cpu_model.net_g.load_state_dict(model.net_g.state_dict())
        ref64 = fp64_grads(cpu_model.net_g, one)
        # C.3: the same step on the card once with cuDNN off and once with
        # the DCN's plain version in place of its kernels, to tell which op
        # carries the card's distance from float64
        probes = {}
        for tag in ('cuda_cudnn_off', 'cuda_plain_dcn'):
            probe = create_model(json.loads(json.dumps(opt)))
            probe.net_g.load_state_dict(model.net_g.state_dict())
            # set by hand: cudnn.flags() would also turn TF32 back on
            if tag == 'cuda_cudnn_off':
                torch.backends.cudnn.enabled = False
            else:
                arch_util.modulated_deform_conv = \
                    dcn.modulated_deform_conv_plain
            try:
                probes[tag] = step_grads(probe, one, PACKED_STEPS + 1)
            finally:
                torch.backends.cudnn.enabled = True
                arch_util.modulated_deform_conv = dcn.modulated_deform_conv
            del probe
        grads, coords = {}, {}
        for name, m in (('cuda', model), ('cpu', cpu_model)):
            coords[name], handles = record_sample_coords(m.net_g)
            grads[name] = step_grads(m, one, PACKED_STEPS + 1)
            for handle in handles:
                handle.remove()
        grad_errs = {n: rel_err(grads['cuda'][n], g)
                     for n, g in grads['cpu'].items()}
        worst_t = max(grad_errs, key=grad_errs.get)
        top5 = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:5]
        tap_coords = coordinate_counts(coords['cuda'], coords['cpu'])
        tap_fp64 = fp64_check(dict(grads, **probes), ref64,
                              [n for n, _ in top5[:3]])
        if not grad_errs[worst_t] <= STEP_GRAD_TOL:
            raise AssertionError(f'tap_shared card vs CPU gradients: '
                                 f'{worst_t} rel err {grad_errs[worst_t]} '
                                 f'> {STEP_GRAD_TOL}')
        timed = sorted(step_secs)
        ph.info.update(
            steps=PACKED_STEPS, batch=BATCH, lq_crop=64, pcd_n=TRAIN_N,
            align_variant='tap_shared', cuts=CUTS[:2] + TAPSHARED_CUTS
            + CUTS[3:4] + CUTS[5:], losses=losses, launches=tap_launches,
            launches_per_step=per_step[0],
            ms_per_step_median=timed[len(timed) // 2] * 1e3,
            ms_per_step_all=[t * 1e3 for t in step_secs],
            peak_mem_bytes=peak, grad_vs_cpu_worst=[worst_t,
                                                    grad_errs[worst_t]],
            grad_vs_cpu_top5=top5, grad_vs_fp64=tap_fp64,
            grad_tol=STEP_GRAD_TOL, sample_coords=tap_coords, card=smi)
        del model, cpu_model

    bf16 = torch.bfloat16
    bf16_fwd, bf16_bwd = {}, {}
    levels = [(lv, hw, 5) for lv, hw in LEVELS.items()]
    levels += [(f'train_{lv}', hw, TRAIN_N) for lv, hw in TRAIN_LEVELS.items()]
    for level, (h, w), n in levels:
        with Phase(f'kernel_bf16_{level}') as ph:
            args32 = dcn_inputs(h, w, gen, n=n)
            args = [a.to(bf16) for a in args32]
            geo = (1, 1, 1)  # stride, padding, dilation
            with torch.no_grad():
                got = dcn.dcn_fwd_cuda(*args, *geo, 8)
                want = dcn.modulated_deform_conv_plain(*args, *geo, 1, 8)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            if not (got.dtype == bf16 and err <= BF16_FWD_TOL):
                raise AssertionError(f'dcn_fwd_bf16 {level}: {got.dtype}, '
                                     f'rel err {err} > {BF16_FWD_TOL}')
            ms = cuda_ms(lambda: dcn.dcn_fwd_cuda(*args, *geo, 8), 20)
            with torch.no_grad():
                plain_ms = cuda_ms(lambda: dcn.modulated_deform_conv_plain(
                    *args, *geo, 1, 8), 5)
            fp32_ms = cuda_ms(lambda: dcn.dcn_fwd_cuda(*args32, *geo, 8), 20)
            bound_ms, bound_by, flops, nbytes, fp32_pipe_ms = dcn_bound(*args)
            bf16_fwd[level] = dict(
                max_abs_err=(got.float() - want.float()).abs().max().item(),
                rel_err=err, ms=ms, plain_ms=plain_ms, fp32_ms=fp32_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_ms_fp32_pipe=fp32_pipe_ms,
                library_ms=gemm_only_ms(args[0], args[3]))
            ph.info.update(shape=list(args[0].shape), dtype='bf16',
                           tol_rel_to_max_out=BF16_FWD_TOL,
                           gflop=flops / 1e9, mbytes=nbytes / 1e6,
                           **bf16_fwd[level], card=smi)
            if n == TRAIN_N:  # the training shapes: the backward too
                dout = torch.randn(want.shape, generator=gen).cuda().to(bf16)
                got = dcn.dcn_bwd_cuda(dout, *args[:4], *geo, 8)
                leaves = [a.clone().requires_grad_() for a in args[:4]]
                plain_out = dcn.modulated_deform_conv_plain(
                    *leaves, args[4], *geo, 1, 8)
                want = torch.autograd.grad(plain_out, leaves, dout,
                                           retain_graph=True)
                # the gradient at the same bf16 values in float32, for
                # reference (not gated)
                leaves32 = [a.float().requires_grad_() for a in args[:4]]
                exact = torch.autograd.grad(
                    dcn.modulated_deform_conv_plain(
                        *leaves32, args[4].float(), *geo, 1, 8),
                    leaves32, dout.float())
                torch.cuda.synchronize()
                errs = {}
                for name, g, w_, e in zip(('dx', 'd_offset', 'd_mask',
                                           'd_weight'), got, want, exact):
                    errs[name] = dict(rel_err=rel_err(g, w_),
                                      rel_err_vs_f32=rel_err(g, e),
                                      plain_rel_err_vs_f32=rel_err(w_, e))
                    if not (g.dtype == bf16 and g.shape == w_.shape
                            and torch.isfinite(g.float()).all()
                            and errs[name]['rel_err'] <= BF16_BWD_TOL):
                        raise AssertionError(f'dcn_bwd_bf16 {level} {name}: '
                                             f'{errs[name]} > {BF16_BWD_TOL}')
                bms = cuda_ms(lambda: dcn.dcn_bwd_cuda(dout, *args[:4], *geo,
                                                       8), 20)
                bplain_ms = cuda_ms(lambda: torch.autograd.grad(
                    plain_out, leaves, dout, retain_graph=True), 5)
                dout32 = dout.float()
                bfp32_ms = cuda_ms(lambda: dcn.dcn_bwd_cuda(
                    dout32, *args32[:4], *geo, 8), 20)
                (b_bound_ms, b_bound_by, b_flops, b_nbytes,
                 b_fp32_pipe_ms) = dcn_bwd_bound(*args[:4])
                bf16_bwd[level] = dict(
                    max_abs_err=max((g.float() - w_.float()).abs().max()
                                    .item() for g, w_ in zip(got, want)),
                    ms=bms, plain_ms=bplain_ms, fp32_ms=bfp32_ms,
                    bound_ms=b_bound_ms, bound_by=b_bound_by,
                    bound_ms_fp32_pipe=b_fp32_pipe_ms,
                    fp32_bound_ms=dcn_bwd_bound(*args32[:4])[0])
                ph.info.update(bwd=dict(bf16_bwd[level], gradients=errs,
                                        tol_rel_to_max=BF16_BWD_TOL,
                                        gflop=b_flops / 1e9,
                                        mbytes=b_nbytes / 1e6))
                del leaves, leaves32, plain_out, want, exact, got
            del args, args32

    with Phase('mp_train') as ph, tempfile.TemporaryDirectory() as tmp:
        ckpt = osp.join(tmp, 'edvr_m_golden.pth')
        torch.save({'params': state}, ckpt)

        def mp_model(mixed_precision='bf16', tsa_iter=TSA_ITER):
            opt = parse_dict(json.loads(json.dumps(EDVR_M_MP_OPT)),
                             is_train=True, root=tmp)
            opt['train'].update(mixed_precision=mixed_precision,
                                tsa_iter=tsa_iter)
            opt['device'] = 'cuda'
            opt['path']['pretrain_network_g'] = ckpt
            return create_model(opt)

        model = mp_model()
        batches = train_batches(gen, TRAIN_STEPS, BATCH,
                                random.Random(SEED + 3))
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
                        f'mp TSA warm-up: frozen parameters moved '
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
                    raise AssertionError(f'mp: after tsa_iter parameters '
                                         f'did not move: {still[:3]}')
        mp_launches = dict(dcn.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if not all(np.isfinite(losses)):
            raise AssertionError(f'mp training losses not finite: {losses}')
        if any(c != launch_counts(dcn_fwd_bf16=4, dcn_bwd_bf16=4)
               for c in per_step):
            raise AssertionError(f'mp DCN launches per step: {per_step}')
        opt_state = model.optimizer_g.state
        not_f32 = [n for n, p in params.items()
                   if p.dtype != torch.float32 or p.grad.dtype != torch.float32
                   or opt_state[p]['exp_avg'].dtype != torch.float32
                   or opt_state[p]['exp_avg_sq'].dtype != torch.float32]
        if not_f32 or model.output.dtype != torch.float32:
            raise AssertionError(f'mp: not f32 master state: {not_f32[:3]}, '
                                 f'output {model.output.dtype}')
        timed = sorted(step_secs[3:])
        mp_step_ms = timed[len(timed) // 2] * 1e3
        # where the step's time goes: 3 more steps under the profiler
        mp_profile = profile_steps(
            lambda: (model.feed_data(batches[-1]),
                     model.optimize_parameters(TRAIN_STEPS + 1)), 3)
        mp_profile['busy_share_of_median_step'] = (
            mp_profile['kernel_ms_per_step'] / mp_step_ms)
        del model, params, before

        # the bf16 step against the fp32 step, from the golden weights and
        # one batch, two steps each, every parameter learning; the first
        # step's gradients kept
        one = batches[0]
        numel = one['gt'].numel()
        runs, grads = {}, {}
        for mp in ('bf16', None):
            m = mp_model(mp, tsa_iter=None)
            run_losses = []
            for it in (1, 2):
                m.feed_data(one)
                m.optimize_parameters(it)
                run_losses.append(float(m.log_dict['l_pix']))
                if it == 1:
                    grads[mp] = {n: p.grad.clone() for n, p in
                                 m.net_g.named_parameters()}
            runs[mp] = (run_losses, {n: p.detach().clone() for n, p in
                                     m.net_g.named_parameters()})
            del m
        # for scale, another batch's fp32 gradient: at the golden weights
        # on these synthetic clips it reads about as close as bf16's does
        m = mp_model(None, tsa_iter=None)
        m.feed_data(batches[1])
        m.optimize_parameters(1)
        other_batch = grad_gaps({n: p.grad for n, p in
                                 m.net_g.named_parameters()}, grads[None])
        del m
        grad_total, grad_cos = grad_gaps(grads['bf16'], grads[None])
        worst_g = min(grad_cos, key=grad_cos.get)
        negated = grad_gaps({n: -g for n, g in grads['bf16'].items()},
                            grads[None])[0]
        loss_gaps = [abs(a - b) / numel for a, b in zip(runs['bf16'][0],
                                                        runs[None][0])]
        param_gaps = {n: (p - runs[None][1][n]).abs().max().item()
                      for n, p in runs['bf16'][1].items()}
        worst_p = max(param_gaps, key=param_gaps.get)
        if not (grad_total <= MP_GRAD_TOL
                and grad_cos[worst_g] >= MP_LEAF_COS_MIN
                and max(loss_gaps) <= MP_LOSS_TOL
                and param_gaps[worst_p] <= MP_PARAM_TOL):
            raise AssertionError(
                f'bf16 vs fp32 step: gradient gap {grad_total} (tol '
                f'{MP_GRAD_TOL}), {worst_g} cosine {grad_cos[worst_g]} '
                f'(least {MP_LEAF_COS_MIN}); loss per element gaps '
                f'{loss_gaps} '
                f'(tol {MP_LOSS_TOL}), {worst_p} {param_gaps[worst_p]} '
                f'(tol {MP_PARAM_TOL})')
        ph.info.update(
            steps=TRAIN_STEPS, batch=BATCH, lq_crop=64, gt_crop=256,
            pcd_n=TRAIN_N, mixed_precision='bf16', cuts=MP_CUTS,
            losses=losses, dcn_launches=mp_launches,
            launches_per_step=per_step[0], ms_per_step_median=mp_step_ms,
            ms_per_step_all=[t * 1e3 for t in step_secs],
            peak_mem_bytes=peak, master_state='float32', profile=mp_profile,
            vs_fp32=dict(steps=2, tsa_iter=None,
                         grad_gap=grad_total, grad_tol=MP_GRAD_TOL,
                         grad_least_cosine=[worst_g, grad_cos[worst_g]],
                         grad_cosine_min=MP_LEAF_COS_MIN,
                         grad_gap_negated=negated,
                         grad_gap_other_batch=other_batch[0],
                         grad_least_cosine_other_batch=min(
                             other_batch[1].values()),
                         losses_bf16=runs['bf16'][0],
                         losses_fp32=runs[None][0],
                         loss_per_element_gaps=loss_gaps,
                         loss_tol=MP_LOSS_TOL,
                         param_worst=[worst_p, param_gaps[worst_p]],
                         param_tol=MP_PARAM_TOL),
            card=smi)
        del runs, grads

    from edvr_tpu_torch.ops import dcn_ablate
    from edvr_tpu_torch.tools import ablate_dcn

    ablate_results = {}
    with Phase('ablate_l1') as ph, torch.no_grad():
        checks = {}
        for dname in ('fp32', 'bf16'):
            args = ablate_dcn.make_inputs('l1', ablate_dcn.DTYPES[dname],
                                          SEED)
            for mode in dcn_ablate.MODES:
                got = dcn_ablate.ablate_cuda(mode, *args, None, 1, 1, 1, 8)
                want = dcn_ablate.ablate_plain(mode, *args, None, 1, 1, 1, 8)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                if not (got.dtype == want.dtype and err <= ABLATE_TOL[dname]):
                    raise AssertionError(f'ablate {mode} {dname}: rel err '
                                         f'{err} > {ABLATE_TOL[dname]}')
                plain_ms = cuda_ms(lambda: dcn_ablate.ablate_plain(
                    mode, *args, None, 1, 1, 1, 8), 3)
                checks[mode, dname] = dict(
                    rel_err=err,
                    max_abs_err=(got.float() - want.float()).abs().max()
                    .item(), plain_ms=plain_ms)
            del args, got, want
        # the tool's timing table: its launches are the path's
        dcn.LAUNCHES.update({k: 0 for k in dcn.LAUNCHES})
        table = {d: ablate_dcn.run(d, 'l1', SEED, 20) for d in ('fp32',
                                                                'bf16')}
        torch.cuda.synchronize()
        ablate_launches = dict(dcn.LAUNCHES)
        if ablate_launches != launch_counts(**{
                f'dcn_fwd_ablate_{m}_{d}': 21 for m in dcn_ablate.MODES
                for d in ('f32', 'bf16')}):
            raise AssertionError(f'ablation launches {ablate_launches}')
        for dname, rows in table.items():
            for row in rows:
                key = (row['variant'], dname)
                suffix = {'fp32': 'f32', 'bf16': 'bf16'}[dname]
                ablate_results[key] = dict(
                    row, **checks[key],
                    launches=ablate_launches[
                        f"dcn_fwd_ablate_{row['variant']}_{suffix}"])
                print(json.dumps(dict(ablate_results[key], card=smi)),
                      flush=True)
        print(json.dumps(ablate_dcn.NO_COUNTERPART), flush=True)
        ph.info.update(shape='l1', tol=ABLATE_TOL, card=smi,
                       ms={f'{m}_{d}': r['ms']
                           for (m, d), r in ablate_results.items()})

    # the EDVR-L phases in a child process under the test CLI's cuDNN
    # policy (edvr_tpu_torch.test.INFERENCE_CUDNN_ENV), which is read at a
    # process's first convolution; this process's phases keep the default
    with tempfile.TemporaryDirectory() as tmp:
        out_path = osp.join(tmp, 'edvr_l.json')
        child = subprocess.run([sys.executable, osp.abspath(__file__),
                                '--edvr-l', out_path], check=False)
        if child.returncode:
            raise AssertionError(f'the EDVR-L phases failed (exit '
                                 f'{child.returncode})')
        with open(out_path) as f:
            edvr_l = json.load(f)

    l1 = results['L1']
    kernel = {'name': 'dcn_fwd', 'route': 'cuda',
              'source': 'edvr_tpu_torch/csrc/dcn_fwd.cu',
              'replaces': 'edvr_tpu/ops/dcn_band.py:281',
              'replaces_function': 'edvr_tpu/ops/dcn_band.py::band_forward',
              'launches': launches['dcn_fwd'],
              'max_abs_err': max(r['max_abs_err'] for r in results.values()),
              'ms': l1['ms'], 'plain_ms': l1['plain_ms'],
              'bound_ms': l1['bound_ms'], 'bound_by': l1['bound_by'],
              'bound_ms_fp32_pipe': l1['bound_ms_fp32_pipe'],
              'library_ms': l1['library_ms'],
              'library': GEMM_ONLY}
    for level, r in results.items():
        kernel.update({f'ms_{level}': r['ms'],
                       f'plain_ms_{level}': r['plain_ms'],
                       f'bound_ms_{level}': r['bound_ms'],
                       f'bound_ms_fp32_pipe_{level}': r['bound_ms_fp32_pipe'],
                       f'library_ms_{level}': r['library_ms']})
    kernel['launches_train'] = train_launches['dcn_fwd']
    kernel['max_abs_err'] = max(kernel['max_abs_err'],
                                *(r['max_abs_err'] for r in fwd_train.values()))
    for level, r in fwd_train.items():
        kernel.update({f'ms_train_{level}': r['ms'],
                       f'plain_ms_train_{level}': r['plain_ms'],
                       f'bound_ms_train_{level}': r['bound_ms'],
                       f'bound_ms_fp32_pipe_train_{level}':
                           r['bound_ms_fp32_pipe']})
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
                  'bound_ms_fp32_pipe': b1['bound_ms_fp32_pipe'],
                  'library_ms': None}
    for level, r in bwd_results.items():
        kernel_bwd.update({f'ms_{level}': r['ms'],
                           f'plain_ms_{level}': r['plain_ms'],
                           f'bound_ms_{level}': r['bound_ms'],
                           f'bound_ms_fp32_pipe_{level}':
                               r['bound_ms_fp32_pipe']})
    bl1 = blend_results['L1']
    kernel_blend = {'name': 'blend_matmul', 'route': 'cuda',
                    'source': 'edvr_tpu_torch/csrc/blend_matmul.cu',
                    'replaces': 'edvr_tpu/ops/dcn_pallas.py:37',
                    'replaces_function':
                        'edvr_tpu/ops/dcn_pallas.py::blend_matmul_group',
                    'launches': packed_launches['blend_matmul'],
                    'max_abs_err': max(r['max_abs_err']
                                       for r in blend_results.values()),
                    'ms': bl1['ms'], 'plain_ms': bl1['plain_ms'],
                    'bound_ms': bl1['bound_ms'], 'bound_by': bl1['bound_by'],
                    'bound_ms_fp32_pipe': bl1['bound_ms_fp32_pipe'],
                    'library_ms': bl1['library_ms'],
                    'library': 'torch.addmm, the GEMM only',
                    'launches_train': packed_train_launches['blend_matmul']}
    for level, r in blend_results.items():
        kernel_blend.update({f'ms_{level}': r['ms'],
                             f'plain_ms_{level}': r['plain_ms'],
                             f'bound_ms_{level}': r['bound_ms'],
                             f'bound_ms_fp32_pipe_{level}':
                                 r['bound_ms_fp32_pipe'],
                             f'library_ms_{level}': r['library_ms']})
    gl1 = gather_results['L1']
    kernel_gather = {'name': 'row_gather', 'route': 'cuda',
                     'source': 'edvr_tpu_torch/csrc/row_gather.cu',
                     'replaces': 'scripts/dev/probe_mosaic_gather.py:92',
                     'replaces_function': 'the in-kernel row gather of '
                                          'scripts/dev/probe_mosaic_gather.py',
                     'launches': packed_launches['row_gather'],
                     'max_abs_err': max(r['max_abs_err']
                                        for r in gather_results.values()),
                     'ms': gl1['ms'], 'plain_ms': gl1['plain_ms'],
                     'bound_ms': gl1['bound_ms'],
                     'bound_by': gl1['bound_by'],
                     'library_ms': gl1['library_ms'],
                     'library': 'torch.index_select',
                     'launches_train': packed_train_launches['row_gather']}
    for tag, r in gather_results.items():
        if tag != 'L1':
            kernel_gather.update({f'ms_{tag}': r['ms'],
                                  f'bound_ms_{tag}': r['bound_ms'],
                                  f'library_ms_{tag}': r['library_ms']})
    kernel['launches_tapshared_train'] = tap_launches['dcn_fwd']
    kernel_bwd['launches_tapshared_train'] = tap_launches['dcn_bwd']
    # EDVR-L: the forward at c_per 16, cout 128 (L_<level>), and the
    # launches of each EDVR-L path's run
    kernel['max_abs_err'] = max(kernel['max_abs_err'], *(
        r['max_abs_err'] for r in edvr_l['kernel'].values()))
    for level, r in edvr_l['kernel'].items():
        kernel.update({f'{key}_L_{level}': r[key] for key in (
            'ms', 'plain_ms', 'bound_ms', 'bound_ms_fp32_pipe',
            'library_ms')})
    for path in ('edvr_l_main_path', 'edvr_l_pyramid', 'edvr_l_deblur',
                 'edvr_l_vimeo'):
        kernel[f'launches_{path}'] = edvr_l['launches'][path]
    packed_l = edvr_l['launches']['packed_edvr_l']
    for entry, name, results_l in (
            (kernel_blend, 'blend_matmul', edvr_l['blend']),
            (kernel_gather, 'row_gather', edvr_l['gather'])):
        entry['launches_packed_edvr_l'] = packed_l[name]
        entry['max_abs_err'] = max(entry['max_abs_err'], *(
            r['max_abs_err'] for r in results_l.values()))
        for level, r in results_l.items():
            entry.update({f'{key}_L_{level}': r[key] for key in (
                'ms', 'plain_ms', 'bound_ms', 'library_ms')})
    # the bf16 entries: their main path is the mixed-precision training
    # step (mp_train); ms at inference L1 (forward) and training L1
    # (backward), as the fp32 entries
    f1 = bf16_fwd['L1']
    kernel_fwd_bf16 = {
        'name': 'dcn_fwd_bf16', 'route': 'cuda',
        'source': 'edvr_tpu_torch/csrc/dcn_fwd.cu',
        'replaces': 'edvr_tpu/ops/dcn_band.py:281',
        'replaces_function': 'edvr_tpu/ops/dcn_band.py::band_forward (bf16)',
        'launches': mp_launches['dcn_fwd_bf16'],
        'max_abs_err': max(r['max_abs_err'] for r in bf16_fwd.values()),
        'ms': f1['ms'], 'plain_ms': f1['plain_ms'],
        'bound_ms': f1['bound_ms'], 'bound_by': f1['bound_by'],
        'bound_ms_fp32_pipe': f1['bound_ms_fp32_pipe'],
        'library_ms': f1['library_ms'], 'library': GEMM_ONLY}
    for level, r in bf16_fwd.items():
        kernel_fwd_bf16.update({f'ms_{level}': r['ms'],
                                f'fp32_ms_{level}': r['fp32_ms'],
                                f'plain_ms_{level}': r['plain_ms'],
                                f'bound_ms_{level}': r['bound_ms'],
                                f'bound_ms_fp32_pipe_{level}':
                                    r['bound_ms_fp32_pipe'],
                                f'library_ms_{level}': r['library_ms']})
    b1 = bf16_bwd['train_L1']
    kernel_bwd_bf16 = {
        'name': 'dcn_bwd_bf16', 'route': 'cuda',
        'source': 'edvr_tpu_torch/csrc/dcn_bwd.cu',
        'replaces': 'edvr_tpu/ops/dcn_band.py:608',
        'replaces_function':
            'edvr_tpu/ops/dcn_band.py::band_backward (bf16)',
        'launches': mp_launches['dcn_bwd_bf16'],
        'max_abs_err': max(r['max_abs_err'] for r in bf16_bwd.values()),
        'ms': b1['ms'], 'plain_ms': b1['plain_ms'],
        'bound_ms': b1['bound_ms'], 'bound_by': b1['bound_by'],
        'bound_ms_fp32_pipe': b1['bound_ms_fp32_pipe'],
        'library_ms': None}
    for level, r in bf16_bwd.items():
        kernel_bwd_bf16.update({f'ms_{level}': r['ms'],
                                f'fp32_ms_{level}': r['fp32_ms'],
                                f'plain_ms_{level}': r['plain_ms'],
                                f'bound_ms_{level}': r['bound_ms'],
                                f'bound_ms_fp32_pipe_{level}':
                                    r['bound_ms_fp32_pipe']})
    # the ablation variants: their main path is the timing tool's run
    kernels_ablate = [
        {'name': f'dcn_fwd_ablate_{mode}_{dname}', 'route': 'cuda',
         'source': 'edvr_tpu_torch/csrc/dcn_fwd.cu',
         'replaces': 'scripts/dev/ablate_band.py:196',
         'replaces_function': 'scripts/dev/ablate_band.py::build_variant',
         'launches': r['launches'], 'max_abs_err': r['max_abs_err'],
         'ms': r['ms'], 'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
         'bound_by': r['bound_by'], 'library_ms': None,
         'saved_ms': r['saved_ms'], 'shape': 'l1'}
        for (mode, dname), r in ablate_results.items()]
    print(json.dumps({'kernels': [kernel, kernel_bwd, kernel_blend,
                                  kernel_gather, kernel_fwd_bf16,
                                  kernel_bwd_bf16, *kernels_ablate]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def edvr_l_main(out_path):
    """The EDVR-L phases as the test CLI runs inference: its cuDNN policy
    applied before the first convolution, TF32 off; their readings written
    to ``out_path`` as JSON. The kernels are the parent's build."""
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this run '
              'needs a CUDA card', file=sys.stderr)
        return 1
    from edvr_tpu_torch.test import use_inference_cudnn_policy
    use_inference_cudnn_policy()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    state, config, _, _ = load_golden()
    out = edvr_l_phases(torch.Generator().manual_seed(SEED + 10), smi,
                        state, config)
    with open(out_path, 'w') as f:
        json.dump(out, f)
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--edvr-l']:
        sys.exit(edvr_l_main(sys.argv[2]))
    sys.exit(main())
