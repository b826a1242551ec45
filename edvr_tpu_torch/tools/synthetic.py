"""Seeded synthetic data for the port's tools and ``chip_smoke.py``: smooth
moving clips, 8-bit PNG frames, a REDS-layout tree of them, and paired
LQ/GT images at any scale."""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch
import torch.nn.functional as F

TRAIN_GT = 256       # GT frame side of the training clip (gt_size 256)
VAL_LQ = (180, 320)  # REDS4's LQ frame size
VAL_FRAMES = 5


def seeded_clip(T, h, w, gen):
    """A moving, smooth seeded GT clip (T, 3, 4h, 4w) and its 4x
    box-downsampled LQ clip (T, 3, h, w), both in [0, 1]."""
    field = torch.rand(1, 3, h // 8 + T, w // 8 + T, generator=gen)
    field = F.interpolate(field, scale_factor=32, mode='bicubic',
                          align_corners=False).clamp(0, 1)
    gt = torch.cat([field[:, :, 4 * t:4 * t + 4 * h, 4 * t:4 * t + 4 * w]
                    for t in range(T)])
    return F.avg_pool2d(gt, 4).contiguous(), gt.contiguous()


def write_png(path, frame):
    """A (3, h, w) RGB frame in [0, 1] as an 8-bit BGR PNG."""
    import cv2
    img = (frame.permute(1, 2, 0).numpy()[:, :, ::-1] * 255.).round()
    os.makedirs(osp.dirname(path), exist_ok=True)
    if not cv2.imwrite(path, img.astype(np.uint8)):
        raise IOError(f'cannot write {path}')


def write_reds_tree(root, seed=0, val_frames=VAL_FRAMES, val_lq=VAL_LQ):
    """A seeded REDS-layout tree under ``root``: ``train/{gt,lq}/001`` (100
    frames, GT TRAIN_GT square), ``val/{gt,lq}/000`` (``val_frames``
    frames of LQ ``val_lq``) and ``meta_info.txt``. Returns ``root``."""
    gen = torch.Generator().manual_seed(seed)
    for part, clip, T, (h, w) in (
            ('train', '001', 100, (TRAIN_GT // 4, TRAIN_GT // 4)),
            ('val', '000', val_frames, val_lq)):
        lq, gt = seeded_clip(T, h, w, gen)
        for sub, frames in (('lq', lq), ('gt', gt)):
            for i, frame in enumerate(frames):
                write_png(osp.join(root, part, sub, clip, f'{i:08d}.png'),
                          frame)
    with open(osp.join(root, 'meta_info.txt'), 'w') as f:
        f.write(f'001 100 ({TRAIN_GT},{TRAIN_GT},3)\n')
    return root


def seeded_image_pair(h, w, scale, gen):
    """A smooth seeded GT image (3, scale h, scale w) and its box-downsampled
    LQ image (3, h, w), both in [0, 1]."""
    field = torch.rand(1, 3, h * scale // 32 + 2, w * scale // 32 + 2,
                       generator=gen)
    gt = F.interpolate(field, scale_factor=32, mode='bicubic',
                       align_corners=False).clamp(0, 1)
    gt = gt[:, :, :h * scale, :w * scale]
    return F.avg_pool2d(gt, scale)[0].contiguous(), gt[0].contiguous()


def write_image_pairs(root, n, lq_hw, scale, seed=0):
    """``n`` seeded pairs as ``root/{gt,lq}/<i>.png`` (the same names, as
    a PairedImageDataset's ``filename_tmpl: '{}'`` pairs them; DIV2K's
    validation names from 0801). Returns ``root``."""
    gen = torch.Generator().manual_seed(seed)
    for i in range(n):
        lq, gt = seeded_image_pair(*lq_hw, scale, gen)
        for sub, img in (('lq', lq), ('gt', gt)):
            write_png(osp.join(root, sub, f'{801 + i:04d}.png'), img)
    return root


def write_ffhq_tree(root, n, size=256, seed=0):
    """``n`` seeded smooth RGB images of ``size`` x ``size`` as FFHQ's
    ``root/<i:08d>.png`` (the first ``n`` of the 70,000 names
    ``FFHQDataset`` lists). Returns ``root``."""
    gen = torch.Generator().manual_seed(seed)
    for i in range(n):
        _, img = seeded_image_pair(size // 4, size // 4, 4, gen)
        write_png(osp.join(root, f'{i:08d}.png'), img)
    return root
