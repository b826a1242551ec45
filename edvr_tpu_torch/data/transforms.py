"""Host-side image transforms of the training pipeline
(reference: basicsr/data/transforms.py), the counterparts of
``edvr_tpu/data/transforms.py``. Images are HWC numpy arrays.

Every random draw comes from the ``random.Random`` the caller passes, in
the order in which the JAX functions draw from the global ``random``
module, so that the two give the same items from the same seed.
"""

from __future__ import annotations

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """Trim the bottom/right edge so H and W divide ``scale``
    (reference: transforms.py:5-22)."""
    if img.ndim not in (2, 3):
        raise ValueError(f'mod_crop expects an HxW or HxWxC array, got '
                         f'ndim={img.ndim}.')
    h, w = img.shape[:2]
    return img[:h - h % scale, :w - w % scale, ...].copy()


def paired_random_crop(img_gts, img_lqs, gt_patch_size: int, scale: int,
                       rng, gt_path: str = ''):
    """Crop the same (scaled) patch from every LQ and GT frame: one
    top-left drawn in LQ coordinates for all frames, the GT crop at the
    same place times ``scale`` (reference: transforms.py:25-84). Single
    arrays in, single arrays out; lists in, lists out."""
    gts = img_gts if isinstance(img_gts, list) else [img_gts]
    lqs = img_lqs if isinstance(img_lqs, list) else [img_lqs]
    lq_h, lq_w = lqs[0].shape[:2]
    gt_h, gt_w = gts[0].shape[:2]
    lq_patch = gt_patch_size // scale
    if (gt_h, gt_w) != (lq_h * scale, lq_w * scale):
        raise ValueError(
            f'GT size ({gt_h}, {gt_w}) is not LQ size ({lq_h}, {lq_w}) '
            f'times the scale {scale}.')
    if lq_h < lq_patch or lq_w < lq_patch:
        raise ValueError(
            f'LQ frame ({lq_h}, {lq_w}) cannot fit a {lq_patch}x'
            f'{lq_patch} patch (GT patch {gt_patch_size}, scale {scale}); '
            f'offending sample: {gt_path}.')
    y0 = rng.randint(0, lq_h - lq_patch)
    x0 = rng.randint(0, lq_w - lq_patch)
    lqs = [f[y0:y0 + lq_patch, x0:x0 + lq_patch, ...] for f in lqs]
    ys, xs = y0 * scale, x0 * scale
    gts = [f[ys:ys + gt_patch_size, xs:xs + gt_patch_size, ...] for f in gts]
    return (gts[0] if len(gts) == 1 else gts,
            lqs[0] if len(lqs) == 1 else lqs)


def augment(imgs, rng, hflip=True, rotation=True, flows=None,
            return_status=False):
    """Random horizontal flip, vertical flip and 90-degree transpose, one
    draw shared by every frame and optical flow (reference:
    transforms.py:87-151). A flow's components follow the geometry: a
    horizontal flip negates u, a vertical flip v, the transpose swaps
    them. With ``flows`` returns (images, flows)."""
    do_hflip = hflip and rng.random() < 0.5
    do_vflip = rotation and rng.random() < 0.5
    do_rot90 = rotation and rng.random() < 0.5

    def apply(img):
        if do_hflip:
            img = img[:, ::-1, ...]
        if do_vflip:
            img = img[::-1, :, ...]
        if do_rot90:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    def apply_flow(flow):
        out = flow.copy()
        if do_hflip:
            out = out[:, ::-1, :]
            out[:, :, 0] = -out[:, :, 0]
        if do_vflip:
            out = out[::-1, :, :]
            out[:, :, 1] = -out[:, :, 1]
        if do_rot90:
            out = out.transpose(1, 0, 2)[:, :, [1, 0]]
        return np.ascontiguousarray(out)

    def each(fn, items):
        single = not isinstance(items, list)
        out = [fn(v) for v in ([items] if single else items)]
        return out[0] if len(out) == 1 else out

    result = each(apply, imgs)
    if flows is not None:
        return result, each(apply_flow, flows)
    if return_status:
        return result, (do_hflip, do_vflip, do_rot90)
    return result


def img_rotate(img, angle, center=None, scale=1.0):
    """Rotate ``angle`` degrees counter-clockwise about ``center`` (the
    image centre by default; reference: transforms.py:154-172)."""
    import cv2
    h, w = img.shape[:2]
    matrix = cv2.getRotationMatrix2D(center or (w // 2, h // 2), angle,
                                     scale)
    return cv2.warpAffine(img, matrix, (w, h))
