"""Frame-index and image-sequence helpers
(reference: basicsr/data/data_util.py), the counterparts of
``edvr_tpu/data/data_util.py``. Image sequences here are (t, c, h, w)
float32 RGB [0, 1] tensors, as in the reference; ``cv2`` is imported only
where images are read. DUF's Gaussian downsampling runs on the host in
numpy and scipy, as in the JAX package. The path helpers are the disk modes only: LMDB is
not ported (ROADMAP A.9).
"""

from __future__ import annotations

from os import path as osp

import numpy as np
import torch

from edvr_tpu_torch.data.transforms import mod_crop
from edvr_tpu_torch.utils import img2tensor, scandir


def read_img_seq(path, require_mod_crop=False, scale=1) -> torch.Tensor:
    """Read an image folder (or explicit path list) as a (t, c, h, w) RGB
    float32 tensor, each frame cut to multiples of ``scale`` with
    ``require_mod_crop`` (reference: data_util.py:11-32)."""
    import cv2
    frame_paths = path if isinstance(path, list) else sorted(
        scandir(path, full_path=True))
    frames = []
    for p in frame_paths:
        img = cv2.imread(p)
        if img is None:
            raise IOError(f'cannot read image {p}')
        img = img.astype(np.float32) / 255.
        frames.append(mod_crop(img, scale) if require_mod_crop else img)
    return torch.stack(img2tensor(frames, bgr2rgb=True), 0)


def generate_frame_indices(crt_idx: int, max_frame_num: int, num_frames: int,
                           padding: str = 'reflection'):
    """Temporal window indices around ``crt_idx`` with border padding
    (reference: data_util.py:35-88).

    Out-of-range positions are remapped per mode:
      * replicate:          ... 0 0 | 0 1 2 ... n | n n ...
      * reflection:         ... 2 1 | 0 1 2 ... n | n-1 n-2 ...
      * reflection_circle:  reflect about the window's own edge frames
      * circle:             wrap by the window length
    """
    if num_frames % 2 != 1:
        raise ValueError(f'window length must be odd, got {num_frames}')
    if padding not in ('replicate', 'reflection', 'reflection_circle',
                       'circle'):
        raise ValueError(f'unknown padding mode {padding!r}')
    last = max_frame_num - 1
    half = num_frames // 2

    def remap(i):
        if 0 <= i <= last:
            return i
        if padding == 'replicate':
            return min(max(i, 0), last)
        if padding == 'reflection':
            return -i if i < 0 else 2 * last - i
        if padding == 'reflection_circle':
            return (crt_idx + half - i if i < 0
                    else crt_idx - half - (i - last))
        return i + num_frames if i < 0 else i - num_frames  # circle

    return [remap(i) for i in range(crt_idx - half, crt_idx + half + 1)]


def _pair_of(folders, keys):
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError(
            f'need exactly (input, gt) folders and keys, got {len(folders)} '
            f'folders / {len(keys)} keys')
    return folders[0], folders[1], keys[0], keys[1]


def paired_paths_from_meta_info_file(folders, keys, meta_info_file,
                                     filename_tmpl):
    """Paired path dicts from a meta-info manifest of GT names
    (reference: data_util.py:158-206)."""
    in_dir, gt_dir, in_key, gt_key = _pair_of(folders, keys)
    with open(meta_info_file) as fh:
        gt_names = [line.split(' ')[0] for line in fh]
    out = []
    for gt_name in gt_names:
        stem, ext = osp.splitext(osp.basename(gt_name))
        out.append({f'{in_key}_path':
                    osp.join(in_dir, filename_tmpl.format(stem) + ext),
                    f'{gt_key}_path': osp.join(gt_dir, gt_name)})
    return out


def paired_paths_from_folder(folders, keys, filename_tmpl):
    """Paired path dicts by scanning two folders: each GT name's input is
    ``filename_tmpl`` of its stem with the same extension
    (reference: data_util.py:209-247)."""
    in_dir, gt_dir, in_key, gt_key = _pair_of(folders, keys)
    in_names = set(scandir(in_dir))
    gt_names = list(scandir(gt_dir))
    if len(in_names) != len(gt_names):
        raise ValueError(
            f'{in_key} folder has {len(in_names)} images but {gt_key} '
            f'folder has {len(gt_names)}')
    out = []
    for gt_name in gt_names:
        stem, ext = osp.splitext(osp.basename(gt_name))
        in_name = filename_tmpl.format(stem) + ext
        if in_name not in in_names:
            raise ValueError(
                f'{in_name} (paired with {gt_name}) missing from {in_dir}')
        out.append({f'{in_key}_path': osp.join(in_dir, in_name),
                    f'{gt_key}_path': osp.join(gt_dir, gt_name)})
    return out


def paths_from_folder(folder):
    """Every image path under ``folder`` (reference: data_util.py:250-262)."""
    return [osp.join(folder, p) for p in scandir(folder)]


def generate_gaussian_kernel(kernel_size=13, sigma=1.6) -> np.ndarray:
    """DUF's Gaussian kernel: a centred impulse through scipy's
    ``gaussian_filter`` (reference: data_util.py:270-285)."""
    from scipy.ndimage import gaussian_filter
    kernel = np.zeros((kernel_size, kernel_size))
    kernel[kernel_size // 2, kernel_size // 2] = 1
    return gaussian_filter(kernel, sigma)


def duf_downsample(x: torch.Tensor, kernel_size=13, scale=4) -> torch.Tensor:
    """The official DUF code's downsampling (reference:
    data_util.py:288-331; ``edvr_tpu/data/data_util.py:170-194``): reflect
    padding by ``kernel_size // 2 + 2 scale``, a ``kernel_size`` Gaussian
    of sigma 0.4 scale taken every ``scale`` pixels (each tap added in
    float32, in the JAX package's order), 2 pixels cropped from each side.

    Args:
        x: (t, c, h, w) or (b, t, c, h, w) frames.
    """
    if scale not in (2, 3, 4):
        raise ValueError(f'DUF downsampling supports scale 2/3/4, '
                         f'got {scale}')
    lead = x.shape[:-3]
    c, h, w = x.shape[-3:]
    pad = kernel_size // 2 + scale * 2
    xr = np.pad(x.reshape(-1, c, h, w).numpy(),
                ((0, 0), (0, 0), (pad, pad), (pad, pad)), 'reflect')
    kernel = generate_gaussian_kernel(kernel_size, 0.4 * scale)
    oh = (xr.shape[2] - kernel_size) // scale + 1
    ow = (xr.shape[3] - kernel_size) // scale + 1
    out = np.zeros((xr.shape[0], c, oh, ow), np.float32)
    for i in range(kernel_size):
        for j in range(kernel_size):
            out += kernel[i, j] * xr[:, :, i:i + oh * scale:scale,
                                     j:j + ow * scale:scale]
    out = out[:, :, 2:-2, 2:-2]
    return torch.from_numpy(np.ascontiguousarray(out)).reshape(
        *lead, c, oh - 4, ow - 4)
