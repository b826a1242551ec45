"""Image <-> tensor conversions and image writing
(reference: basicsr/utils/img_util.py).

Network tensors are float32 NCHW RGB in [0, 1]; disk images are
cv2-convention BGR uint8. The uint8 rounding in ``tensor2img``
(img_util.py:93) is what the published PSNR numbers are measured through,
so it is kept exactly. ``cv2`` is imported only where an image file is
read or written.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch


def img2tensor(imgs, bgr2rgb: bool = True):
    """HWC BGR numpy image(s) -> CHW RGB float32 tensor(s)."""

    def _totensor(img):
        if img.ndim == 3 and img.shape[2] == 3 and bgr2rgb:
            img = img[..., ::-1]
        return torch.from_numpy(
            np.ascontiguousarray(img.transpose(2, 0, 1))).float()

    if isinstance(imgs, list):
        return [_totensor(img) for img in imgs]
    return _totensor(imgs)


def imfrombytes(content: bytes, flag: str = 'color',
                float32: bool = False) -> np.ndarray:
    """Decode an image from bytes, BGR like cv2
    (reference: basicsr/utils/img_util.py:101-123)."""
    import cv2
    flags = {'color': cv2.IMREAD_COLOR, 'grayscale': cv2.IMREAD_GRAYSCALE,
             'unchanged': cv2.IMREAD_UNCHANGED}
    img = cv2.imdecode(np.frombuffer(content, np.uint8), flags[flag])
    if float32:
        img = img.astype(np.float32) / 255.
    return img


def tensor2img(tensor, rgb2bgr: bool = True, out_type=np.uint8,
               min_max=(0, 1)):
    """Network tensor(s) -> HWC BGR numpy image(s).

    Accepts (h, w), (c, h, w) or (b, c, h, w) tensors, or a list of them; a
    batch of more than one image is tiled into one grid of
    ``int(sqrt(b))`` images a row, 2 px of zeros around each (the JAX
    package's ``_make_grid``, torchvision's ``make_grid`` as the reference
    calls it, img_util.py:57-62). Values are clamped to ``min_max``,
    normalised to [0, 1], flipped to BGR and, for uint8, multiplied by 255
    and rounded (not truncated).
    """
    if not isinstance(tensor, list):
        tensor = [tensor]
    result = []
    for _t in tensor:
        t = torch.as_tensor(_t).detach().float().cpu()
        if t.dim() == 4 and t.shape[0] == 1:
            t = t[0]
        t = t.clamp(*min_max)
        t = (t - min_max[0]) / (min_max[1] - min_max[0])
        img_np = t.numpy()
        if img_np.ndim == 4:
            img_np = _make_grid(img_np.transpose(0, 2, 3, 1),
                                nrow=int(math.sqrt(img_np.shape[0])))
        elif img_np.ndim == 3:
            img_np = img_np.transpose(1, 2, 0)
        elif img_np.ndim != 2:
            raise TypeError(f'Only support 2D, 3D and 4D tensor, got '
                            f'{img_np.ndim}D')
        if img_np.ndim == 3:
            if img_np.shape[2] == 1:
                img_np = img_np[:, :, 0]
            elif rgb2bgr:
                img_np = img_np[..., ::-1]
        if out_type == np.uint8:
            img_np = (img_np * 255.0).round()
        result.append(np.ascontiguousarray(img_np.astype(out_type)))
    return result[0] if len(result) == 1 else result


def _make_grid(imgs: np.ndarray, nrow: int, padding: int = 2) -> np.ndarray:
    """Tile a (b, h, w, c) batch into one image, ``nrow`` images a row,
    ``padding`` px of zeros around each (a copy of
    ``edvr_tpu/utils/img_util.py::_make_grid``)."""
    b, h, w, c = imgs.shape
    nrow = max(nrow, 1)
    ncol = int(math.ceil(b / nrow))
    grid = np.zeros((ncol * (h + padding) + padding,
                     nrow * (w + padding) + padding, c), dtype=imgs.dtype)
    for idx in range(b):
        r, col = divmod(idx, nrow)
        y0 = r * (h + padding) + padding
        x0 = col * (w + padding) + padding
        grid[y0:y0 + h, x0:x0 + w] = imgs[idx]
    return grid


def imwrite(img: np.ndarray, file_path: str, params=None,
            auto_mkdir: bool = True) -> bool:
    """Write a BGR image to disk, creating parent dirs
    (reference: basicsr/utils/img_util.py:126-142)."""
    import cv2
    if auto_mkdir:
        os.makedirs(os.path.abspath(os.path.dirname(file_path)),
                    exist_ok=True)
    ok = cv2.imwrite(file_path, img, params or [])
    if not ok:
        raise IOError(f'Failed in writing image {file_path}')
    return ok
