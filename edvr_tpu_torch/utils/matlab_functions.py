"""MATLAB-equivalent image functions (bicubic ``imresize`` with
antialiasing, BT.601 YCbCr), the port's copy of
``edvr_tpu/utils/matlab_functions.py:18-219`` (reference:
basicsr/utils/matlab_functions.py:88-361). Host numpy on HWC images, as in
the JAX package: per-axis weight and index tables applied with one gather
and a weighted sum per axis; the metrics' Y channel and the synthetic
Vid4 inputs (``BIx4``) depend on them.
"""

from __future__ import annotations

import math

import numpy as np


def cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB bicubic kernel (a = -0.5)."""
    absx = np.abs(x)
    absx2 = absx * absx
    absx3 = absx2 * absx
    f1 = 1.5 * absx3 - 2.5 * absx2 + 1
    f2 = -0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2
    return f1 * (absx <= 1) + f2 * ((absx > 1) & (absx <= 2))


def _weights_indices(in_length: int, out_length: int, scale: float,
                     kernel_width: float, antialiasing: bool):
    """Per-output-pixel contribution weights and (padded-space) indices.

    Matches MATLAB's contribution computation: half-pixel-centered
    inverse mapping, kernel widened by 1/scale when antialiasing a
    downscale, rows normalized to sum 1, all-zero boundary columns
    trimmed, and indices shifted into symmetric-padded coordinates
    (reference: basicsr/utils/matlab_functions.py:17-84).

    Returns:
        (weights (out, p), indices (out, p) into the padded axis,
         pad_start, pad_end)
    """
    if (scale < 1) and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    distance = u[:, None] - indices
    if (scale < 1) and antialiasing:
        weights = scale * cubic(distance * scale)
    else:
        weights = cubic(distance)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # trim boundary columns that are zero everywhere
    zero_cols = (weights == 0).sum(axis=0)
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        indices = indices[:, 1:p - 1]
        weights = weights[:, 1:p - 1]
    if not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        indices = indices[:, 0:p - 2]
        weights = weights[:, 0:p - 2]

    pad_start = int(-indices.min() + 1)
    pad_end = int(indices.max() - in_length)
    indices = (indices + pad_start - 1).astype(np.int64)
    return weights.astype(np.float32), indices, pad_start, pad_end


def _sym_pad(img: np.ndarray, axis: int, pad_start: int,
             pad_end: int) -> np.ndarray:
    """MATLAB 'symmetric' padding along one axis (the edge pixel is
    repeated)."""
    length = img.shape[axis]

    def take(idx):
        return np.take(img, idx, axis=axis)

    parts = []
    if pad_start > 0:
        parts.append(take(np.arange(pad_start - 1, -1, -1)))
    parts.append(img)
    if pad_end > 0:
        parts.append(take(np.arange(length - 1, length - pad_end - 1, -1)))
    return np.concatenate(parts, axis=axis) if len(parts) > 1 else img


def _resize_along_axis(img: np.ndarray, axis: int, weights: np.ndarray,
                       indices: np.ndarray, pad_start: int,
                       pad_end: int) -> np.ndarray:
    img = _sym_pad(img, axis, pad_start, pad_end)
    # gather windows: out shape (..., out_length, p, ...) then contract p
    gathered = np.take(img, indices, axis=axis)  # axis -> (out, p)
    # move the p dim next to multiply with weights
    gathered = np.moveaxis(gathered, axis + 1, -1)  # (..., out, ..., p)
    w = weights  # (out, p)
    # broadcast weights across the other dims:
    shape = [1] * gathered.ndim
    shape[axis] = w.shape[0]
    shape[-1] = w.shape[1]
    out = (gathered * w.reshape(shape)).sum(axis=-1, dtype=np.float32)
    return out


def imresize(img: np.ndarray, scale: float,
             antialiasing: bool = True) -> np.ndarray:
    """Bicubic resize identical to MATLAB ``imresize``.

    Args:
        img: (h, w, c) or (h, w) float array, [0, 1] range (any float
            range works; no clipping or rounding is applied).
        scale: same scale for both axes.
        antialiasing: widen the kernel when downscaling. Default True.

    Returns:
        (out_h, out_w[, c]) float32 array, without rounding.
    """
    squeeze = False
    if img.ndim == 2:
        img = img[:, :, None]
        squeeze = True
    in_h, in_w = img.shape[:2]
    out_h = int(math.ceil(in_h * scale))
    out_w = int(math.ceil(in_w * scale))
    kernel_width = 4.0

    w_h, idx_h, ps_h, pe_h = _weights_indices(in_h, out_h, scale,
                                              kernel_width, antialiasing)
    w_w, idx_w, ps_w, pe_w = _weights_indices(in_w, out_w, scale,
                                              kernel_width, antialiasing)
    out = img.astype(np.float32)
    out = _resize_along_axis(out, 0, w_h, idx_h, ps_h, pe_h)
    out = _resize_along_axis(out, 1, w_w, idx_w, ps_w, pe_w)
    if squeeze:
        out = out[:, :, 0]
    return out


# ---------------------------------------------------------------------------
# Color-space conversions (ITU-R BT.601, MATLAB-compatible)
# (reference: basicsr/utils/matlab_functions.py:173-302)
# ---------------------------------------------------------------------------

def _convert_input_type_range(img: np.ndarray) -> np.ndarray:
    img_type = img.dtype
    img = img.astype(np.float32)
    if img_type == np.float32:
        pass
    elif img_type == np.uint8:
        img /= 255.
    else:
        raise TypeError('The img type should be np.float32 or np.uint8, '
                        f'but got {img_type}')
    return img


def _convert_output_type_range(img: np.ndarray, dst_type) -> np.ndarray:
    if dst_type not in (np.uint8, np.float32):
        raise TypeError('The dst_type should be np.float32 or np.uint8, '
                        f'but got {dst_type}')
    if dst_type == np.uint8:
        img = img.round()
    else:
        img /= 255.
    return img.astype(dst_type)


_RGB2YCBCR = np.array([[65.481, -37.797, 112.0],
                       [128.553, -74.203, -93.786],
                       [24.966, 112.0, -18.214]])
_YCBCR_BIAS = np.array([16., 128., 128.])


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """MATLAB-compatible RGB -> YCbCr (BT.601, studio swing)."""
    img_type = img.dtype
    img = _convert_input_type_range(img)
    if y_only:
        out = img @ _RGB2YCBCR[:, 0] + 16.0
    else:
        out = img @ _RGB2YCBCR + _YCBCR_BIAS
    return _convert_output_type_range(out, img_type)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """MATLAB-compatible BGR -> YCbCr (channel-flipped rgb2ycbcr)."""
    img_type = img.dtype
    img = _convert_input_type_range(img)
    m = _RGB2YCBCR[::-1]
    if y_only:
        out = img @ m[:, 0] + 16.0
    else:
        out = img @ m + _YCBCR_BIAS
    return _convert_output_type_range(out, img_type)


_YCBCR2RGB = np.array([[0.00456621, 0.00456621, 0.00456621],
                       [0, -0.00153632, 0.00791071],
                       [0.00625893, -0.00318811, 0]])


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB-compatible YCbCr -> RGB."""
    img_type = img.dtype
    img = _convert_input_type_range(img) * 255
    out = img @ _YCBCR2RGB * 255.0 + [-222.921, 135.576, -276.836]
    return _convert_output_type_range(out, img_type)


def ycbcr2bgr(img: np.ndarray) -> np.ndarray:
    """MATLAB-compatible YCbCr -> BGR."""
    img_type = img.dtype
    img = _convert_input_type_range(img) * 255
    m = _YCBCR2RGB[:, ::-1]
    out = img @ m * 255.0 + [-276.836, 135.576, -222.921]
    return _convert_output_type_range(out, img_type)
