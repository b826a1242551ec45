"""Optical-flow file IO and uint8 (de)quantization, the port's copy of
``edvr_tpu/utils/flow_util.py`` (reference: basicsr/utils/flow_util.py).

Two on-disk forms:

* Middlebury ``.flo``: 4-byte ``PIEH`` tag, two int32 dims (width then
  height), then h*w*2 float32 (u, v) samples.
* quantized dual-channel images: u and v normalized by the image
  width/height, clipped to ``[-max_val, max_val]``, floor-quantized to
  256 uint8 levels, and stacked along ``concat_axis`` into one
  single-channel image (the REDS flow branch stores these as PNGs).

The quantization grid is the reference's: level k covers
``[min + k*step, min + (k+1)*step)`` and dequantizes to the bin center
``min + (k + 0.5)*step``.
"""

from __future__ import annotations

import os

import numpy as np

_FLO_TAG = b'PIEH'


def _check_bins(min_val, max_val, levels):
    """Validate a quantization grid specification."""
    if not isinstance(levels, int) or levels < 2:
        raise ValueError(f'need an integer level count >= 2, got {levels}')
    if not max_val > min_val:
        raise ValueError(
            f'empty quantization range [{min_val}, {max_val}]')


def quantize(arr, min_val, max_val, levels, dtype=np.int64):
    """Floor-quantize ``arr`` into ``levels`` bins over [min, max].

    Values at/above ``max_val`` land in the last bin (levels - 1). The
    arithmetic order (scale by levels, divide by the range, floor)
    matches the files the reference toolbox produces bit-for-bit.
    """
    _check_bins(min_val, max_val, levels)
    shifted = np.clip(arr, min_val, max_val) - min_val
    bins = np.floor(levels * shifted / (max_val - min_val)).astype(dtype)
    return np.minimum(bins, levels - 1)


def dequantize(arr, min_val, max_val, levels, dtype=np.float64):
    """Map bin indices back to bin-center values."""
    _check_bins(min_val, max_val, levels)
    return (arr + 0.5).astype(dtype) * (max_val - min_val) / levels + min_val


def quantize_flow(flow: np.ndarray, max_val: float = 0.02,
                  norm: bool = True):
    """Split an (h, w, 2) flow into uint8-quantized (dx, dy) planes.

    With ``norm`` the components are first divided by the image width
    (u) / height (v), so ``max_val`` is a fraction of the image size.
    """
    h, w = flow.shape[:2]
    scale = (w, h) if norm else (1, 1)
    return tuple(
        quantize(flow[..., i] / scale[i], -max_val, max_val, 255, np.uint8)
        for i in range(2))


def dequantize_flow(dx: np.ndarray, dy: np.ndarray, max_val: float = 0.02,
                    denorm: bool = True) -> np.ndarray:
    """Inverse of :func:`quantize_flow`; returns (h, w, 2) float."""
    if dx.shape != dy.shape:
        raise ValueError(f'dx/dy shape mismatch: {dx.shape} vs {dy.shape}')
    if dx.ndim == 3 and dx.shape[-1] != 1:
        raise ValueError(f'flow planes must be single-channel, got {dx.shape}')
    if dx.ndim not in (2, 3):
        raise ValueError(f'flow planes must be 2-D images, got {dx.ndim}-D')
    dx = dequantize(dx, -max_val, max_val, 255)
    dy = dequantize(dy, -max_val, max_val, 255)
    if denorm:
        h, w = dx.shape[:2]
        dx *= w
        dy *= h
    return np.dstack((dx, dy))


def flowread(flow_path: str, quantize: bool = False, concat_axis: int = 0,
             *, max_val: float = 0.02, denorm: bool = True) -> np.ndarray:
    """Load a flow field from ``.flo`` or quantized-image form."""
    if quantize:
        import cv2
        packed = cv2.imread(flow_path, cv2.IMREAD_UNCHANGED)
        if packed.ndim != 2:
            raise IOError(
                f'quantized flow {flow_path}: expected a single-channel '
                f'image, got {packed.ndim} dims')
        if packed.shape[concat_axis] % 2:
            raise IOError(
                f'quantized flow {flow_path}: axis {concat_axis} length '
                f'{packed.shape[concat_axis]} cannot split into dx/dy')
        dx, dy = np.split(packed, 2, axis=concat_axis)
        return dequantize_flow(dx, dy, max_val=max_val, denorm=denorm)

    with open(flow_path, 'rb') as f:
        tag = f.read(4)
        if tag != _FLO_TAG:
            raise IOError(
                f'{flow_path} is not a .flo file (tag {tag!r}, '
                f'want {_FLO_TAG!r})')
        w, h = np.fromfile(f, np.int32, 2)
        data = np.fromfile(f, np.float32, int(w) * int(h) * 2)
    return data.reshape(int(h), int(w), 2).astype(np.float32)


def flowwrite(flow: np.ndarray, filename: str, quantize: bool = False,
              concat_axis: int = 0, **kwargs) -> None:
    """Save a flow field in ``.flo`` or quantized-image form."""
    if quantize:
        import cv2
        dx, dy = quantize_flow(flow, **kwargs)
        os.makedirs(os.path.dirname(os.path.abspath(filename)),
                    exist_ok=True)
        cv2.imwrite(filename, np.concatenate((dx, dy), axis=concat_axis))
        return
    with open(filename, 'wb') as f:
        f.write(_FLO_TAG)
        np.asarray([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)
