"""Metric input conditioning (reference: basicsr/metrics/metric_util.py),
copied from ``edvr_tpu/metrics/metric_util.py``, with the MATLAB BGR->Y
transform of ``utils/matlab_functions.py``.
"""

from __future__ import annotations

import numpy as np

from edvr_tpu_torch.utils.matlab_functions import bgr2ycbcr

_ORDERS = {'HWC': (0, 1, 2), 'CHW': (1, 2, 0)}


def reorder_image(img: np.ndarray, input_order: str = 'HWC') -> np.ndarray:
    """Return ``img`` as HWC, growing a channel axis for 2-D inputs."""
    perm = _ORDERS.get(input_order)
    if perm is None:
        raise ValueError(
            f'unknown input_order {input_order!r}; use one of '
            f'{sorted(_ORDERS)}')
    if img.ndim == 2:
        return img[..., None]
    return img.transpose(perm)


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """BGR image on the [0, 255] scale -> (h, w, 1) luma on that scale,
    without intermediate rounding."""
    img = img.astype(np.float32) / 255.
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)[..., None]
    return img * 255.
