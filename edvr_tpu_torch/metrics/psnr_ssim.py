"""PSNR on uint8-domain [0, 255] images, float64 internally
(reference: basicsr/metrics/psnr_ssim.py:7-51). SSIM needs ``cv2``
filters and is not ported yet."""

from __future__ import annotations

import numpy as np

from edvr_tpu_torch.metrics.metric_util import reorder_image, to_y_channel
from edvr_tpu_torch.utils.registry import METRIC_REGISTRY


@METRIC_REGISTRY.register()
def calculate_psnr(img1, img2, crop_border, input_order='HWC',
                   test_y_channel=False, **kwargs) -> float:
    if img1.shape != img2.shape:
        raise ValueError(
            f'Image shapes are different: {img1.shape}, {img2.shape}.')
    img1 = reorder_image(img1, input_order=input_order).astype(np.float64)
    img2 = reorder_image(img2, input_order=input_order).astype(np.float64)
    if crop_border != 0:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img1 = to_y_channel(img1)
        img2 = to_y_channel(img2)
    mse = np.mean((img1 - img2)**2)
    if mse == 0:
        return float('inf')
    return 20. * np.log10(255. / np.sqrt(mse))
