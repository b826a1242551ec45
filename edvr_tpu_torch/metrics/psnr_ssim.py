"""PSNR and SSIM on uint8-domain [0, 255] images, float64 internally
(reference: basicsr/metrics/psnr_ssim.py), the counterparts of
``edvr_tpu/metrics/psnr_ssim.py``. SSIM uses the official MATLAB code's
11x11 Gaussian window (sigma 1.5) over the valid region; ``cv2`` is
imported only inside it."""

from __future__ import annotations

import numpy as np

from edvr_tpu_torch.metrics.metric_util import reorder_image, to_y_channel
from edvr_tpu_torch.utils.registry import METRIC_REGISTRY


def _prepare(img1, img2, crop_border, input_order, test_y_channel):
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
    return img1, img2


@METRIC_REGISTRY.register()
def calculate_psnr(img1, img2, crop_border, input_order='HWC',
                   test_y_channel=False, **kwargs) -> float:
    """(reference: psnr_ssim.py:7-51)"""
    img1, img2 = _prepare(img1, img2, crop_border, input_order,
                          test_y_channel)
    mse = np.mean((img1 - img2)**2)
    if mse == 0:
        return float('inf')
    return 20. * np.log10(255. / np.sqrt(mse))


def _ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """One channel's SSIM, valid region only (reference:
    psnr_ssim.py:54-87)."""
    import cv2
    c1 = (0.01 * 255)**2
    c2 = (0.03 * 255)**2
    kernel = cv2.getGaussianKernel(11, 1.5)
    window = np.outer(kernel, kernel.transpose())

    def filt(img):
        return cv2.filter2D(img, -1, window)[5:-5, 5:-5]

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = filt(img1**2) - mu1_sq
    sigma2_sq = filt(img2**2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()


@METRIC_REGISTRY.register()
def calculate_ssim(img1, img2, crop_border, input_order='HWC',
                   test_y_channel=False, **kwargs) -> float:
    """SSIM averaged over the channels (reference: psnr_ssim.py:90-141)."""
    img1, img2 = _prepare(img1, img2, crop_border, input_order,
                          test_y_channel)
    return float(np.mean([_ssim(img1[..., i], img2[..., i])
                          for i in range(img1.shape[2])]))
