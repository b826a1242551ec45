"""NIQE: Natural Image Quality Evaluator, the port's copy of
``edvr_tpu/metrics/niqe.py`` (reference: basicsr/metrics/niqe.py, which
matches the official MATLAB release): MSCN normalisation with a 7x7
Gaussian window, AGGD features over 96x96 blocks at 2 scales, and the
Mahalanobis-style distance against the pristine multivariate Gaussian. A
host metric in numpy and scipy, as in the JAX package. The pristine
model's statistics (``niqe_pris_params.npz``: mu, covariance, Gaussian
window; the official data parameters) lie beside this module, a byte-for-
byte copy of the JAX package's; ``cv2`` is imported where it is used.
"""

from __future__ import annotations

import math
import os.path as osp

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma

from edvr_tpu_torch.metrics.metric_util import reorder_image, to_y_channel
from edvr_tpu_torch.utils.registry import METRIC_REGISTRY

_PRIS_PATH = osp.join(osp.dirname(__file__), 'niqe_pris_params.npz')

# gamma-ratio lookup used by the AGGD moment-matching estimator
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.square(gamma(2.0 / _GAM)) / (gamma(1.0 / _GAM) *
                                         gamma(3.0 / _GAM))


def estimate_aggd_param(block: np.ndarray):
    """Moment-matching estimate of AGGD parameters (alpha, beta_l,
    beta_r) (reference: niqe.py:10-38)."""
    block = block.flatten()
    left_std = np.sqrt(np.mean(block[block < 0]**2))
    right_std = np.sqrt(np.mean(block[block > 0]**2))
    gammahat = left_std / right_std
    rhat = (np.mean(np.abs(block)))**2 / np.mean(block**2)
    rhatnorm = (rhat * (gammahat**3 + 1) *
                (gammahat + 1)) / ((gammahat**2 + 1)**2)
    alpha = _GAM[np.argmin((_R_GAM - rhatnorm)**2)]
    beta_l = left_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    beta_r = right_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    return alpha, beta_l, beta_r


def compute_feature(block: np.ndarray):
    """18 AGGD features per block: direct + 4 pairwise-product
    orientations (reference: niqe.py:41-65)."""
    feat = []
    alpha, beta_l, beta_r = estimate_aggd_param(block)
    feat.extend([alpha, (beta_l + beta_r) / 2])
    for shift in ([0, 1], [1, 0], [1, 1], [1, -1]):
        shifted = np.roll(block, shift, axis=(0, 1))
        alpha, beta_l, beta_r = estimate_aggd_param(block * shifted)
        mean = (beta_r - beta_l) * (gamma(2 / alpha) / gamma(1 / alpha))
        feat.extend([alpha, mean, beta_l, beta_r])
    return feat


def niqe(img, mu_pris_param, cov_pris_param, gaussian_window,
         block_size_h=96, block_size_w=96):
    """Core NIQE over a [0,255] gray/Y image (reference: niqe.py:68-156)."""
    if img.ndim != 2:
        raise ValueError(f'NIQE takes a 2-D image, got shape {img.shape}')
    h, w = img.shape
    num_block_h = math.floor(h / block_size_h)
    num_block_w = math.floor(w / block_size_w)
    img = img[0:num_block_h * block_size_h, 0:num_block_w * block_size_w]

    distparam = []
    for scale in (1, 2):
        mu = convolve(img, gaussian_window, mode='nearest')
        sigma = np.sqrt(np.abs(
            convolve(np.square(img), gaussian_window, mode='nearest') -
            np.square(mu)))
        img_normalized = (img - mu) / (sigma + 1)

        feat = []
        for idx_w in range(num_block_w):
            for idx_h in range(num_block_h):
                block = img_normalized[
                    idx_h * block_size_h // scale:
                    (idx_h + 1) * block_size_h // scale,
                    idx_w * block_size_w // scale:
                    (idx_w + 1) * block_size_w // scale]
                feat.append(compute_feature(block))
        distparam.append(np.array(feat))

        if scale == 1:
            # the reference downsamples with bilinear cv2.resize here
            # (niqe.py:131-137), noting it slightly deviates from MATLAB
            import cv2
            h2, w2 = img.shape
            img = cv2.resize(img / 255., (w2 // 2, h2 // 2),
                             interpolation=cv2.INTER_LINEAR) * 255.

    distparam = np.concatenate(distparam, axis=1)

    mu_distparam = np.nanmean(distparam, axis=0)
    distparam_no_nan = distparam[~np.isnan(distparam).any(axis=1)]
    cov_distparam = np.cov(distparam_no_nan, rowvar=False)

    invcov_param = np.linalg.pinv((cov_pris_param + cov_distparam) / 2)
    diff = mu_pris_param - mu_distparam
    return np.sqrt(diff @ invcov_param @ diff.T)


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border, input_order='HWC', convert_to='y',
                   **kwargs) -> float:
    """NIQE on a [0,255] BGR/gray image (reference: niqe.py:158-205)."""
    pris = np.load(_PRIS_PATH)
    mu_pris_param = pris['mu_pris_param']
    cov_pris_param = pris['cov_pris_param']
    gaussian_window = pris['gaussian_window']

    import cv2
    img = img.astype(np.float32)
    if input_order != 'HW':
        img = reorder_image(img, input_order=input_order)
        if convert_to == 'y':
            img = to_y_channel(img)
        elif convert_to == 'gray':
            img = cv2.cvtColor(img / 255., cv2.COLOR_BGR2GRAY) * 255.
        img = np.squeeze(img)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]

    return float(np.squeeze(
        niqe(img, mu_pris_param, cov_pris_param, gaussian_window)))
