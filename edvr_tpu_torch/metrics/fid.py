"""FID, the Frechet Inception Distance (reference: basicsr/metrics/fid.py),
the counterpart of ``edvr_tpu/metrics/fid.py``: ``calculate_fid`` is the
Frechet distance between two Gaussians on the host (numpy and scipy's
``sqrtm``); the features are the FID InceptionV3's pool3 outputs
(``archs/inception.py``) on the device.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import linalg


def load_patched_inception_v3(weights_path=None, device='cuda'):
    """The FID InceptionV3 (pool3) network on ``device``, mapping (n, 3, h,
    w) RGB images in [0, 1] to (n, 2048) features; ``weights_path`` a
    ``pt_inception-2015-12-05`` ``.pth`` (not in the repository)."""
    from edvr_tpu_torch.archs.inception import load_fid_inception
    return load_fid_inception(weights_path, device)


def extract_inception_features(data_generator, inception):
    """The features of every NCHW batch of ``data_generator`` (moved to the
    network's device) as one (n, 2048) float64 numpy array (reference:
    fid.py:28-55)."""
    device = next(inception.parameters()).device
    features = []
    with torch.no_grad():
        for data in data_generator:
            feat = inception(torch.as_tensor(data).to(device))
            features.append(feat.double().cpu().numpy())
    return np.concatenate(features, axis=0)


def calculate_fid(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """Frechet distance between two multivariate Gaussians
    (reference: basicsr/metrics/fid.py:58-80):
    d^2 = |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)).

    A non-finite ``sqrtm`` (a singular product) is retried with ``eps`` on
    both diagonals; an imaginary part above 1e-3 on the diagonal raises,
    a smaller one is dropped.
    """
    assert mu1.shape == mu2.shape
    assert sigma1.shape == sigma2.shape
    try:
        cov_sqrt = linalg.sqrtm(sigma1 @ sigma2)
    except Exception:
        cov_sqrt = np.full_like(sigma1, np.nan)
    if not np.isfinite(cov_sqrt).all():
        print('Product of cov matrices is singular. Adding '
              f'{eps} to diagonal of cov estimates')
        offset = np.eye(sigma1.shape[0]) * eps
        cov_sqrt = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(cov_sqrt):
        if not np.allclose(np.diagonal(cov_sqrt).imag, 0, atol=1e-3):
            m = np.max(np.abs(cov_sqrt.imag))
            raise ValueError(f'Imaginary component {m}')
        cov_sqrt = cov_sqrt.real
    mean_diff = mu1 - mu2
    mean_norm = mean_diff @ mean_diff
    trace = np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(cov_sqrt)
    return float(mean_norm + trace)
