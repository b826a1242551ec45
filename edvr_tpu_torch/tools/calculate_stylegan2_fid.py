"""FID of a StyleGAN2 generator against dataset statistics, the port of
``scripts/metrics/calculate_stylegan2_fid.py``::

    python -m edvr_tpu_torch.tools.calculate_stylegan2_fid net_g.pth
        --fid_stats stats.npz [--inception_weights pt_inception.pth]
        [--out_size 256] [--batch_size 64] [--num_sample 50000]
        [--param_key params_ema] [--seed 0] [--device cuda]

draws ``num_sample`` images (the codes from
``torch.Generator().manual_seed(seed)`` on the CPU, the injected noise from
the generator's own device generator), maps them from [-1, 1] to [0, 1]
(clipped), resizes them to 299x299 (bilinear, ``align_corners`` False: the
JAX tool's ``edvr_tpu/ops/resize.py::interpolate``), takes the FID
InceptionV3's pool3 features and prints the Frechet distance of their
mean and covariance to ``--fid_stats`` (an ``.npz`` of ``mean`` and
``cov``). Without ``--inception_weights`` the network has torch's
initialisation, which scores nothing real.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F


def inception_input(img):
    """G's (n, 3, h, w) output in [-1, 1] -> the inception's input: [0, 1],
    clipped, 299x299."""
    img = torch.clamp((img + 1) / 2, 0, 1)
    return F.interpolate(img, size=(299, 299), mode='bilinear',
                         align_corners=False)


def sample_features(net, inception, num_sample, batch_size, seed=0):
    """The pool3 features of ``num_sample`` samples of ``net``, as a (n,
    2048) float64 array, and the seconds each batch took (host clock,
    ending in a synchronise on a card)."""
    gen = torch.Generator().manual_seed(seed)
    device = net.constant_input.weight.device
    features, secs = [], []
    total = 0
    with torch.no_grad():
        while total < num_sample:
            t0 = time.perf_counter()
            latent = torch.randn(batch_size, net.num_style_feat,
                                 generator=gen).to(device)
            img, _ = net([latent])
            feat = inception(inception_input(img))
            features.append(feat.double().cpu().numpy())
            secs.append(time.perf_counter() - t0)
            total += batch_size
            print(f'{total}/{num_sample}')
    return np.concatenate(features, 0)[:num_sample], secs


def main(args=None):
    from edvr_tpu_torch.metrics.fid import (calculate_fid,
                                            load_patched_inception_v3)
    from edvr_tpu_torch.tools.inference_stylegan2 import build_generator
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('ckpt', type=str)
    parser.add_argument('--fid_stats', type=str, required=True)
    parser.add_argument('--inception_weights', type=str, default=None)
    parser.add_argument('--out_size', type=int, default=256)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--num_sample', type=int, default=50000)
    parser.add_argument('--param_key', type=str, default='params_ema')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda',
                        help="torch device (default 'cuda')")
    args = parser.parse_args(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = build_generator(args.ckpt, args.out_size, 2, args.param_key,
                          args.device)
    inception = load_patched_inception_v3(args.inception_weights,
                                          net.constant_input.weight.device)
    features, _ = sample_features(net, inception, args.num_sample,
                                  args.batch_size, args.seed)
    stats = np.load(args.fid_stats)
    fid = calculate_fid(np.mean(features, 0),
                        np.cov(features, rowvar=False), stats['mean'],
                        stats['cov'])
    print('fid:', fid)
    return fid


if __name__ == '__main__':
    main()
