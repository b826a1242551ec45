"""StyleGAN2 sampling, the port of ``inference/inference_stylegan2.py``::

    python -m edvr_tpu_torch.tools.inference_stylegan2 --ckpt net_g.pth
        [--out_size 1024] [--channel_multiplier 2] [--nums 16]
        [--output samples] [--truncation 0.7] [--truncation_mean 4096]
        [--param_key params_ema] [--seed 0] [--device cuda]

loads a BasicSR ``.pth`` of ``StyleGAN2Generator`` (512 style features, 8
MLP layers) strictly and writes ``<output>/<i:08d>.png``, with the stored
noises (``randomize_noise`` False) and the truncation toward the mean of
``truncation_mean`` latents. The codes are drawn on the CPU from
``torch.Generator().manual_seed(seed)`` (the truncation's first), so a
seed gives the same images on the card and the CPU; JAX's keys cannot be
reproduced, so they are not the JAX tool's samples.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import torch


def build_generator(ckpt, out_size=1024, channel_multiplier=2,
                    param_key='params_ema', device='cuda'):
    """The generator of ``ckpt`` (loaded strictly) on ``device``, in eval
    mode."""
    from edvr_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
    from edvr_tpu_torch.convert import load_state_dict_file
    from edvr_tpu_torch.models.base_model import resolve_device
    net = StyleGAN2Generator(out_size=out_size,
                             channel_multiplier=channel_multiplier)
    net.load_state_dict(load_state_dict_file(ckpt, param_key), strict=True)
    return net.to(resolve_device(device)).eval().requires_grad_(False)


def samples(net, nums, truncation=0.7, truncation_mean=4096, seed=0):
    """Yield ``nums`` (1, 3, out, out) images in [-1, 1] from the codes
    of ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    device = net.constant_input.weight.device
    with torch.no_grad():
        mean_latent = (net.mean_latent(truncation_mean, gen)
                       if truncation < 1 else None)
        for _ in range(nums):
            latent = torch.randn(1, net.num_style_feat, generator=gen)
            img, _ = net([latent.to(device)], truncation=truncation,
                         truncation_latent=mean_latent,
                         randomize_noise=False)
            yield img


def main(args=None):
    from edvr_tpu_torch.utils import imwrite, tensor2img
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ckpt', type=str, required=True)
    parser.add_argument('--out_size', type=int, default=1024)
    parser.add_argument('--channel_multiplier', type=int, default=2)
    parser.add_argument('--nums', type=int, default=16,
                        help='number of samples')
    parser.add_argument('--output', type=str, default='samples')
    parser.add_argument('--truncation', type=float, default=0.7)
    parser.add_argument('--truncation_mean', type=int, default=4096)
    parser.add_argument('--param_key', type=str, default='params_ema')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda',
                        help="torch device (default 'cuda')")
    args = parser.parse_args(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = build_generator(args.ckpt, args.out_size, args.channel_multiplier,
                          args.param_key, args.device)
    os.makedirs(args.output, exist_ok=True)
    paths = []
    for i, img in enumerate(samples(net, args.nums, args.truncation,
                                    args.truncation_mean, args.seed)):
        path = osp.join(args.output, f'{i:08d}.png')
        imwrite(tensor2img(img, min_max=(-1, 1)), path)
        paths.append(path)
        print(f'sample {i}: saved')
    return paths


if __name__ == '__main__':
    main()
