"""ESRGAN inference over a folder, the port of
``inference/inference_esrgan.py`` (reference: inference/inference_esrgan.py)::

    python -m edvr_tpu_torch.tools.inference_esrgan
        --model_path experiments/pretrained_models/ESRGAN_SRx4.pth
        [--input datasets/Set14/LRbicx4] [--output results/ESRGAN]
        [--device cuda]

builds RRDBNet at the published width (64 features, 23 blocks, grow 32,
x4), loads a BasicSR ``.pth`` (its ``params``) or an ``edvr_tpu``
checkpoint strictly, and writes ``<output>/<name>_ESRGAN.png`` for every
file of ``--input``: each image read as BGR in [0, 1], restored in RGB,
turned back to BGR, clipped to [0, 1], scaled by 255 and rounded (half to
even, as numpy rounds) to uint8, as the JAX tool does. No configuration or
engine is involved.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp

import numpy as np
import torch


def build_rrdbnet(model_path, device='cuda', num_feat=64, num_block=23,
                  num_grow_ch=32):
    """RRDBNet (x4) with the weights of ``model_path`` loaded strictly, on
    ``device``, in eval mode."""
    from edvr_tpu_torch.archs.rrdbnet_arch import RRDBNet
    from edvr_tpu_torch.convert import load_state_dict_file
    from edvr_tpu_torch.models.base_model import resolve_device
    net = RRDBNet(num_in_ch=3, num_out_ch=3, num_feat=num_feat,
                  num_block=num_block, num_grow_ch=num_grow_ch)
    net.load_state_dict(load_state_dict_file(model_path, 'params'),
                        strict=True)
    return net.to(resolve_device(device)).eval().requires_grad_(False)


def restore(net, img):
    """One (h, w, 3) BGR float32 image in [0, 1] through ``net``: the x4
    result as a (4h, 4w, 3) BGR uint8 image."""
    device = next(net.parameters()).device
    rgb = torch.from_numpy(np.ascontiguousarray(
        img[:, :, ::-1].transpose(2, 0, 1)))[None].to(device)
    with torch.no_grad():
        out = net(rgb)[0].cpu().numpy().transpose(1, 2, 0)[:, :, ::-1]
    return (np.clip(out, 0, 1) * 255.0).round().astype(np.uint8)


def main(args=None):
    import cv2
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument(
        '--model_path', type=str,
        default='experiments/pretrained_models/ESRGAN_SRx4.pth')
    parser.add_argument('--input', type=str, default='datasets/Set14/LRbicx4',
                        help='input test image folder')
    parser.add_argument('--output', type=str, default='results/ESRGAN',
                        help='output folder')
    parser.add_argument('--device', default='cuda',
                        help="torch device (default 'cuda')")
    args = parser.parse_args(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = build_rrdbnet(args.model_path, args.device)
    os.makedirs(args.output, exist_ok=True)
    paths = []
    for idx, path in enumerate(sorted(glob.glob(osp.join(args.input, '*')))):
        imgname = osp.splitext(osp.basename(path))[0]
        print('Testing', idx, imgname, flush=True)
        img = cv2.imread(path, cv2.IMREAD_COLOR).astype(np.float32) / 255.
        out_path = osp.join(args.output, f'{imgname}_ESRGAN.png')
        cv2.imwrite(out_path, restore(net, img))
        paths.append(out_path)
    return paths


if __name__ == '__main__':
    main()
