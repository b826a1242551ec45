"""Command-line option parsing shared by the port's CLIs
(reference: basicsr/train.py:22-55), the counterpart of
``edvr_tpu/train.py::parse_options``. The training loop is not ported
yet."""

from __future__ import annotations

import argparse

from edvr_tpu_torch.utils.options import parse


def parse_options(is_train=True, args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--device', default='cuda',
                        help="torch device to run on (default 'cuda'; "
                        "'cpu' runs the plain PyTorch versions)")
    args = parser.parse_args(args)
    opt = parse(args.opt, is_train=is_train)
    opt['device'] = args.device
    return opt
