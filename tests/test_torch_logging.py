"""The port's logging (``edvr_tpu_torch/utils/logger.py``, ``train.py``) on
the CPU, against the JAX package's tags and behaviour
(``edvr_tpu/utils/logger.py:59-121``, ``edvr_tpu/train.py:179-213``,
``edvr_tpu/models/video_base_model.py:253-257``, ``sr_model.py:304``,
``stylegan2_model.py:339-345``):

* the training CLI with ``use_tb_logger``: the losses as ``losses/<k>``,
  the validation as ``metrics/<metric>`` and ``metrics/<metric>/<folder>``
  in ``<root>/tb_logger/<name>``, read back from the event file;
* the ``logger.profile`` window: a Chrome trace of the iterations it
  spans, under ``<log>/profile`` (its default) or ``logdir``;
* the image-SR engine's ``metrics/<metric>`` and StyleGAN2's ``samples``
  image (the JAX engine's BGR -> RGB grid over 255);
* a missing TensorBoard package warns and the run goes on; wandb warns
  and is skipped (not installed here), and asks for TensorBoard.
"""

import json
import logging
import os
import os.path as osp
import sys

import numpy as np
import pytest
import yaml

from edvr_tpu_torch import train
from edvr_tpu_torch.models import create_model
from edvr_tpu_torch.utils import logger as port_logger
from edvr_tpu_torch.utils.options import parse_dict
from test_torch_stylegan2 import sg2_opt
from test_torch_train import _write_train_yml
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


class Recorder:
    """A TensorBoard writer's ``add_scalar`` / ``add_image``, recorded."""

    def __init__(self):
        self.scalars, self.images = {}, {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))

    def add_image(self, tag, img, global_step=None, dataformats='CHW'):
        self.images[tag] = (global_step, img, dataformats)


def _train_yml(tmp_path, name, **logger):
    """tests/test_torch_train.py's small EDVR run (4 bf16 iterations,
    validation at 2 and 4 and after the loop) with ``logger`` options."""
    yml = _write_train_yml(tmp_path, name=name)
    with open(yml) as f:
        opt = yaml.safe_load(f)
    opt['logger'].update(logger)
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    return yml


def _events(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()['scalars']}


def test_train_cli_tensorboard_and_profile_window(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    yml = _train_yml(tmp_path, 'tb_run', use_tb_logger=True,
                     profile=dict(start_iter=2, end_iter=3))
    model = train.main(['-opt', yml, '--device', 'cpu'])
    events = _events(str(tmp_path / 'tb_logger' / 'tb_run'))
    # losses/<k> for each loss, every print_freq (1) iterations; the
    # validation's average and folder at val_freq (2) and after the loop
    # (at the iteration past the last, as the JAX loop counts it)
    assert [s for s, _ in events['losses/l_pix']] == [1, 2, 3, 4]
    assert [s for s, _ in events['metrics/psnr']] == [2, 4, 5]
    assert [s for s, _ in events['metrics/psnr/000']] == [2, 4, 5]
    psnr = float(model.metric_results['000'][:, 0].mean())
    assert events['metrics/psnr/000'][-1][1] == pytest.approx(psnr)
    assert set(events) == {'losses/l_pix', 'metrics/psnr',
                           'metrics/psnr/000'}

    trace = tmp_path / 'experiments' / 'tb_run' / 'profile' / \
        'trace_rank0.json'
    with open(trace) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    # the window holds the steps' operators, the backward's too
    assert {'aten::convolution', 'aten::convolution_backward'} <= names


def test_profile_logdir_and_a_window_cut_short(tmp_path, monkeypatch):
    """``logdir`` puts the trace elsewhere; a window still open when the
    run ends is closed and written."""
    monkeypatch.chdir(tmp_path)
    logdir = str(tmp_path / 'traces')
    yml = _train_yml(tmp_path, 'cut', profile=dict(start_iter=3, end_iter=99,
                                                   logdir=logdir))
    train.main(['-opt', yml, '--device', 'cpu'])
    assert os.listdir(logdir) == ['trace_rank0.json']
    assert not osp.exists(tmp_path / 'tb_logger')


def test_sr_and_stylegan2_tensorboard_tags(tmp_path):
    sr = create_model(dict(parse_dict(
        {'name': 'tb_sr', 'model_type': 'SRModel', 'scale': 4,
         'num_gpu': 1, 'manual_seed': 0,
         'network_g': dict(type='MSRResNet', num_in_ch=3, num_out_ch=3,
                           num_feat=8, num_block=1, upscale=4),
         'path': {}, 'val': {'metrics': {}}}, is_train=False,
        root=str(tmp_path)), device='cpu'))
    sr.metric_results = {'psnr': 30.5, 'ssim': 0.75}
    rec = Recorder()
    sr._log_validation_metric_values(7, 'Set5', rec)
    assert rec.scalars == {'metrics/psnr': [(7, 30.5)],
                           'metrics/ssim': [(7, 0.75)]}

    opt = parse_dict(sg2_opt(), is_train=True, root=str(tmp_path))
    opt['device'] = 'cpu'
    sg2 = create_model(opt)
    rec = Recorder()
    sg2.dist_validation(None, 3, rec, False)
    step, img, fmt = rec.images['samples']
    import cv2
    grid = cv2.imread(osp.join(opt['path']['visualization'], 'train',
                               'train_3.png'))
    assert (step, fmt) == (3, 'HWC') and img.dtype == np.float32
    np.testing.assert_array_equal(img, grid[..., ::-1] / np.float32(255.))


def test_missing_tensorboard_warns_and_goes_on(tmp_path, monkeypatch,
                                              caplog):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    logger = port_logger.get_root_logger()
    monkeypatch.setattr(logger, 'propagate', True)
    with caplog.at_level(logging.WARNING, logger=logger.name):
        assert port_logger.init_tb_logger(str(tmp_path / 'tb')) is None
    assert 'TensorBoard cannot be imported' in caplog.text
    assert not osp.exists(tmp_path / 'tb')


def test_wandb_is_skipped_and_needs_tensorboard(tmp_path, monkeypatch,
                                               caplog):
    opt = parse_dict({'name': 'wb', 'path': {}, 'logger': {
        'use_tb_logger': True, 'wandb': {'project': 'edvr'}}},
        root=str(tmp_path))
    os.makedirs(opt['path']['log'])
    monkeypatch.setitem(sys.modules, 'wandb', None)
    logger = port_logger.get_root_logger()
    monkeypatch.setattr(logger, 'propagate', True)
    with caplog.at_level(logging.WARNING, logger=logger.name):
        _, tb = port_logger.init_loggers(opt)
    tb.close()
    assert 'wandb is not installed; skipping.' in caplog.text
    opt['logger']['use_tb_logger'] = False
    with pytest.raises(ValueError, match='turn on tensorboard'):
        port_logger.init_loggers(opt)
