"""``python -m edvr_tpu_torch.test --device cpu`` on synthetic PNG clips:
the REDS4 protocol (VideoTestDataset, whole-clip EDVR evaluation,
per-folder x per-frame PSNR, save_img layout), modelled on
tests/test_test_cli.py."""

import logging
import os
import os.path as osp
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _make_clips(root, clips=('000', '011'), frames=7, lq_hw=16, scale=4):
    rng = np.random.RandomState(0)
    for clip in clips:
        os.makedirs(osp.join(root, 'gt', clip))
        os.makedirs(osp.join(root, 'lq', clip))
        for f in range(frames):
            gt = rng.randint(0, 256, (lq_hw * scale, lq_hw * scale, 3),
                             np.uint8)
            cv2.imwrite(osp.join(root, 'gt', clip, f'{f:08d}.png'), gt)
            cv2.imwrite(osp.join(root, 'lq', clip, f'{f:08d}.png'),
                        cv2.resize(gt, (lq_hw, lq_hw),
                                   interpolation=cv2.INTER_AREA))


def _write_opt(tmp_path, root, name, **val):
    opt = {
        'name': name, 'model_type': 'EDVRModel', 'scale': 4,
        'num_gpu': 1, 'manual_seed': 0,
        'datasets': {'test_1': dict(
            name='REDS4', type='VideoTestDataset',
            dataroot_gt=f'{root}/gt', dataroot_lq=f'{root}/lq',
            meta_info_file=None, io_backend=dict(type='disk'),
            cache_data=True, num_frame=5, padding='reflection_circle')},
        'network_g': dict(type='EDVR', num_in_ch=3, num_out_ch=3,
                          num_feat=8, num_frame=5, deformable_groups=2,
                          num_extract_block=1, num_reconstruct_block=1,
                          center_frame_idx=None, hr_in=False,
                          with_predeblur=False, with_tsa=True),
        'path': dict(pretrain_network_g=None, strict_load_g=True),
        'val': dict(save_img=True, suffix=None, clip_mode=True,
                    clip_win_batch=1,
                    metrics=dict(psnr=dict(type='calculate_psnr',
                                           crop_border=0,
                                           test_y_channel=False))),
    }
    opt['val'].update(val)
    yml = str(tmp_path / f'{name}.yml')
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    return yml


def _run_cli(tmp_path, *args):
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get('PYTHONPATH', '')]))
    return subprocess.run(
        [sys.executable, '-m', 'edvr_tpu_torch.test', *args], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=600)


def test_cli_restores_reds4_protocol(tmp_path):
    root = str(tmp_path / 'reds4')
    _make_clips(root)
    yml = _write_opt(tmp_path, root, 'torch_cli')
    proc = _run_cli(tmp_path, '-opt', yml, '--device', 'cpu')
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'Validation REDS4' in proc.stderr and '# psnr:' in proc.stderr

    vis = osp.join(str(tmp_path), 'results', 'torch_cli', 'visualization',
                   'REDS4')
    for clip in ('000', '011'):
        pngs = sorted(os.listdir(osp.join(vis, clip)))
        assert pngs == [f'{f:08d}_torch_cli.png' for f in range(7)]
        img = cv2.imread(osp.join(vis, clip, pngs[0]))
        assert img.shape == (64, 64, 3)


@pytest.mark.parametrize('win_batch', [1, 4])
def test_cli_metric_table(tmp_path, monkeypatch, win_batch):
    """In process: every (folder, frame) slot is scored, and the table does
    not depend on how many windows run per step."""
    root = str(tmp_path / 'reds4')
    _make_clips(root, frames=6)
    yml = _write_opt(tmp_path, root, f'wb{win_batch}', save_img=False,
                     clip_win_batch=win_batch)
    monkeypatch.chdir(tmp_path)
    from edvr_tpu_torch.test import main
    model = main(args=['-opt', yml, '--device', 'cpu'])
    assert model.device == torch.device('cpu')
    assert set(model.metric_results) == {'000', '011'}
    for folder, table in model.metric_results.items():
        assert table.shape == (6, 1)
        assert np.isfinite(table).all() and (table > 0).all(), table
    if win_batch == 4:
        ref = main(args=['-opt', _write_opt(tmp_path, root, 'wb1',
                                            save_img=False),
                         '--device', 'cpu'])
        for folder in ref.metric_results:
            np.testing.assert_allclose(model.metric_results[folder],
                                       ref.metric_results[folder],
                                       rtol=1e-5)


def test_cli_cuda_without_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    root = str(tmp_path / 'reds4')
    _make_clips(root, clips=('000',), frames=5)
    yml = _write_opt(tmp_path, root, 'no_card')
    proc = _run_cli(tmp_path, '-opt', yml)  # device defaults to cuda
    assert proc.returncode != 0
    assert 'CUDA is not available' in proc.stderr


@pytest.mark.parametrize('is_train', [False, True])
def test_parse_options_turns_tf32_off(tmp_path, is_train):
    """Both CLIs parse their options with ``parse_options``, which turns
    TF32 off in cuDNN convolutions and in matmuls; in a fresh process
    cuDNN's is on (and matmul's is turned on here first)."""
    yml = _write_opt(tmp_path, str(tmp_path / 'reds4'), 'tf32')
    code = (
        'import sys, torch\n'
        'from edvr_tpu_torch.train import parse_options\n'
        'flags = lambda: (torch.backends.cuda.matmul.allow_tf32, '
        'torch.backends.cudnn.allow_tf32)\n'
        'torch.backends.cuda.matmul.allow_tf32 = True\n'
        'before = flags()\n'
        f'parse_options(is_train={is_train}, '
        f'args=["-opt", sys.argv[1], "--device", "cpu"])\n'
        'print(before, flags())\n')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get('PYTHONPATH', '')]))
    proc = subprocess.run([sys.executable, '-c', code, yml], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ['(True,', 'True)', '(False,', 'False)']


def test_port_imports_no_jax_cv2_or_yaml():
    """Importing every module of the port (and chip_smoke.py), the
    training slice's and the packed DCN route's included, pulls in no JAX,
    nothing of edvr_tpu, and neither cv2 nor yaml: the card's Python may
    have none of them."""
    code = (
        'import pkgutil, sys, edvr_tpu_torch\n'
        'for m in pkgutil.walk_packages(edvr_tpu_torch.__path__, '
        '"edvr_tpu_torch."):\n'
        '    __import__(m.name)\n'
        'import chip_smoke\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "flax", "optax", "edvr_tpu", "cv2", "yaml"))\n'
        'need = ["edvr_tpu_torch." + m for m in ("train", "ops.dcn", '
        '"ops.gather", "ops.dcn_blend", "archs.arch_util", '
        '"models.losses", "models.lr_scheduler", "models.edvr_model", '
        '"data.transforms", "data.file_client", "data.reds_dataset", '
        '"data.data_sampler", "utils.logger", "utils.misc")]\n'
        'missing = [m for m in need if m not in sys.modules]\n'
        'print(bad, missing)\n'
        'sys.exit(1 if bad or missing else 0)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def test_video_test_dataset_matches_jax(tmp_path):
    """The port's VideoTestDataset items (NCHW tensors) equal the JAX
    package's (NHWC arrays) on the same PNG clips."""
    from edvr_tpu.data.video_test_dataset import \
        VideoTestDataset as JaxVideoTestDataset
    from edvr_tpu_torch.data import create_dataset
    root = str(tmp_path / 'reds4')
    _make_clips(root, frames=6)
    for cache in (True, False):
        opt = dict(name='REDS4', type='VideoTestDataset', phase='test',
                   dataroot_gt=f'{root}/gt', dataroot_lq=f'{root}/lq',
                   meta_info_file=None, io_backend=dict(type='disk'),
                   cache_data=cache, num_frame=5, padding='reflection_circle')
        ours, ref = create_dataset(opt), JaxVideoTestDataset(dict(opt))
        assert len(ours) == len(ref) == 12
        assert ours.data_info == ref.data_info
        for i in (0, 5, 7):
            a, b = ours[i], ref[i]
            np.testing.assert_array_equal(
                a['lq'].permute(0, 2, 3, 1).numpy(), b['lq'])
            np.testing.assert_array_equal(
                a['gt'].permute(1, 2, 0).numpy(), b['gt'])
            assert [a[k] for k in ('folder', 'idx', 'border', 'lq_path')] \
                == [b[k] for k in ('folder', 'idx', 'border', 'lq_path')]


def test_root_logger_follows_the_latest_log_file(tmp_path):
    """Each CLI run in one process logs to its own file: a second
    ``log_file`` replaces the first's handler (it stayed on the first
    before, so a later run's log file was never written)."""
    from edvr_tpu_torch.utils import get_root_logger
    first, second = str(tmp_path / 'first.log'), str(tmp_path / 'second.log')
    get_root_logger(log_file=first).info('one')
    get_root_logger(log_file=second).info('two')
    get_root_logger().info('three')
    with open(first) as f:
        assert 'one' in f.read()
    with open(second) as f:
        text = f.read()
    assert 'two' in text and 'three' in text and 'one' not in text
    handlers = get_root_logger().handlers
    assert sum(isinstance(h, logging.FileHandler) for h in handlers) == 1
