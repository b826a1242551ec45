"""The port's image-SR slice against the JAX package, on the CPU at the
goldens' tiny widths: MSRResNet, EDSR, RCAN and RRDBNet against their
goldens and the JAX modules (weights carried by
``convert.jax_params_to_state_dict``), the residual block's ``res_scale`` /
``pytorch_init`` and ``Upsample``, the official remaps, SSIM,
PairedImageDataset and SingleImageDataset item for item, the test CLI on a
tiny EDSR config against the JAX test CLI, and every shipped image-SR test
and training YAML built through the CLIs' functions on seeded PNGs.
"""

import glob
import json
import os
import os.path as osp
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.archs.arch_util import ResidualBlockNoBN, Upsample
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.metrics import calculate_ssim
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
GOLDEN_DIR = osp.join(REPO, 'tests', 'data', 'golden')
ARCHS = ['msrresnet_x2', 'msrresnet_x3', 'msrresnet_x4', 'edsr_x2',
         'edsr_x3', 'edsr_x4', 'rcan', 'rrdbnet']
GOLDEN_TOL = 3e-4  # as tests/test_arch_parity.py
# the same float32 weights through both packages' convolutions
JAX_TOL = 1e-5


def load_golden(name):
    data = np.load(osp.join(GOLDEN_DIR, f'arch_{name}.npz'))
    config = json.loads(bytes(data['__config__']).decode())
    state = {k: torch.from_numpy(data[k]) for k in data.files
             if not k.startswith('__')}
    return config, state, data['__input__'], data['__output__']


@pytest.mark.parametrize('name', ARCHS)
def test_arch_matches_golden(name):
    config, state, x, want = load_golden(name)
    net = define_network(config)
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, atol=GOLDEN_TOL, err_msg=name)


@pytest.mark.parametrize('name', ARCHS)
def test_arch_matches_jax(name):
    """The JAX module with seeded weights (``jax.eval_shape`` of its init,
    numpy draws), carried over strictly by ``jax_params_to_state_dict``."""
    from edvr_tpu.archs import define_network as jax_define
    from test_torch_gan import seeded_variables
    config, _, x, _ = load_golden(name)
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    jnet = jax_define(config)
    params, _ = seeded_variables(jnet, xj, 9)
    want = np.moveaxis(np.asarray(jax.jit(
        lambda p, v: jnet.apply({'params': p}, v))(params, xj)), -1, 1)
    net = define_network(config)
    net.load_state_dict(jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=JAX_TOL * np.abs(want).max(),
                               err_msg=name)


def test_residual_block_and_upsample():
    torch.manual_seed(0)
    scaled = ResidualBlockNoBN(16, res_scale=0.1)
    plain = ResidualBlockNoBN(16, pytorch_init=True)
    # kaiming-normal x 0.1 with zero bias, or torch's default
    assert torch.equal(scaled.conv1.bias, torch.zeros(16))
    std = scaled.conv1.weight.std().item()
    assert 0.5 < std / (0.1 * (2 / (16 * 9)) ** 0.5) < 1.5
    assert plain.conv1.weight.abs().max() <= 1 / (16 * 9) ** 0.5
    assert plain.conv1.bias.abs().max() > 0
    x = torch.randn(1, 16, 5, 5)
    with torch.no_grad():
        res = scaled.conv2(torch.relu(scaled.conv1(x)))
        torch.testing.assert_close(scaled(x), x + 0.1 * res)
    for scale, children in ((2, 2), (3, 2), (4, 4), (8, 6)):
        up = Upsample(scale, 4)
        assert len(up) == children
        assert up(torch.zeros(1, 4, 3, 5)).shape == (1, 4, 3 * scale,
                                                      5 * scale)
    with pytest.raises(ValueError, match='not supported'):
        Upsample(5, 4)


@pytest.mark.parametrize('family', ['EDSR', 'RCAN', 'ESRGAN'])
def test_official_remaps_match_jax(family, tmp_path):
    """Synthetic official keys (the inverse maps of
    tests/test_convert_official.py) through the port's and the JAX remap;
    then the port's command on an official-keyed ``.pth`` loads strictly."""
    from edvr_tpu.convert import official as jofficial
    from edvr_tpu_torch.convert import official
    from test_convert_official import (edsr_to_official, esrgan_to_official,
                                       fixture_keys, rcan_to_official)
    name = {'EDSR': 'edsr_x4', 'RCAN': 'rcan', 'ESRGAN': 'rrdbnet'}[family]
    keys, cfg = fixture_keys(name)
    depth, to_official = {}, esrgan_to_official
    if family == 'EDSR':
        depth = dict(num_block=cfg['num_block'])
        to_official = edsr_to_official(cfg['num_block'])
    elif family == 'RCAN':
        depth = dict(num_group=cfg['num_group'], num_block=cfg['num_block'])
        to_official = rcan_to_official(cfg['num_group'], cfg['num_block'])
    _, state, _, _ = load_golden(name)
    state = {to_official(k): v for k, v in state.items()}
    state['unknown.weight'] = torch.zeros(1)
    got = official.REMAPPERS[family](state, **depth)
    want = jofficial.REMAPPERS[family](state, **depth)
    assert set(got[0]) == set(want[0]) and got[1] == want[1] == [
        'unknown.weight']
    pth = str(tmp_path / 'official.pth')
    torch.save({k: v for k, v in state.items() if k != 'unknown.weight'},
               pth)
    args = ['--source', family, '--pth', pth, '--out',
            str(tmp_path / 'net_g.pth')]
    for k, v in depth.items():
        args += [f'--{k}', str(v)]
    official.main(args)
    net = define_network(cfg)
    net.load_state_dict(torch.load(str(tmp_path / 'net_g.pth'),
                                   weights_only=True)['params'], strict=True)


@pytest.mark.parametrize('test_y_channel', [False, True])
@pytest.mark.parametrize('crop_border', [0, 4])
def test_ssim_matches_jax_and_golden(crop_border, test_y_channel):
    from edvr_tpu.metrics import calculate_ssim as jax_ssim
    g = np.load(osp.join(GOLDEN_DIR, 'substrate.npz'))
    a, b = g['metric_img1'], g['metric_img2']
    key = f'cb{crop_border}_y{int(test_y_channel)}'
    got = calculate_ssim(a, b, crop_border, test_y_channel=test_y_channel)
    # the JAX metric's own bound against the golden
    # (tests/test_matlab_and_metrics.py); the luma rounds to float32
    assert abs(got - g[f'ssim_{key}']) < 1e-7
    assert abs(got - jax_ssim(a, b, crop_border,
                              test_y_channel=test_y_channel)) < 1e-7
    # CHW order, as the JAX metric takes it
    chw = calculate_ssim(a.transpose(2, 0, 1), b.transpose(2, 0, 1),
                         crop_border, input_order='CHW',
                         test_y_channel=test_y_channel)
    assert chw == got
    with pytest.raises(ValueError, match='shapes'):
        calculate_ssim(a, b[:-1], crop_border)


# ---------------------------------------------------------------------- #
# data
# ---------------------------------------------------------------------- #
def write_pairs(root, n=3, lq_hw=(10, 12), scale=4, seed=0):
    """``n`` seeded GT/LQ PNG pairs of the same names under root/{gt,lq}."""
    rng = np.random.RandomState(seed)
    for sub in ('gt', 'lq'):
        os.makedirs(osp.join(root, sub), exist_ok=True)
    h, w = lq_hw
    for i in range(n):
        gt = rng.randint(0, 256, (h * scale, w * scale, 3), np.uint8)
        cv2.imwrite(osp.join(root, 'gt', f'{i:04d}.png'), gt)
        cv2.imwrite(osp.join(root, 'lq', f'{i:04d}.png'),
                    cv2.resize(gt, (w, h), interpolation=cv2.INTER_AREA))
    return root


def _jax_item_chw(item):
    return {k: (np.moveaxis(v, -1, 0) if isinstance(v, np.ndarray) else v)
            for k, v in item.items()}


@pytest.mark.parametrize('phase,meta,norm', [
    ('train', False, False), ('train', True, True), ('val', False, False)])
def test_paired_image_dataset_matches_jax(tmp_path, phase, meta, norm):
    from edvr_tpu.data.paired_image_dataset import PairedImageDataset as Jax
    from edvr_tpu_torch.data.paired_image_dataset import PairedImageDataset
    root = write_pairs(str(tmp_path))
    opt = dict(name='pairs', phase=phase, scale=4, dataroot_gt=f'{root}/gt',
               dataroot_lq=f'{root}/lq', io_backend=dict(type='disk'),
               gt_size=16, use_flip=True, use_rot=True)
    if meta:
        with open(f'{root}/meta.txt', 'w') as f:
            f.write('0002.png (40, 48, 3)\n0000.png (40, 48, 3)\n')
        opt['meta_info_file'] = f'{root}/meta.txt'
    if norm:
        opt.update(mean=[0.5, 0.4, 0.3], std=[0.2, 0.25, 0.3])
    ours = PairedImageDataset(dict(opt), rng=random.Random(3))
    ref = Jax(dict(opt))
    assert len(ours) == len(ref) == (2 if meta else 3)
    random.seed(3)
    for i in range(len(ref)):
        want = _jax_item_chw(ref[i])
        got = ours[i]
        assert set(got) == set(want)
        assert got['lq_path'] == want['lq_path']
        for k in ('lq', 'gt'):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=(i, k))
    if phase == 'train':
        assert tuple(got['gt'].shape) == (3, 16, 16)


@pytest.mark.parametrize('meta', [False, True])
def test_single_image_dataset_matches_jax(tmp_path, meta):
    from edvr_tpu.data.single_image_dataset import SingleImageDataset as Jax
    from edvr_tpu_torch.data.single_image_dataset import SingleImageDataset
    root = write_pairs(str(tmp_path))
    opt = dict(name='single', phase='test', dataroot_lq=f'{root}/lq',
               io_backend=dict(type='disk'), mean=[0.1, 0.2, 0.3],
               std=[1.0, 0.5, 2.0])
    if meta:
        with open(f'{root}/meta.txt', 'w') as f:
            f.write('0001.png\n0000.png\n')
        opt['meta_info_file'] = f'{root}/meta.txt'
    ours, ref = SingleImageDataset(dict(opt)), Jax(dict(opt))
    assert len(ours) == len(ref) == (2 if meta else 3)
    for i in range(len(ref)):
        want = _jax_item_chw(ref[i])
        assert ours[i]['lq_path'] == want['lq_path']
        np.testing.assert_allclose(ours[i]['lq'].numpy(), want['lq'],
                                   rtol=1e-6, atol=1e-7)


def test_image_datasets_refuse_lmdb(tmp_path):
    from edvr_tpu_torch.data import create_dataset
    for opt in (dict(type='PairedImageDataset', dataroot_gt='a.lmdb',
                     dataroot_lq='b.lmdb'),
                dict(type='SingleImageDataset', dataroot_lq='b.lmdb')):
        with pytest.raises(NotImplementedError, match='A.9'):
            create_dataset(dict(opt, name='x', phase='test',
                                io_backend=dict(type='lmdb')))


# ---------------------------------------------------------------------- #
# the CLIs
# ---------------------------------------------------------------------- #
def test_test_cli_edsr_matches_jax(tmp_path, monkeypatch):
    """A tiny EDSR config (seeded ``.pth``) through
    ``python -m edvr_tpu_torch.test --device cpu`` and the JAX test CLI:
    PSNR and SSIM within 1e-6, and the result images written."""
    from edvr_tpu.test import main as jax_main
    from edvr_tpu_torch.test import main
    monkeypatch.chdir(tmp_path)
    root = write_pairs(str(tmp_path / 'pairs'), lq_hw=(12, 14), scale=2)
    torch.manual_seed(5)
    net_opt = dict(type='EDSR', num_in_ch=3, num_out_ch=3, num_feat=8,
                   num_block=2, upscale=2, res_scale=0.1)
    net = define_network(net_opt)
    pth = str(tmp_path / 'edsr.pth')
    torch.save({'params': net.state_dict()}, pth)
    opt = dict(name='edsr_tiny', model_type='SRModel', scale=2, num_gpu=1,
               manual_seed=0,
               datasets=dict(test_1=dict(
                   name='pairs', type='PairedImageDataset',
                   dataroot_gt=f'{root}/gt', dataroot_lq=f'{root}/lq',
                   io_backend=dict(type='disk'))),
               network_g=net_opt,
               path=dict(pretrain_network_g=pth, strict_load_g=True),
               val=dict(save_img=True, suffix=None, metrics=dict(
                   psnr=dict(type='calculate_psnr', crop_border=2,
                             test_y_channel=False),
                   ssim=dict(type='calculate_ssim', crop_border=2,
                             test_y_channel=True))))
    yml = str(tmp_path / 'edsr.yml')
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f)
    model = main(['-opt', yml, '--device', 'cpu'])
    want = jax_main(['-opt', yml]).metric_results
    assert set(model.metric_results) == {'psnr', 'ssim'}
    for k, v in want.items():
        assert abs(model.metric_results[k] - float(v)) <= 1e-6, k
    saved = sorted(glob.glob(str(tmp_path / 'results' / 'edsr_tiny' /
                                 'visualization' / 'pairs' / '*.png')))
    assert [osp.basename(p) for p in saved] == [
        f'{i:04d}_edsr_tiny.png' for i in range(3)]


def _shipped(kind, families):
    return sorted(p for f in families for p in glob.glob(
        osp.join(REPO, 'options', kind, f, '*.yml')))


def _scale_of(yml):
    with open(yml) as f:
        return yaml.safe_load(f)['scale']


@pytest.fixture(scope='module')
def pair_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp('shipped')
    return {s: write_pairs(str(root / f'x{s}'), n=2, lq_hw=(8, 8), scale=s)
            for s in (2, 3, 4)}


@pytest.mark.parametrize('yml', _shipped(
    'test', ['EDSR', 'RCAN', 'ESRGAN', 'SRResNet_SRGAN']),
    ids=osp.basename)
def test_shipped_test_yml_runs(yml, pair_trees, tmp_path, monkeypatch):
    """The shipped config at its own widths through the test CLI on 8x8 LQ
    PNGs, its pretrained path (not in the repository) cut to seeded
    weights: PSNR and SSIM where it has GT."""
    from edvr_tpu_torch.test import main
    monkeypatch.chdir(tmp_path)
    root = pair_trees[_scale_of(yml)]
    with open(yml) as f:
        datasets = yaml.safe_load(f)['datasets']
    force = ['path:pretrain_network_g=~', 'val:save_img=false']
    for name, d in datasets.items():
        force.append(f'datasets:{name}:dataroot_lq={root}/lq')
        if 'dataroot_gt' in d:
            force.append(f'datasets:{name}:dataroot_gt={root}/gt')
    model = main(['-opt', yml, '--device', 'cpu', '--force_yml', *force])
    metrics = getattr(model, 'metric_results', {})
    if any('dataroot_gt' in d for d in datasets.values()):
        assert set(metrics) == {'psnr', 'ssim'}
        assert all(np.isfinite(v) for v in metrics.values())
    else:
        assert not metrics


@pytest.mark.parametrize('yml', _shipped(
    'train', ['EDSR', 'RCAN', 'ESRGAN', 'SRResNet_SRGAN']) + [
        osp.join(REPO, 'options', 'train', 'EDVR',
                 'train_EDVRM_VideoGAN_REDS.yml')], ids=osp.basename)
def test_shipped_train_yml_builds(yml, pair_trees, tmp_path, monkeypatch):
    """The shipped training config at its own widths through the train
    CLI's option parsing, dataloaders and ``create_model`` (seeded weights
    for the pretrained paths, which are not in the repository; the REDS
    tree cut to one 8-frame clip), then one training batch fed."""
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.train import (create_train_val_dataloader,
                                      parse_options)
    from edvr_tpu_torch.utils import get_root_logger
    monkeypatch.chdir(tmp_path)
    with open(yml) as f:
        shipped = yaml.safe_load(f)
    force = ['path:pretrain_network_g=~',
             'datasets:train:num_worker_per_gpu=0',
             'datasets:train:batch_size_per_gpu=1', 'num_gpu=1',
             f"datasets:train:gt_size={8 * shipped['scale']}"]
    if shipped['model_type'] == 'VideoGANModel':
        from test_torch_train import _reds_tree
        _reds_tree(str(tmp_path / 'reds'))
        force += [f'datasets:train:dataroot_gt={tmp_path}/reds/train/gt',
                  f'datasets:train:dataroot_lq={tmp_path}/reds/train/lq',
                  f'datasets:train:meta_info_file={tmp_path}/reds/'
                  'meta_info.txt']
    else:
        root = pair_trees[shipped['scale']]
        for phase in shipped['datasets']:
            force += [f'datasets:{phase}:dataroot_gt={root}/gt',
                      f'datasets:{phase}:dataroot_lq={root}/lq']
    opt = parse_options(True, ['-opt', yml, '--device', 'cpu',
                               '--force_yml', *force])
    train_loader, _, val_loader, _, _ = create_train_val_dataloader(
        opt, get_root_logger())
    model = create_model(opt)
    batch = next(iter(train_loader))
    model.feed_data(batch)
    assert model.lq.shape[0] == 1
    if opt['network_g']['type'] != 'EDVR':
        assert val_loader is not None
    if 'network_d' in opt:
        assert type(model.net_d).__name__ == 'VGGStyleDiscriminator128'
