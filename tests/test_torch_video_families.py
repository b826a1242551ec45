"""The video families in the port against the JAX package and the golden
fixtures: ``flow_warp`` / ``resize_flow``, SpyNet, TOFlow and DUF (16, 28
and 52 layers), BatchNorm's training-mode statistics, weights both ways
(the port's state dict into the JAX tree, a JAX ``.ckpt`` with
``batch_stats`` into the port), the DUF16 remap and its command,
``VideoTestDUFDataset`` and ``VideoRecurrentTestDataset``, and both
shipped Vid4 test YAMLs through ``python -m edvr_tpu_torch.test --device
cpu`` against the JAX network's PSNR table.

The JAX side is never initialised eagerly: ``jax.eval_shape`` of its init
gives the tree, ``convert_state_dict`` fills it from the port's weights
(or numpy draws fill it), and ``jax.jit(net.apply)`` runs it. JAX runs on
the CPU with float32 matmuls pinned (the repo-root conftest).
"""

import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edvr_tpu.archs import define_network as jax_define
from edvr_tpu.convert import convert_state_dict
from edvr_tpu.convert import official as jofficial
from edvr_tpu.data.data_util import duf_downsample as jax_duf_downsample
from edvr_tpu.data.video_test_dataset import \
    VideoRecurrentTestDataset as JaxRecurrent
from edvr_tpu.data.video_test_dataset import \
    VideoTestDUFDataset as JaxDUFDataset
from edvr_tpu.metrics.psnr_ssim import calculate_psnr as jax_psnr
from edvr_tpu.models.base_model import dump_checkpoint
from edvr_tpu.ops import sampling as jsampling
from edvr_tpu.utils.img_util import tensor2img as jax_tensor2img
from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.convert import load_state_dict_file, official
from edvr_tpu_torch.data import create_dataset
from edvr_tpu_torch.data.data_util import duf_downsample
from edvr_tpu_torch.ops.sampling import flow_warp, resize_flow
from edvr_tpu_torch.tools import video_families as vf

from test_convert_official import duf_to_official
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
GOLDEN_DIR = osp.join(REPO, 'tests', 'data', 'golden')
# the goldens, at tests/test_arch_parity.py's tolerance
GOLDEN_ATOL = 3e-4
# the port against the JAX modules on the same weights
ATOL = 1e-4
# flow_warp / resize_flow: the same taps, coordinates rounded otherwise
# (grid_sample's normalised round trip)
WARP_ATOL = 1e-5
# BatchNorm's running statistics after one training-mode forward
STATS_ATOL = 1e-5
DATA_ATOL = 1e-6
PSNR_ATOL = 1e-4
# the smallest legal inputs: SpyNet's pyramid needs a 64 px padded side
# (this one, 40x70 -> 64x96, also pads an odd level), TOFlow multiples of
# 16, DUF seven frames
NETS = {
    'spynet': (dict(type='SpyNet'), (1, 2, 3, 40, 70)),
    'toflow': (dict(type='TOFlow', adapt_official_weights=True),
               (1, 7, 3, 16, 32)),
    'duf16': (dict(type='DUF', scale=4, num_layer=16), (1, 7, 3, 6, 5)),
    'duf28': (dict(type='DUF', scale=2, num_layer=28), (1, 7, 3, 5, 6)),
    'duf52': (dict(type='DUF', scale=4, num_layer=52,
                   adapt_official_weights=True), (1, 7, 3, 5, 5)),
}


def nhwc(x):
    return np.moveaxis(np.asarray(x), -3, -1)


def jax_args(cfg, x):
    """The JAX network's arguments for the port's NCHW input ``x``."""
    x = nhwc(x)
    if cfg['type'] == 'SpyNet':
        return (jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]))
    return (jnp.asarray(x),)


def port_run(net, cfg, x):
    x = torch.from_numpy(x)
    with torch.no_grad():
        return (net(x[:, 0], x[:, 1]) if cfg['type'] == 'SpyNet'
                else net(x)).numpy()


def jax_template(jnet, args):
    """The JAX variables' tree as zeros, from ``jax.eval_shape`` of the
    init (nothing run)."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))


def to_jax(state, template):
    """The port's state dict into the JAX tree; only the ImageNet
    ``mean`` / ``std`` buffers (constants in flax) stay unmatched."""
    full = 'batch_stats' in template
    conv, unmatched = convert_state_dict(
        {k: v.numpy() for k, v in state.items()},
        template if full else template['params'])
    assert set(unmatched) <= {'mean', 'std'}, unmatched
    return conv if full else {'params': conv}


def seeded_jax(template, seed):
    """Numpy draws for every leaf: kernels N(0, 1 / fan_in), biases
    N(0, 0.01), BatchNorm scales 1 + N(0, 0.01), running means
    N(0, 0.01), running variances U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf == 'kernel':
            v = rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf == 'scale':
            v = 1 + rng.randn(*a.shape) * 0.1
        elif leaf == 'var':
            v = rng.uniform(0.5, 1.5, a.shape)
        else:
            v = rng.randn(*a.shape) * 0.1
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


# ---------------------------------------------------------------------- #
# flow_warp, resize_flow
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('align_corners', [True, False])
@pytest.mark.parametrize('padding_mode', ['zeros', 'border'])
@pytest.mark.parametrize('interp_mode', ['bilinear', 'nearest'])
def test_flow_warp_matches_jax(interp_mode, padding_mode, align_corners):
    """Flows of up to +-6 px on a 9x11 image: many samples fall outside,
    where ``zeros`` drops each tap outside and ``border`` clamps."""
    rng = np.random.RandomState(0)
    x = rng.rand(2, 5, 9, 11).astype(np.float32)
    flow = (rng.rand(2, 9, 11, 2).astype(np.float32) - 0.5) * 12
    got = flow_warp(torch.from_numpy(x), torch.from_numpy(flow),
                    interp_mode, padding_mode, align_corners).numpy()
    want = jsampling.flow_warp(jnp.asarray(nhwc(x)), jnp.asarray(flow),
                               interp_mode, padding_mode, align_corners)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0,
                               atol=WARP_ATOL)
    outside = ((np.arange(11) + flow[..., 0] < 0)
               | (np.arange(11) + flow[..., 0] > 10))
    assert outside.mean() > 0.2


@pytest.mark.parametrize('size_type,sizes,mode', [
    ('ratio', (0.5, 1.5), 'bilinear'), ('shape', (7, 13), 'bilinear'),
    ('shape', (12, 8), 'nearest')])
def test_resize_flow_matches_jax(size_type, sizes, mode):
    flow = np.random.RandomState(1).randn(2, 2, 10, 9).astype(np.float32)
    got = resize_flow(torch.from_numpy(flow), size_type, sizes, mode)
    want = jsampling.resize_flow(jnp.asarray(nhwc(flow)), size_type,
                                 sizes, mode)
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), rtol=0,
                               atol=WARP_ATOL)


# ---------------------------------------------------------------------- #
# the networks
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('name', ['spynet', 'toflow', 'duf16'])
def test_golden_loads_strictly_and_matches(tmp_path, name):
    """The golden state dict (SpyNet's unwrapped from the fixture's
    ``net.``) through a BasicSR ``.pth`` and ``load_state_dict_file``,
    loaded strictly, on the golden's input."""
    data = np.load(osp.join(GOLDEN_DIR, f'arch_{name}.npz'))
    cfg = json.loads(bytes(data['__config__']).decode())
    state = {k[4:] if k.startswith('net.') else k: torch.from_numpy(data[k])
             for k in data.files if not k.startswith('__')}
    pth = str(tmp_path / 'net.pth')
    torch.save({'params': state}, pth)
    net = define_network(cfg).eval()
    net.load_state_dict(load_state_dict_file(pth), strict=True)
    out = port_run(net, cfg, data['__input__'])
    assert out.shape == data['__output__'].shape
    np.testing.assert_allclose(out, data['__output__'], rtol=0,
                               atol=GOLDEN_ATOL)


@pytest.mark.parametrize('name', list(NETS))
def test_network_matches_jax_both_ways(tmp_path, name):
    """The port's seeded network (BatchNorm statistics drawn) through
    ``convert_state_dict`` into the JAX module; then seeded JAX variables
    written as a native ``.ckpt`` (params and ``batch_stats``) and read by
    the port's ``load_state_dict_file``, loaded strictly (the Conv3d
    kernels, DHWIO -> OIDHW, by their leaf name). Both on the same
    input, within ATOL."""
    cfg, shape = NETS[name]
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    jnet = jax_define(dict(cfg))
    args = jax_args(cfg, x)
    template = jax_template(jnet, args)
    apply = jax.jit(jnet.apply)

    net = vf.seeded_network(cfg, seed=3)
    got = port_run(net, cfg, x)
    want = np.asarray(apply(to_jax(net.state_dict(), template), *args))
    assert np.abs(got).max() > 1e-2
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=ATOL)

    variables = seeded_jax(template, seed=4)
    ckpt = str(tmp_path / 'net_g.ckpt')
    dump_checkpoint(dict(variables), ckpt)
    fresh = define_network(dict(cfg)).eval()
    fresh.load_state_dict(load_state_dict_file(ckpt), strict=True)
    got = port_run(fresh, cfg, x)
    want = np.asarray(apply(variables, *args))
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=ATOL)


def test_duf_refuses_other_depths():
    with pytest.raises(ValueError, match='16, 28, 52'):
        define_network(dict(type='DUF', num_layer=20))


@pytest.mark.parametrize('name', ['toflow', 'duf16'])
def test_train_mode_batchnorm_matches_flax(name):
    """One training-mode forward: outputs normalised by the batch, and the
    running statistics moved as flax moves ``batch_stats`` (biased
    variance; TOFlow's momentum 0.9, DUF's 0.99)."""
    cfg, shape = NETS[name]
    x = np.random.RandomState(5).rand(2, *shape[1:]).astype(np.float32)
    args = jax_args(cfg, x)
    jnet = jax_define(dict(cfg, train=True))
    net = vf.seeded_network(cfg, seed=6)
    variables = to_jax(net.state_dict(), jax_template(jnet, args))
    want, moved = jax.jit(lambda v, *a: jnet.apply(
        v, *a, mutable=['batch_stats']))(variables, *args)
    net.train()
    got = port_run(net, cfg, x)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0,
                               atol=ATOL)
    stats = to_jax(net.state_dict(), jax_template(jnet, args))
    for path, value in jax.tree_util.tree_leaves_with_path(
            moved['batch_stats']):
        mine = stats['batch_stats']
        for k in path:
            mine = mine[k.key]
        np.testing.assert_allclose(mine, np.asarray(value), rtol=0,
                                   atol=STATS_ATOL, err_msg=str(path))
    before = to_jax(vf.seeded_network(cfg, seed=6).state_dict(),
                    jax_template(jnet, args))['batch_stats']
    assert any(not np.allclose(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(before),
        jax.tree_util.tree_leaves(moved['batch_stats'])))


def test_remap_duf16_matches_jax_and_command(tmp_path):
    """The official 16-layer names of the golden's keys back to BasicSR's,
    with ``conv3d_r2``'s rows de-interleaved at x4, equal to the JAX
    package's remap; then the command on an official ``.pth`` (no scale
    given: it is read from the checkpoint), its output loading strictly
    with the same de-interleaved rows."""
    data = np.load(osp.join(GOLDEN_DIR, 'arch_duf16.npz'))
    state = {duf_to_official(k): data[k] for k in data.files
             if not k.startswith('__')}
    got, unmatched = official.remap_duf_16l(state, scale=4)
    want, junmatched = jofficial.remap_duf_16l(state, scale=4)
    assert unmatched == junmatched == []
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert not np.array_equal(got['conv3d_r2.weight'],
                              data['conv3d_r2.weight'])

    pth, out = str(tmp_path / 'official.pth'), str(tmp_path / 'net_g.pth')
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, pth)
    official.main(['--source', 'DUF16', '--pth', pth, '--out', out])
    net = define_network(dict(type='DUF', num_layer=16,
                              adapt_official_weights=True))
    net.load_state_dict(load_state_dict_file(out), strict=True)
    for name in ('weight', 'bias'):
        np.testing.assert_array_equal(
            getattr(net.conv3d_r2, name).detach().numpy(),
            want[f'conv3d_r2.{name}'])


@pytest.mark.parametrize('rows,scale', [(12, 2), (27, 3), (48, 4), (20, None),
                                        (0, None)])
def test_duf_scale_from_conv3d_r2_rows(rows, scale):
    """The command's upscale factor comes from ``conv3d_r2``'s 3 r^2
    rows; any other row count is refused."""
    state = {'conv3d_r2.weight': np.zeros((rows, 2, 1, 1, 1), np.float32)}
    if scale is None:
        with pytest.raises(ValueError, match='3\\*r\\^2'):
            official.duf_scale(state)
    else:
        assert official.duf_scale(state) == scale


# ---------------------------------------------------------------------- #
# the DUF test dataset, the recurrent test dataset
# ---------------------------------------------------------------------- #
def _vid4_like(root, gt_hw=(34, 42), frames=(7, 8)):
    """Two folders of random 8-bit GT frames (sides not multiples of 4)
    and LQ frames of another size; ``reflection_circle`` windows need at
    least ``num_frame`` frames a folder."""
    import cv2
    rng = np.random.RandomState(0)
    for folder, n in zip(('calendar', 'city'), frames):
        for sub, hw in (('GT', gt_hw), ('BIx4', (9, 11))):
            os.makedirs(osp.join(root, sub, folder))
            for t in range(n):
                cv2.imwrite(osp.join(root, sub, folder, f'{t:08d}.png'),
                            rng.randint(0, 256, (*hw, 3), np.uint8))


def _dataset_opt(root, cache, kind='VideoTestDUFDataset', duf=True):
    return dict(name='Vid4', type=kind, dataroot_gt=f'{root}/GT',
                dataroot_lq=f'{root}/BIx4', use_duf_downsampling=duf,
                io_backend=dict(type='disk'), cache_data=cache,
                num_frame=7, padding='reflection_circle', scale=4,
                phase='test')


@pytest.mark.parametrize('duf', [True, False])
@pytest.mark.parametrize('cache', [True, False])
def test_duf_dataset_matches_jax(tmp_path, cache, duf):
    """Every item: LQ windows made by DUF's downsampling from the cached
    GT as it is, or from GT frames cut to multiples of 4 without the
    cache (or the LQ frames without ``use_duf_downsampling``), and the
    GT frame (cut without the cache)."""
    root = str(tmp_path)
    _vid4_like(root)
    opt = _dataset_opt(root, cache, duf=duf)
    mine, theirs = create_dataset(opt), JaxDUFDataset(dict(opt))
    assert len(mine) == len(theirs) == 15
    for i in range(len(mine)):
        a, b = mine[i], theirs[i]
        for k in ('folder', 'idx', 'border', 'lq_path'):
            assert a[k] == b[k], k
        assert a['lq'].dtype == torch.float32
        for k in ('lq', 'gt'):
            np.testing.assert_allclose(nhwc(a[k].numpy()), b[k], rtol=0,
                                       atol=DATA_ATOL, err_msg=f'{i} {k}')
    gt_hw = tuple(mine[0]['gt'].shape[1:])
    assert gt_hw == ((34, 42) if cache else (32, 40))
    if duf:
        assert tuple(mine[0]['lq'].shape[2:]) == ((9, 11) if cache
                                                   else (8, 10))


def test_duf_downsample_matches_jax():
    x = np.random.RandomState(9).rand(2, 3, 3, 20, 26).astype(np.float32)
    for scale in (2, 3, 4):
        got = duf_downsample(torch.from_numpy(x), 13, scale)
        want = jax_duf_downsample(np.moveaxis(x, 2, -1), 13, scale)
        np.testing.assert_array_equal(np.moveaxis(got.numpy(), 2, -1), want)
        got = duf_downsample(torch.from_numpy(x[0]), 13, scale)
        want = jax_duf_downsample(np.moveaxis(x[0], 1, -1), 13, scale)
        np.testing.assert_array_equal(np.moveaxis(got.numpy(), 1, -1), want)
    with pytest.raises(ValueError):
        duf_downsample(torch.from_numpy(x), 13, 5)


def test_recurrent_dataset_matches_jax(tmp_path):
    root = str(tmp_path)
    _vid4_like(root)
    opt = _dataset_opt(root, True, kind='VideoRecurrentTestDataset')
    mine, theirs = create_dataset(opt), JaxRecurrent(dict(opt))
    assert len(mine) == len(theirs) == 2
    for i in range(2):
        a, b = mine[i], theirs[i]
        assert a['folder'] == b['folder']
        for k in ('lq', 'gt'):
            np.testing.assert_allclose(nhwc(a[k].numpy()), b[k], rtol=0,
                                       atol=DATA_ATOL)
    with pytest.raises(NotImplementedError):
        create_dataset(dict(opt, cache_data=False))[0]


# ---------------------------------------------------------------------- #
# the shipped Vid4 test YAMLs through the test CLI
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('name', list(vf.TEST_YML))
def test_shipped_yaml_psnr_matches_jax(tmp_path, monkeypatch, name):
    """``options/test/{DUF,TOF}/*.yml`` as shipped (DUF-52 and TOFlow at
    full width) through ``edvr_tpu_torch.test.main --device cpu`` on a
    seeded Vid4 tree (7 frames of 32x48 GT: the YAMLs' relative
    ``datasets/Vid4`` paths under the working directory), only
    ``pretrain_network_g`` forced to a seeded ``.pth``: every frame's PSNR
    within PSNR_ATOL dB of the table computed from the JAX network's
    outputs on the same windows and weights, with the JAX package's
    ``tensor2img`` and ``calculate_psnr``."""
    monkeypatch.chdir(tmp_path)
    vf.write_vid4_tree('datasets/Vid4', frames=7, gt_hw=(32, 48))
    yml = osp.join(REPO, 'options', 'test', vf.TEST_YML[name])
    import yaml
    with open(yml) as f:
        shipped = yaml.safe_load(f)
    pth = vf.seeded_pth(shipped['network_g'], str(tmp_path / 'net.pth'))
    from edvr_tpu_torch.test import INFERENCE_CUDNN_ENV, main
    for key in INFERENCE_CUDNN_ENV:  # main sets them; undone after the test
        monkeypatch.delenv(key, raising=False)
    model = main(args=['-opt', yml, '--device', 'cpu', '--force_yml',
                       f'path:pretrain_network_g={pth}'])
    assert model.opt['network_g'] == shipped['network_g']
    assert model.opt['path']['strict_load_g'] is True
    table = model.metric_results['calendar'][:, 0]
    assert table.shape == (7,) and np.isfinite(table).all()

    dataset = create_dataset(model.opt['datasets']['test_1'])
    jnet = jax_define(dict(shipped['network_g']))
    first = nhwc(dataset[0]['lq'][None].numpy())
    variables = to_jax(model.net_g.state_dict(),
                       jax_template(jnet, (jnp.asarray(first),)))
    apply = jax.jit(jnet.apply)
    crop = shipped['val']['metrics']['psnr']['crop_border']
    want = []
    for i in range(len(dataset)):
        item = dataset[i]
        out = apply(variables, jnp.asarray(nhwc(item['lq'][None].numpy())))
        want.append(jax_psnr(jax_tensor2img(np.asarray(out)[0]),
                             jax_tensor2img(nhwc(item['gt'].numpy())),
                             crop, test_y_channel=True))
    np.testing.assert_allclose(table, want, rtol=0, atol=PSNR_ATOL)
    saved = os.listdir(osp.join(model.opt['path']['visualization'], 'Vid4',
                                'calendar'))
    assert len(saved) == 7


def test_clip_mode_falls_back_for_tof(tmp_path, monkeypatch):
    """``val.clip_mode`` with a non-EDVR network (the TOF YAML's TOFlow)
    warns and runs the per-window protocol, as the JAX package does: the
    same PSNR table as without it."""
    import logging

    from edvr_tpu_torch.test import INFERENCE_CUDNN_ENV, main
    from edvr_tpu_torch.utils import get_root_logger
    monkeypatch.chdir(tmp_path)
    for key in INFERENCE_CUDNN_ENV:
        monkeypatch.delenv(key, raising=False)
    vf.write_vid4_tree('datasets/Vid4', frames=7, gt_hw=(32, 48))
    yml = osp.join(REPO, 'options', 'test', vf.TEST_YML['TOF'])
    pth = vf.seeded_pth(dict(type='TOFlow', adapt_official_weights=True),
                        str(tmp_path / 'net.pth'))
    args = ['-opt', yml, '--device', 'cpu', '--force_yml',
            f'path:pretrain_network_g={pth}']
    plain = main(args=args).metric_results['calendar']

    warned = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warned.append(record.getMessage())
    get_root_logger().addHandler(handler)
    try:
        clip = main(args=[*args, 'val:clip_mode=true'])
    finally:
        get_root_logger().removeHandler(handler)
    assert any('falling back to the per-window protocol' in m
               for m in warned), warned
    np.testing.assert_array_equal(clip.metric_results['calendar'], plain)
