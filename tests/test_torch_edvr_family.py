"""The rest of the EDVR family in the port, against the JAX package and the
golden fixtures: the pre-deblur module and HR input (``with_predeblur``,
``hr_in``), the staged forward and pyramid clip mode, the per-window
validation protocol with its clip-mode fallback and Vimeo90K naming,
``VideoTestVimeo90KDataset``, the alignment switches of ``DCNv2Pack``, the
official-checkpoint remap with its command, and every shipped EDVR test
YAML through ``python -m edvr_tpu_torch.test --device cpu``.

JAX runs on the CPU with float32 matmuls pinned (the repo-root conftest),
as its own tests run; weights cross over through
``jax_params_to_state_dict``. Tolerances are those of
tests/test_arch_parity.py and tests/test_torch_edvr.py (3e-4 absolute).
"""

import json
import logging
import os
import os.path as osp
import subprocess
import sys
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from edvr_tpu.archs import edvr_arch as jarch
from edvr_tpu.convert import official as jofficial
from edvr_tpu.data.video_test_dataset import \
    VideoTestVimeo90KDataset as JaxVimeo90K
from edvr_tpu.models.video_base_model import \
    VideoBaseModel as JaxVideoBaseModel
from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.archs import edvr_arch
from edvr_tpu_torch.archs.arch_util import DCNv2Pack, WarpAlignPack
from edvr_tpu_torch.convert import jax_params_to_state_dict, official
from edvr_tpu_torch.data import create_dataset
from edvr_tpu_torch.models.video_base_model import VideoBaseModel
from edvr_tpu_torch.ops import dcn
from edvr_tpu_torch.utils import get_root_logger

from test_torch_cli import _make_clips
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
GOLDEN_DIR = osp.join(REPO, 'tests', 'data', 'golden')
ATOL = 3e-4
# pyramid against window mode in the port: the same ops on the same
# windows, batched otherwise
MODE_TOL = 1e-5
GOLDENS = ['predeblur', 'hrin', 'tsa', 'notsa']
SMALL = dict(num_feat=16, num_frame=5, deformable_groups=2,
             num_extract_block=2, num_reconstruct_block=2)
# hr_in needs the pre-deblur module's stride convs (see
# test_hr_in_needs_predeblur), so "with hr_in" is "with both"
VARIANTS = {'predeblur': dict(with_predeblur=True),
            'hrin': dict(with_predeblur=True, hr_in=True)}
T = 7


def _golden(name):
    data = np.load(osp.join(GOLDEN_DIR, f'arch_edvr_{name}.npz'))
    state = {k: torch.from_numpy(data[k]) for k in data.files
             if not k.startswith('__')}
    return (json.loads(bytes(data['__config__']).decode()), state,
            data['__input__'], data['__output__'])


def _seeded_jax_params(model, sample, seed=0):
    """Every parameter of ``model`` drawn from a numpy seed (N(0, 1/fan_in)),
    so the offsets are non-zero and the DCN samples move; shapes from
    ``eval_shape`` of the model's init."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample)
    rng = np.random.RandomState(seed)

    def draw(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 16
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes['params'])


@pytest.fixture(scope='module')
def family_jax():
    """Per variant: seeded JAX params, a 7-frame clip and the JAX
    package's clip output in each mode at win_batch 3 (which does not
    divide 7)."""
    out = {}
    for name, kw in VARIANTS.items():
        model = jarch.EDVR(**SMALL, **kw)
        hw = 32 if kw.get('hr_in') else 12
        params = _seeded_jax_params(model, jnp.zeros((1, 5, hw, hw, 3)))
        clip = np.random.RandomState(1).rand(T, hw, hw, 3).astype(
            np.float32)
        idx = jarch.clip_window_indices(T, 5, 'reflection_circle')
        want = {mode: np.asarray(jarch.make_clip_restore_fn(
            model, win_batch=3, mode=mode)({'params': params},
                                           jnp.asarray(clip),
                                           jnp.asarray(idx)))
            for mode in ('window', 'pyramid')}
        out[name] = (params, clip, want)
    return out


def _port_net(kw, params):
    net = define_network(dict(type='EDVR', **SMALL, **kw)).eval()
    net.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return net


@pytest.mark.parametrize('name', GOLDENS)
def test_golden_edvr_family(name):
    """BasicSR's own outputs of EDVR with predeblur, with HR input and
    predeblur, with and without TSA, from their state dicts loaded
    strictly."""
    config, state, x, y = _golden(name)
    net = define_network(config)
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x))
    assert out.shape == y.shape
    np.testing.assert_allclose(out.numpy(), y, atol=ATOL, rtol=0)


@pytest.mark.parametrize('name', GOLDENS)
def test_jax_scopes_map_to_golden_keys(name):
    """``jax_params_to_state_dict`` of the JAX package's parameter tree has
    exactly the golden state dict's keys and shapes (the pre-deblur's
    ``resblock_l1_<i>`` scopes become ``resblock_l1.<i>``)."""
    config, state, x, _ = _golden(name)
    model = jarch.EDVR(**{k: v for k, v in config.items() if k != 'type'})
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros(np.transpose(x, (0, 1, 3, 4, 2))
                                      .shape))
    got = jax_params_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes['params']))
    assert sorted(got) == sorted(state)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in state.items()}


@pytest.mark.parametrize('mode', ['window', 'pyramid'])
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_family_clip_matches_jax(family_jax, variant, mode):
    """Whole-clip restoration of EDVR with predeblur and with HR input, in
    both clip modes, against the JAX package's ``make_clip_restore_fn`` in
    the same mode, both at a window batch (3) that does not divide T (7)."""
    win_batch = 3
    params, clip, want = family_jax[variant]
    net = _port_net(VARIANTS[variant], params)
    idx = edvr_arch.clip_window_indices(T, 5, 'reflection_circle')
    before = dict(dcn.LAUNCHES)
    got = edvr_arch.make_clip_restore_fn(net, win_batch=win_batch,
                                         mode=mode)(
        torch.from_numpy(clip).permute(0, 3, 1, 2), idx)
    assert dcn.LAUNCHES == before  # CPU: plain DCN, no kernel
    hw = clip.shape[1] * (1 if VARIANTS[variant].get('hr_in') else 4)
    assert got.shape == (T, 3, hw, hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want[mode],
                               atol=ATOL, rtol=0)


PORT_VARIANTS = {'plain': {}, 'notsa': dict(with_tsa=False), **VARIANTS}
_window_outputs = {}


def _window_case(variant):
    """A seeded port EDVR of ``variant`` (offset convs drawn non-zero), a
    6-frame clip, its window table and its window-mode output (computed
    once per variant)."""
    if variant not in _window_outputs:
        kw = PORT_VARIANTS[variant]
        torch.manual_seed(3)
        net = define_network(dict(type='EDVR', **SMALL, **kw)).eval()
        with torch.no_grad():
            for mod in net.modules():
                if hasattr(mod, 'conv_offset'):
                    mod.conv_offset.weight.normal_(0, 0.05)
        hw = 32 if kw.get('hr_in') else 12
        clip = torch.rand(6, 3, hw, hw, generator=torch.Generator()
                          .manual_seed(4))
        idx = edvr_arch.clip_window_indices(6, 5, 'reflection_circle')
        _window_outputs[variant] = (
            net, clip, idx, edvr_arch.make_clip_restore_fn(net)(clip, idx))
    return _window_outputs[variant]


@pytest.mark.parametrize('win_batch', [2, 4])
@pytest.mark.parametrize('variant', list(PORT_VARIANTS))
def test_pyramid_equals_window_mode(variant, win_batch):
    """In the port, pyramid mode (each frame's pyramid once per clip,
    windows of features) gives window mode's output, for window batches
    that divide T (6) and that do not."""
    net, clip, idx, window = _window_case(variant)
    pyramid = edvr_arch.make_clip_restore_fn(net, win_batch=win_batch,
                                             mode='pyramid')(clip, idx)
    torch.testing.assert_close(pyramid, window, atol=MODE_TOL, rtol=0)


def test_pyramid_held_in_bf16():
    """A clip pyramid held in bf16 (``store_dtype``): the features rounded,
    computed on in float32, no more."""
    net, clip, idx, window = _window_case('plain')
    held = edvr_arch.make_clip_restore_fn(
        net, win_batch=4, mode='pyramid', store_dtype=torch.bfloat16)(
        clip, idx)
    assert held.dtype == torch.float32
    assert 0 < (held - window).abs().max() < 0.05


def test_clip_restore_refuses_unknown_mode():
    net = define_network(dict(type='EDVR', **SMALL))
    with pytest.raises(ValueError, match='unknown clip mode'):
        edvr_arch.make_clip_restore_fn(net, mode='frames')
    with pytest.raises(ValueError, match='unknown clip mode'):
        jarch.make_clip_restore_fn(jarch.EDVR(**SMALL), mode='frames')


def test_hr_in_needs_predeblur():
    """``hr_in`` without the pre-deblur module fails in the JAX package (its
    L1 stays at the HR size and the reshape to h/4 fails); the port refuses
    the configuration when it is built."""
    with pytest.raises(ValueError, match='hr_in needs with_predeblur'):
        define_network(dict(type='EDVR', **SMALL, hr_in=True))
    with pytest.raises(TypeError, match='reshape'):
        jax.eval_shape(jarch.EDVR(**SMALL, hr_in=True).init,
                       jax.random.PRNGKey(0), jnp.zeros((1, 5, 32, 32, 3)))


def test_hr_in_size_check():
    net = define_network(dict(type='EDVR', **SMALL, **VARIANTS['hrin']))
    with pytest.raises(ValueError, match='multiples of 16'):
        net(torch.zeros(1, 5, 3, 40, 40))


# ---------------------------------------------------------------------- #
# official checkpoints
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('name', GOLDENS + ['m_full'])
def test_official_remap_matches_jax(name):
    """The port's copy of ``edvr_to_official`` and ``remap_edvr`` gives the
    JAX package's result on every golden key, and the remap inverts the
    renaming."""
    data = np.load(osp.join(GOLDEN_DIR, f'arch_edvr_{name}.npz'))
    keys = [k for k in data.files if not k.startswith('__')]
    names = {k: official.edvr_to_official(k) for k in keys}
    assert names == {k: jofficial.edvr_to_official(k) for k in keys}
    assert None not in names.values()
    off = {v: k for k, v in names.items()}
    off['junk.weight'] = 'junk'
    renamed, unmatched = official.remap_edvr(off)
    assert (renamed, unmatched) == jofficial.remap_edvr(off)
    assert unmatched == ['junk.weight']
    assert renamed == {k: k for k in keys}


@pytest.mark.parametrize('name', ['predeblur', 'hrin', 'tsa'])
def test_official_round_trip_through_command(tmp_path, name):
    """golden -> official .pth -> ``python -m edvr_tpu_torch.convert.official``
    -> BasicSR .pth -> the port, strictly loaded, gives the golden
    output."""
    config, state, x, y = _golden(name)
    off = {official.edvr_to_official(k): v for k, v in state.items()}
    off['junk.weight'] = torch.zeros(1)
    src, dst = str(tmp_path / 'official.pth'), str(tmp_path / 'net_g.pth')
    torch.save({'module.' + k: v for k, v in off.items()}, src)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get('PYTHONPATH', '')]))
    proc = subprocess.run(
        [sys.executable, '-m', 'edvr_tpu_torch.convert.official',
         '--source', 'EDVR', '--pth', src, '--out', dst], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "['junk.weight']" in proc.stderr
    from edvr_tpu_torch.convert import load_state_dict_file
    net = define_network(config)
    net.load_state_dict(load_state_dict_file(dst), strict=True)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), y, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------- #
# Vimeo90K and per-window validation
# ---------------------------------------------------------------------- #
def _make_vimeo(root, seqs=('00001/0266', '00002/0001', '00003/0042'),
                lq_hw=(16, 16), scale=4):
    """Synthetic Vimeo90K septuplets (im1..im7 LQ, im4 GT) and a meta-info
    file listing them."""
    rng = np.random.RandomState(5)
    h, w = lq_hw
    for seq in seqs:
        os.makedirs(osp.join(root, 'lq', seq))
        os.makedirs(osp.join(root, 'gt', seq))
        for i in range(1, 8):
            gt = rng.randint(0, 256, (h * scale, w * scale, 3), np.uint8)
            cv2.imwrite(osp.join(root, 'lq', seq, f'im{i}.png'),
                        cv2.resize(gt, (w, h), interpolation=cv2.INTER_AREA))
            if i == 4:
                cv2.imwrite(osp.join(root, 'gt', seq, 'im4.png'), gt)
    meta = osp.join(root, 'meta_info.txt')
    with open(meta, 'w') as f:
        f.writelines(f'{s} (256,448,3)\n' for s in seqs)
    return meta


def _vimeo_opt(root, meta, num_frame=7, **kw):
    return dict(dict(name='Vimeo90K', type='VideoTestVimeo90KDataset',
                     phase='test', dataroot_gt=f'{root}/gt',
                     dataroot_lq=f'{root}/lq', meta_info_file=meta,
                     io_backend=dict(type='disk'), cache_data=False,
                     num_frame=num_frame, padding='reflection_circle'), **kw)


@pytest.mark.parametrize('num_frame', [7, 5, 3])
def test_vimeo90k_dataset_matches_jax(tmp_path, num_frame):
    """The same data_info, arrays (the port's NCHW, JAX's NHWC) and item
    dicts as the JAX package's VideoTestVimeo90KDataset."""
    root = str(tmp_path / 'vimeo')
    meta = _make_vimeo(root)
    opt = _vimeo_opt(root, meta, num_frame)
    ours, ref = create_dataset(opt), JaxVimeo90K(dict(opt))
    assert len(ours) == len(ref) == 3
    assert ours.data_info == ref.data_info
    assert ours.data_info['lq_path'][0][0].endswith(
        f'im{1 + (7 - num_frame) // 2}.png')
    for i in range(3):
        a, b = ours[i], ref[i]
        assert a['lq'].shape == (num_frame, 3, 16, 16)
        np.testing.assert_array_equal(a['lq'].permute(0, 2, 3, 1).numpy(),
                                      b['lq'])
        np.testing.assert_array_equal(a['gt'].permute(1, 2, 0).numpy(),
                                      b['gt'])
        assert [a[k] for k in ('folder', 'idx', 'border', 'lq_path')] \
            == [b[k] for k in ('folder', 'idx', 'border', 'lq_path')]
    with pytest.raises(NotImplementedError, match='cache_data'):
        create_dataset(dict(opt, cache_data=True))
    with pytest.raises(NotImplementedError, match='cache_data'):
        JaxVimeo90K(dict(opt, cache_data=True))


def _val_opt(tmp_path, dataset_opt, network, **val):
    from edvr_tpu_torch.utils.options import parse_dict
    opt = {'name': 'val_run', 'model_type': 'VideoBaseModel', 'scale': 4,
           'num_gpu': 1, 'manual_seed': 0,
           'datasets': {'test_1': dataset_opt},
           'network_g': dict(type='EDVR', **network),
           'path': dict(pretrain_network_g=None, strict_load_g=True),
           'val': dict(dict(save_img=False, suffix=None, metrics=dict(
               psnr=dict(type='calculate_psnr', crop_border=0,
                         test_y_channel=False))), **val)}
    opt = parse_dict(opt, is_train=False, root=str(tmp_path))
    opt['device'] = 'cpu'
    return opt


def _validate(opt, dataset):
    from edvr_tpu_torch.data import create_dataloader
    from edvr_tpu_torch.models import create_model
    model = create_model(opt)
    model.validation(create_dataloader(dataset, opt['datasets']['test_1']),
                     opt['name'], None, save_img=opt['val']['save_img'])
    return model


class _Warnings(logging.Handler):
    """Collects the port's logger warnings."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        get_root_logger().addHandler(self)
        return self.messages

    def __exit__(self, *exc):
        get_root_logger().removeHandler(self)


@pytest.mark.parametrize('cache_data', [True, False])
def test_per_window_table_equals_clip_table(tmp_path, cache_data):
    """On a two-folder VideoTestDataset the per-window protocol (one item,
    one forward) fills the per-folder x per-frame PSNR table that
    whole-clip evaluation fills."""
    root = str(tmp_path / 'reds')
    _make_clips(root, frames=5)
    dataset_opt = dict(name='REDS4', type='VideoTestDataset', phase='test',
                       dataroot_gt=f'{root}/gt', dataroot_lq=f'{root}/lq',
                       meta_info_file=None, io_backend=dict(type='disk'),
                       cache_data=cache_data, num_frame=5,
                       padding='reflection_circle')
    dataset = create_dataset(dataset_opt)
    net = dict(SMALL, num_feat=8)
    per_window = _validate(_val_opt(tmp_path, dataset_opt, net), dataset)
    clip = _validate(_val_opt(tmp_path, dataset_opt, net, clip_mode=True),
                     dataset)
    assert set(per_window.metric_results) == {'000', '011'}
    for folder, table in clip.metric_results.items():
        assert table.shape == (5, 1) and (table > 0).all()
        np.testing.assert_allclose(per_window.metric_results[folder], table,
                                   rtol=1e-6)


def test_clip_mode_falls_back_to_per_window(tmp_path):
    """``val.clip_mode`` with a dataset that has no whole folders
    (Vimeo90K) warns and runs the per-window protocol, as the JAX package
    does (``edvr_tpu/models/video_base_model.py:93-104``); the per-window
    result equals the direct forward of the same window."""
    root = str(tmp_path / 'vimeo')
    dataset_opt = _vimeo_opt(root, _make_vimeo(root))
    dataset = create_dataset(dataset_opt)
    opt = _val_opt(tmp_path, dataset_opt, dict(SMALL, num_frame=7),
                   clip_mode=True, save_img=True)
    with _Warnings() as warned:
        model = _validate(opt, dataset)
    assert any('falling back to the per-window protocol' in m
               for m in warned), warned
    table = model.metric_results['vimeo90k']
    assert table.shape == (3, 1) and np.isfinite(table).all()
    vis = osp.join(opt['path']['visualization'], 'Vimeo90K', 'vimeo90k')
    assert sorted(os.listdir(vis)) == [
        '00001_0266_im4_val_run.png', '00002_0001_im4_val_run.png',
        '00003_0042_im4_val_run.png']
    from edvr_tpu_torch.metrics import calculate_psnr
    from edvr_tpu_torch.utils import tensor2img
    item = dataset[1]
    with torch.no_grad():
        out = model.net_g(item['lq'][None])
    assert calculate_psnr(tensor2img(out), tensor2img(item['gt']), 0) == \
        pytest.approx(float(table[1, 0]), rel=1e-6)


@pytest.mark.parametrize('suffix', [None, 'tag'])
@pytest.mark.parametrize('dataset_name,lq_path', [
    ('Vimeo90K', 'lq/00001/0266/im4.png'),
    ('vimeo90k_small', '/data/seq/00007/0101/im4.png'),
    ('REDS4', '/data/lq/000/00000007.png')])
def test_save_result_img_naming_matches_jax(tmp_path, monkeypatch, suffix,
                                            dataset_name, lq_path):
    """``_save_result_img`` writes where the JAX package's writes, with its
    Vimeo90K ``<sequence>_<clip>_<frame>`` names."""
    written = []

    def fake_imwrite(img, path, *a, **k):
        written.append(path)

    from edvr_tpu.models import video_base_model as jvbm
    from edvr_tpu_torch.models import video_base_model as tvbm
    monkeypatch.setattr(jvbm, 'imwrite', fake_imwrite)
    monkeypatch.setattr(tvbm, 'imwrite', fake_imwrite)
    opt = {'name': 'run', 'is_train': False, 'val': {'suffix': suffix},
           'path': {'visualization': str(tmp_path)}}
    img = np.zeros((4, 4, 3), np.uint8)
    for cls in (VideoBaseModel, JaxVideoBaseModel):
        cls._save_result_img(types.SimpleNamespace(opt=opt), img,
                             dataset_name, 'folder', lq_path)
    assert written[0] == written[1]
    if 'vimeo' in dataset_name.lower():
        parts = lq_path.split('/')
        assert osp.basename(written[0]).startswith(
            f'{parts[-3]}_{parts[-2]}_im4_')


# ---------------------------------------------------------------------- #
# alignment switches
# ---------------------------------------------------------------------- #
def _pack_case(cls):
    torch.manual_seed(6)
    pack = cls(8, 8, 3, padding=1, deformable_groups=2)
    with torch.no_grad():
        pack.conv_offset.weight.normal_(0, 0.2)
        pack.conv_offset.bias.normal_(0, 1)
    x = torch.randn(2, 8, 7, 9)
    feat = torch.randn(2, 8, 7, 9)
    return pack, x, feat


@pytest.mark.parametrize('cls', [DCNv2Pack, WarpAlignPack])
def test_no_align_switch(monkeypatch, cls):
    """``EDVR_TPU_PCD_NO_ALIGN=1``: the pack computes its DCN with zero
    offsets and the learned mask, and no gradient reaches the rows of
    ``conv_offset`` that make the offsets; the mask rows still learn."""
    pack, x, feat = _pack_case(cls)
    moved = pack(x, feat)
    monkeypatch.setenv('EDVR_TPU_PCD_NO_ALIGN', '1')
    out = pack(x, feat)
    assert (out - moved).abs().max() > 1e-3
    dg = 2
    k_off = 2 * dg * (9 if cls is DCNv2Pack else 1)
    mask = torch.sigmoid(pack.conv_offset(feat)[:, k_off:])
    if cls is DCNv2Pack:
        want = dcn.modulated_deform_conv_plain(
            x, torch.zeros(2, k_off, 7, 9), mask, pack.weight, pack.bias,
            1, 1, 1, 1, dg)
    else:  # the identity warp, masked, then the dense conv
        m = mask.repeat_interleave(4, dim=1)
        want = torch.nn.functional.conv2d(x * m, pack.weight, pack.bias,
                                          1, 1)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    out.square().sum().backward()
    g = pack.conv_offset.weight.grad
    if cls is DCNv2Pack:
        offset_rows, mask_rows = g[:k_off], g[k_off:]
    else:  # channels (dy_g, dx_g) are the first 2 * dg outputs
        offset_rows, mask_rows = g[:2 * dg], g[2 * dg:]
    assert offset_rows.abs().max() == 0
    assert mask_rows.abs().max() > 0
    assert torch.isfinite(g).all()


@pytest.mark.parametrize('bias,env,warns', [
    (60., '1', True), (-60., '1', True), (1., '1', False), (60., None, False)])
def test_monitor_offsets_switch(monkeypatch, bias, env, warns):
    """``EDVR_TPU_MONITOR_OFFSETS=1`` warns when the mean |offset| exceeds
    50 and is silent below it; unset, it is silent."""
    pack, x, feat = _pack_case(DCNv2Pack)
    with torch.no_grad():
        pack.conv_offset.weight.zero_()
        pack.conv_offset.bias.fill_(bias)
    if env:
        monkeypatch.setenv('EDVR_TPU_MONITOR_OFFSETS', env)
    with _Warnings() as warned, torch.no_grad():
        pack(x, feat)
    hits = [m for m in warned if 'larger than 50' in m]
    assert bool(hits) == warns, warned
    if warns:
        assert f'Offset abs mean is {abs(bias)}' in hits[0]


# ---------------------------------------------------------------------- #
# the shipped test YAMLs through the test CLI
# ---------------------------------------------------------------------- #
YAMLS = ['test_EDVR_M_x4_SR_REDS.yml', 'test_EDVR_L_x4_SR_REDS.yml',
         'test_EDVR_L_x4_SR_Vid4.yml', 'test_EDVR_L_x4_SRblur_REDS.yml',
         'test_EDVR_L_deblur_REDS.yml', 'test_EDVR_L_deblurcomp_REDS.yml',
         'test_EDVR_L_x4_SR_Vimeo90K.yml']


@pytest.mark.parametrize('yml', YAMLS)
def test_shipped_yaml_runs_on_cpu(tmp_path, monkeypatch, yml):
    """Every shipped EDVR test YAML runs through
    ``python -m edvr_tpu_torch.test --device cpu`` at its own width, from
    a seeded checkpoint loaded strictly, on tiny synthetic data (16x16 LQ,
    64x64 for HR input); only the dataset paths and the checkpoint path
    are overridden."""
    path = osp.join(REPO, 'options', 'test', 'EDVR', yml)
    with open(path) as f:
        opt = yaml.safe_load(f)
    ds, net = opt['datasets']['test_1'], opt['network_g']
    root = str(tmp_path / 'data')
    if ds['type'] == 'VideoTestVimeo90KDataset':
        meta = _make_vimeo(root, seqs=('00001/0001', '00002/0002'))
        folders, frames = {'vimeo90k': 2}, 1
    else:
        # reflection_circle windows need num_frame frames per clip
        folders, frames = ('000',), ds['num_frame']
        _make_clips(root, clips=folders, frames=frames,
                    scale=1 if net['hr_in'] else 4,
                    lq_hw=64 if net['hr_in'] else 16)
        meta = str(tmp_path / 'meta_info.txt')
        with open(meta, 'w') as f:
            f.writelines(f'{c} {frames} (64,64,3)\n' for c in folders)
        folders = {c: frames for c in folders}
    torch.manual_seed(7)
    seeded = define_network(dict(net))
    with torch.no_grad():  # the DCNs sample off the grid
        for mod in seeded.modules():
            if isinstance(mod, DCNv2Pack):
                mod.conv_offset.weight.normal_(0, 0.02)
    ckpt = str(tmp_path / 'net_g.pth')
    torch.save({'params': seeded.state_dict()}, ckpt)
    force = [f'datasets:test_1:dataroot_gt={root}/gt',
             f'datasets:test_1:dataroot_lq={root}/lq',
             f'path:pretrain_network_g={ckpt}']
    if ds.get('meta_info_file') or ds['type'] == 'VideoTestVimeo90KDataset':
        force.append(f'datasets:test_1:meta_info_file={meta}')
    monkeypatch.chdir(tmp_path)
    from edvr_tpu_torch.test import INFERENCE_CUDNN_ENV, main
    for key in INFERENCE_CUDNN_ENV:  # main sets them; undone after the test
        monkeypatch.delenv(key, raising=False)
    model = main(args=['-opt', path, '--device', 'cpu', '--force_yml',
                       *force])
    assert model.device == torch.device('cpu')
    assert model.opt['path']['strict_load_g'] is True
    for name, p in seeded.state_dict().items():
        assert torch.equal(model.net_g.state_dict()[name], p), name
    assert {f: t.shape for f, t in model.metric_results.items()} == \
        {f: (n, 1) for f, n in folders.items()}
    for table in model.metric_results.values():
        assert np.isfinite(table).all() and (table > 0).all()
    vis = osp.join(model.opt['path']['visualization'], ds['name'])
    saved = sorted(os.listdir(osp.join(vis, next(iter(folders)))))
    assert len(saved) == next(iter(folders.values()))
    img = cv2.imread(osp.join(vis, next(iter(folders)), saved[0]))
    assert img.shape == (64, 64, 3)


@pytest.mark.parametrize('preset', [None, '512'])
def test_test_cli_applies_inference_cudnn_policy(tmp_path, preset):
    """The test CLI sets its cuDNN policy (the v7 API, the workspace capped
    at 1 GiB) before it parses its options, so before any convolution; a
    value already in the environment is kept."""
    code = (
        'import os\n'
        'import edvr_tpu_torch.test as t\n'
        'def stop(**kw):\n'
        '    print(os.environ.get("TORCH_CUDNN_V8_API_DISABLED"), '
        'os.environ.get("CUDNN_CONV_WSCAP_DBG"))\n'
        '    raise SystemExit(0)\n'
        't.parse_options = stop\n'
        't.main([])\n')
    env = {k: v for k, v in os.environ.items()
           if k not in ('TORCH_CUDNN_V8_API_DISABLED', 'CUDNN_CONV_WSCAP_DBG')}
    env['PYTHONPATH'] = os.pathsep.join([REPO, env.get('PYTHONPATH', '')])
    if preset:
        env['CUDNN_CONV_WSCAP_DBG'] = preset
    proc = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ['1', preset or '1024']
