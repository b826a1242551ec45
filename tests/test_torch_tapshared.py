"""The port's tap_shared alignment (``WarpAlignPack``, EDVR
``align_variant: tap_shared``) against the JAX package, on the CPU at
pinned float32 matmul precision (root conftest).

Parameters are drawn with numpy from a seed in the JAX tree's shapes and
carried into the port by ``convert.jax_params_to_state_dict`` with a strict
load, which pins the port's parameter names. The warp is a K=1 DCN, so it
is checked on both DCN routes: the default one (the port's plain DCN, the
JAX package's default) and the packed one (``EDVR_TPU_DCN_PALLAS=1``, the
JAX blend kernel interpreted).
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edvr_tpu.archs import arch_util as jarch_util
from edvr_tpu.archs import edvr_arch as jarch
from edvr_tpu.models.losses import CharbonnierLoss as JaxCharbonnier
from edvr_tpu.ops import dcn_pallas
from edvr_tpu_torch.archs import arch_util, define_network
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.ops import dcn
from edvr_tpu_torch.utils.options import parse
from test_torch_train import _reds_tree
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
YML = osp.join(REPO, 'options', 'train', 'EDVR',
               'train_EDVR_M_x4_SR_REDS_tapshared.yml')
ATOL = 1e-5      # one WarpAlignPack, f32 both sides
NET_ATOL = 3e-4  # a whole EDVR, as tests/test_torch_edvr.py
STEP_TOL = 1e-4  # one step's gradients, as tests/test_torch_grad.py
TINY = dict(num_in_ch=3, num_out_ch=3, num_feat=16, num_frame=5,
            deformable_groups=2, num_extract_block=1,
            num_reconstruct_block=1, center_frame_idx=None, hr_in=False,
            with_predeblur=False, with_tsa=True, align_variant='tap_shared')


@pytest.fixture(params=['default', 'packed'])
def route(request, monkeypatch):
    if request.param == 'packed':
        monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
        monkeypatch.setenv('EDVR_TPU_DCN_PALLAS_INTERPRET', '1')
        # the kernel's trace count only moves on a trace: start untraced
        dcn_pallas.blend_matmul_group.clear_cache()
    return request.param


def _draw(shapes, seed, offset_scale):
    """Every leaf of a flax parameter tree from a numpy seed; conv_offset's
    too, so the warp moves (offsets of a few pixels)."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        if 'conv_offset' in name:
            return (rng.randn(*s.shape) * offset_scale).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 16
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _state(params):
    return jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           params))


def _check_blend(route, before):
    if route == 'packed':
        assert dcn_pallas.TRACE_COUNTS['blend'] > before, 'blend not traced'


@pytest.mark.parametrize('cin,dg', [(16, 4), (64, 8)])
def test_warp_align_pack_matches_jax(route, cin, dg):
    before = dcn_pallas.TRACE_COUNTS['blend']
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 20, cin).astype(np.float32)
    feat = rng.randn(2, 12, 20, cin).astype(np.float32)
    jm = jarch_util.WarpAlignPack(24, 3, padding=1, deformable_groups=dg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, feat)
    params = _draw(shapes['params'], 1, offset_scale=0.3)
    want = np.asarray(jm.apply({'params': params}, x, feat))
    _check_blend(route, before)

    m = arch_util.WarpAlignPack(cin, 24, 3, padding=1, deformable_groups=dg)
    m.load_state_dict(_state(params), strict=True)
    assert m.conv_offset.weight.shape == (dg * 3, cin, 3, 3)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = m(nchw(x), nchw(feat)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fresh_warp_align_pack_is_conv_of_half_input():
    """Zero-initialised conv_offset: identity warp, mask 0.5, so the module
    is the dense conv of 0.5 * x (the JAX module's start-as-plain-conv
    contract, tests/test_align_codesign.py)."""
    torch.manual_seed(0)
    m = arch_util.WarpAlignPack(16, 8, 3, padding=1, deformable_groups=4)
    x, feat = torch.rand(2, 16, 8, 8), torch.rand(2, 16, 8, 8)
    with torch.no_grad():
        got = m(x, feat)
        want = torch.nn.functional.conv2d(0.5 * x, m.weight, m.bias,
                                          padding=1)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def _tiny_jax(seed):
    net = jarch.EDVR(**TINY)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 5, 16, 16, 3)))['params']
    return net, _draw(shapes, seed, offset_scale=0.05)


def test_tapshared_edvr_forward_matches_jax(route):
    before = dcn_pallas.TRACE_COUNTS['blend']
    net, params = _tiny_jax(2)
    lq = np.random.RandomState(3).rand(2, 5, 16, 16, 3).astype(np.float32)
    want = np.asarray(jax.jit(net.apply)({'params': params},
                                         jnp.asarray(lq)))
    _check_blend(route, before)

    torch_net = define_network(dict(type='EDVR', **TINY)).eval()
    torch_net.load_state_dict(_state(params), strict=True)
    assert isinstance(torch_net.pcd_align.cas_dcnpack,
                      arch_util.WarpAlignPack)
    launches = dict(dcn.LAUNCHES)
    with torch.no_grad():
        got = torch_net(torch.from_numpy(lq).permute(0, 1, 4, 2, 3))
    assert dcn.LAUNCHES == launches  # CPU: plain versions, no kernel
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=NET_ATOL, rtol=0)


def test_tapshared_edvr_grads_match_jax(route):
    """One Charbonnier step's gradients of every parameter, conv_offset's
    (the warp's offsets and masks) included."""
    before = dcn_pallas.TRACE_COUNTS['blend']
    net, params = _tiny_jax(4)
    rng = np.random.RandomState(5)
    lq = rng.rand(1, 5, 16, 16, 3).astype(np.float32)
    gt = rng.rand(1, 64, 64, 3).astype(np.float32)
    cri = JaxCharbonnier(loss_weight=1.0, reduction='sum')
    jgrads = jax.jit(jax.grad(lambda p: cri(net.apply(
        {'params': p}, jnp.asarray(lq)), jnp.asarray(gt))))(params)
    _check_blend(route, before)
    want = _state(jgrads)

    torch_net = define_network(dict(type='EDVR', **TINY))
    torch_net.load_state_dict(_state(params), strict=True)
    from edvr_tpu_torch.models.losses import CharbonnierLoss
    out = torch_net(torch.from_numpy(lq).permute(0, 1, 4, 2, 3))
    CharbonnierLoss(loss_weight=1.0, reduction='sum')(
        out, torch.from_numpy(gt).permute(0, 3, 1, 2)).backward()
    named = dict(torch_net.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        scale = np.abs(g.numpy()).max()
        assert scale > 0, name
        np.testing.assert_allclose(named[name].grad.numpy() / scale,
                                   g.numpy() / scale, atol=STEP_TOL,
                                   err_msg=name)


def test_tapshared_yml_builds_the_variant():
    """The shipped tap_shared YAML's network_g builds the port's tap_shared
    EDVR-M (it raised TypeError before align_variant was ported)."""
    opt = parse(YML, is_train=True, root='.')
    assert opt['network_g']['align_variant'] == 'tap_shared'
    net = define_network(opt['network_g'])
    dg = opt['network_g']['deformable_groups']
    packs = [net.pcd_align.dcn_pack[lv] for lv in ('l1', 'l2', 'l3')]
    packs.append(net.pcd_align.cas_dcnpack)
    for pack in packs:
        assert isinstance(pack, arch_util.WarpAlignPack)
        assert pack.conv_offset.out_channels == dg * 3
        assert pack.weight.shape == (64, 64, 3, 3)


def test_unknown_variant_raises():
    with pytest.raises(KeyError):
        define_network(dict(type='EDVR', **dict(TINY, align_variant='nope')))


def test_train_cli_runs_the_tapshared_yml(tmp_path, monkeypatch):
    """The training CLI on the shipped tap_shared YAML, cut to a tiny
    network and one step on a synthetic REDS tree, bf16 overridden."""
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / 'reds')
    _reds_tree(root)
    from edvr_tpu_torch.train import main
    model = main(['-opt', YML, '--device', 'cpu', '--force_yml',
                  'train:mixed_precision=~', 'train:total_iter=1',
                  'num_gpu=1', 'network_g:num_feat=8',
                  'network_g:num_extract_block=1',
                  'network_g:num_reconstruct_block=1',
                  f'datasets:train:dataroot_gt={root}/train/gt',
                  f'datasets:train:dataroot_lq={root}/train/lq',
                  f'datasets:train:meta_info_file={root}/meta_info.txt',
                  'datasets:train:gt_size=32',
                  'datasets:train:num_worker_per_gpu=0',
                  'datasets:train:batch_size_per_gpu=1',
                  f'datasets:val:dataroot_gt={root}/val/gt',
                  f'datasets:val:dataroot_lq={root}/val/lq',
                  'datasets:val:meta_info_file=~'])
    assert isinstance(model.net_g.pcd_align.dcn_pack['l1'],
                      arch_util.WarpAlignPack)
    assert np.isfinite(model.get_current_log()['l_pix'])
    assert model.metric_results['000'].shape == (6, 1)
