"""Card-only tests of the port's CUDA kernels and CUDA path.

Run on a machine with a CUDA card (the repo-root conftest imports jax,
which such a machine may lack, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Everywhere else every test here skips; the decision is made inside the
``cuda`` fixture, never at import or collection time. This file imports no
jax.
"""

import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from edvr_tpu_torch.archs import define_network  # noqa: E402
from edvr_tpu_torch.archs.edvr_arch import (  # noqa: E402
    clip_window_indices, make_clip_restore_fn)
from edvr_tpu_torch.ops import dcn  # noqa: E402

pytestmark = pytest.mark.gpu

GOLDEN = osp.join(osp.dirname(__file__), 'data', 'golden',
                  'arch_edvr_m_full.npz')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    # fp32 references: no TF32 in cuDNN convs or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _case(seed, n, cin, cout, h, w, dg, k=3, stride=1, padding=1,
          dilation=1, far=0.0, bias=True):
    rng = np.random.RandomState(seed)
    K = k * k
    oh = (h + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1
    ow = (w + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1
    x = rng.randn(n, cin, h, w)
    off = rng.uniform(-2, 2, (n, dg * 2 * K, oh, ow))
    if far:
        sel = rng.rand(*off.shape) < far
        off = np.where(sel, rng.uniform(10, 40, off.shape)
                       * rng.choice([-1, 1], off.shape), off)
    mask = 1 / (1 + np.exp(-rng.randn(n, dg * K, oh, ow)))
    weight = rng.randn(cout, cin, k, k) / np.sqrt(cin * K)
    b = rng.randn(cout) if bias else None
    t = [torch.from_numpy(np.asarray(a, np.float32)).cuda()
         for a in (x, off, mask, weight)]
    t.append(torch.from_numpy(b.astype(np.float32)).cuda() if bias
             else None)
    return t, dict(stride=stride, padding=padding, dilation=dilation,
                   deformable_groups=dg)


@pytest.mark.parametrize('geo', [
    dict(n=5, cin=64, cout=64, h=45, w=80, dg=8, far=0.05),   # EDVR-M L3
    dict(n=2, cin=64, cout=64, h=33, w=47, dg=8, far=0.5),
    dict(n=1, cin=16, cout=16, h=32, w=64, dg=2, far=0.01),
    dict(n=2, cin=16, cout=24, h=20, w=28, dg=4),             # c_per 4
    dict(n=1, cin=6, cout=70, h=13, w=17, dg=3),              # c_per 2
    dict(n=1, cin=4, cout=8, h=11, w=9, dg=4, bias=False),    # c_per 1
    dict(n=2, cin=32, cout=16, h=17, w=21, dg=1, stride=2),   # c_per 32
    dict(n=1, cin=16, cout=16, h=19, w=23, dg=1, padding=0, dilation=2),
])
def test_kernel_matches_plain(cuda, geo):
    args, kw = _case(0, **geo)
    before = dcn.LAUNCHES['dcn_fwd']
    with torch.no_grad():
        got = dcn.dcn_fwd_cuda(*args, **kw)
        want = dcn.modulated_deform_conv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES['dcn_fwd'] == before + 1
    assert got.shape == want.shape
    # same fp32 arithmetic, other summation order
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_kernel_taps_wholly_outside(cuda):
    """Offsets that throw every tap far outside the image give the bias."""
    args, kw = _case(1, n=1, cin=64, cout=64, h=12, w=20, dg=8)
    args[1] = torch.full_like(args[1], 1e6)
    with torch.no_grad():
        got = dcn.dcn_fwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    expect = args[4].view(1, -1, 1, 1).expand_as(got)
    torch.testing.assert_close(got, expect, atol=0, rtol=0)


def test_wrapper_refuses(cuda):
    args, kw = _case(2, n=1, cin=16, cout=16, h=8, w=8, dg=2)
    x, off, mask, weight, bias = args
    with pytest.raises(TypeError):
        dcn.dcn_fwd_cuda(x.double(), off, mask, weight, bias, **kw)
    with pytest.raises(ValueError):
        dcn.dcn_fwd_cuda(x, off, mask, weight.cpu(), bias, **kw)
    with pytest.raises(ValueError):
        dcn.dcn_fwd_cuda(x, off[:, :-2], mask, weight, bias, **kw)
    with pytest.raises(ValueError):
        dcn.dcn_fwd_cuda(x, off.transpose(2, 3).contiguous().transpose(
            2, 3), mask, weight, bias, **kw)
    with pytest.raises(ValueError):
        dcn.modulated_deform_conv(x, off, mask, weight[:, :8], bias,
                                  groups=2, **kw)
    with pytest.raises(ValueError):
        dcn.dcn_fwd_cuda(x[:, :12], off, mask, weight[:, :12], bias,
                         deformable_groups=4, stride=1, padding=1)
    with pytest.raises(ValueError):
        dcn.dcn_bwd_cuda(torch.zeros(1, 16, 4, 4, device=cuda), x, off,
                         mask, weight, **kw)
    with pytest.raises(ValueError, match='taps'):  # 1x3: neither 1x1 nor 3x3
        dcn.dcn_bwd_cuda(torch.zeros(1, 16, 8, 6, device=cuda), x,
                         torch.zeros(1, 12, 8, 6, device=cuda),
                         torch.zeros(1, 6, 8, 6, device=cuda),
                         weight[:, :, :1, :].contiguous(),
                         deformable_groups=2)


def test_golden_edvr_m_on_cuda(cuda):
    data = np.load(GOLDEN)
    net = define_network(json.loads(bytes(data['__config__']).decode()))
    net.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files
                         if not k.startswith('__')}, strict=True)
    net = net.to(cuda).eval()
    before = dcn.LAUNCHES['dcn_fwd']
    with torch.no_grad():
        out = net(torch.from_numpy(data['__input__']).to(cuda)).cpu()
    assert dcn.LAUNCHES['dcn_fwd'] == before + 4  # L3, L2, L1, cascade
    np.testing.assert_allclose(out.numpy(), data['__output__'], atol=3e-4)


def test_clip_restore_cuda_matches_cpu(cuda):
    torch.manual_seed(0)
    net = define_network(dict(type='EDVR', num_feat=16, deformable_groups=2,
                              num_extract_block=1,
                              num_reconstruct_block=1)).eval()
    with torch.no_grad():  # non-zero offsets, so the DCN samples move
        for mod in net.modules():
            if hasattr(mod, 'conv_offset'):
                mod.conv_offset.weight.normal_(0, 0.05)
    clip = torch.rand(7, 3, 32, 32, generator=torch.Generator()
                      .manual_seed(1))
    idx = clip_window_indices(7, 5)
    want = make_clip_restore_fn(net)(clip, idx)
    got = make_clip_restore_fn(net.to(cuda), win_batch=3)(clip.to(cuda),
                                                          idx).cpu()
    torch.testing.assert_close(got, want, atol=3e-4, rtol=0)


def _plain_grads(args, kw, dout):
    """Gradients of <dout, plain DCN> by autograd, on the card."""
    leaves = [a.detach().clone().requires_grad_() for a in args[:4]]
    out = dcn.modulated_deform_conv_plain(*leaves, args[4], **kw)
    return torch.autograd.grad(out, leaves, dout)


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


# fp32 on both sides; sums over up to K*c_per*cout (dcol), n*P (dW) and the
# scattered corners (dx, with atomics in a varying order) taken in another
# order, so each gradient is held relative to its own largest entry
BWD_TOL = 1e-4


@pytest.mark.parametrize('geo', [
    dict(n=20, cin=64, cout=64, h=16, w=16, dg=8, far=0.05),  # EDVR-M L3
    dict(n=2, cin=64, cout=64, h=33, w=47, dg=8, far=0.5),
    dict(n=2, cin=16, cout=24, h=20, w=28, dg=4),              # c_per 4
    dict(n=1, cin=6, cout=70, h=13, w=17, dg=3),               # c_per 2
    dict(n=1, cin=4, cout=8, h=11, w=9, dg=4, bias=False),     # c_per 1
    dict(n=2, cin=32, cout=16, h=17, w=21, dg=1, stride=2),    # c_per 32
    dict(n=1, cin=32, cout=130, h=12, w=14, dg=2, far=0.1),    # c_per 16
    dict(n=1, cin=16, cout=16, h=19, w=23, dg=1, padding=0, dilation=2),
    dict(n=2, cin=16, cout=16, h=9, w=10, dg=2, k=1, padding=0),  # 1x1
])
def test_bwd_kernel_matches_plain(cuda, geo):
    args, kw = _case(3, **geo)
    with torch.no_grad():
        out = dcn.modulated_deform_conv_plain(*args, **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)
                       ).to(cuda)
    before = dcn.LAUNCHES['dcn_bwd']
    got = dcn.dcn_bwd_cuda(dout, *args[:4], **kw)
    want = _plain_grads(args, kw, dout)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES['dcn_bwd'] == before + 1
    for name, g, w in zip(('dx', 'd_offset', 'd_mask', 'd_weight'), got,
                          want):
        assert g.shape == w.shape, name
        assert _rel_err(g, w) <= BWD_TOL, (name, _rel_err(g, w))


def test_bwd_integer_offsets(cuda):
    """Offsets that are exactly integer (a fresh EDVR's zero conv_offset)
    take the floor convention of the plain version."""
    args, kw = _case(5, n=2, cin=64, cout=64, h=16, w=16, dg=8)
    args[1] = torch.randint(-3, 4, args[1].shape, device=cuda).float()
    dout = torch.randn(2, 64, 16, 16, device=cuda)
    got = dcn.dcn_bwd_cuda(dout, *args[:4], **kw)
    want = _plain_grads(args, kw, dout)
    for name, g, w in zip(('dx', 'd_offset', 'd_mask', 'd_weight'), got,
                          want):
        assert _rel_err(g, w) <= BWD_TOL, (name, _rel_err(g, w))


def test_bwd_taps_wholly_outside(cuda):
    """Taps thrown far outside the image give zero to every gradient."""
    args, kw = _case(6, n=1, cin=64, cout=64, h=12, w=20, dg=8)
    args[1] = torch.full_like(args[1], -1e6)
    dout = torch.randn(1, 64, 12, 20, device=cuda)
    for g in dcn.dcn_bwd_cuda(dout, *args[:4], **kw):
        assert torch.count_nonzero(g).item() == 0


def test_autograd_function_on_cuda(cuda):
    """modulated_deform_conv on CUDA tensors differentiates through both
    kernels, bias included, and agrees with plain autograd."""
    args, kw = _case(7, n=2, cin=32, cout=32, h=14, w=18, dg=4, far=0.05)
    leaves = [a.clone().requires_grad_() for a in args]
    before = dict(dcn.LAUNCHES)
    out = dcn.modulated_deform_conv(*leaves, **kw)
    (out * out.cos()).sum().backward()
    assert dcn.LAUNCHES['dcn_fwd'] == before['dcn_fwd'] + 1
    assert dcn.LAUNCHES['dcn_bwd'] == before['dcn_bwd'] + 1
    ref = [a.clone().requires_grad_() for a in args]
    out_p = dcn.modulated_deform_conv_plain(*ref, **kw)
    (out_p * out_p.cos()).sum().backward()
    for a, b in zip(leaves, ref):
        assert _rel_err(a.grad, b.grad) <= BWD_TOL


def test_edvr_train_steps_cuda_match_cpu(cuda):
    """Two EDVR training steps through the engine on the card and on the
    CPU from the same weights and batches: the gradients agree."""
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.utils.options import parse_dict
    import tempfile
    opt = dict(
        name='cuda_vs_cpu', model_type='EDVRModel', scale=4, num_gpu=1,
        manual_seed=0,
        network_g=dict(type='EDVR', num_in_ch=3, num_out_ch=3, num_feat=16,
                       num_frame=5, deformable_groups=2, num_extract_block=1,
                       num_reconstruct_block=1, center_frame_idx=None,
                       hr_in=False, with_predeblur=False, with_tsa=True),
        path=dict(pretrain_network_g=None, strict_load_g=True),
        train=dict(optim_g=dict(type='Adam', lr=4e-4, weight_decay=0,
                                betas=[0.9, 0.99]),
                   scheduler=dict(type='CosineAnnealingRestartLR',
                                  periods=[10], restart_weights=[1],
                                  eta_min=1e-7),
                   total_iter=10, warmup_iter=-1, dcn_lr_mul=1,
                   mixed_precision=None, tsa_iter=0,
                   pixel_opt=dict(type='CharbonnierLoss', loss_weight=1.0,
                                  reduction='sum')))
    gen = torch.Generator().manual_seed(8)
    batches = [dict(lq=torch.rand(2, 5, 3, 16, 16, generator=gen),
                    gt=torch.rand(2, 3, 64, 64, generator=gen))
               for _ in range(2)]
    models = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ('cpu', 'cuda'):
            o = parse_dict(json.loads(json.dumps(opt)), is_train=True,
                           root=tmp)
            o['device'] = dev
            models[dev] = create_model(o)
        with torch.no_grad():  # non-zero offsets, so the DCN samples move
            for name, p in models['cpu'].net_g.named_parameters():
                if 'conv_offset' in name:
                    p.normal_(0, 0.05, generator=gen)
        for it, batch in enumerate(batches, 1):
            # each step's gradients are taken at the same parameters
            models['cuda'].net_g.load_state_dict(
                models['cpu'].net_g.state_dict())
            grads = {}
            for dev, model in models.items():
                model.feed_data(batch)
                model.optimize_parameters(it)
                grads[dev] = {n: p.grad.detach().cpu() for n, p in
                              model.net_g.named_parameters()}
            # as chip_smoke.py's STEP_GRAD_TOL: fp32 through the whole
            # network with cuDNN's and the CPU's conv algorithms
            for name, g in grads['cpu'].items():
                assert _rel_err(grads['cuda'][name], g) <= 1e-3, name


# --- the packed DCN route: row gather and blend GEMM kernels -------------

@pytest.mark.parametrize('R,L,G', [
    (3600, 128, 4096),     # probe_mosaic_gather.py's smallest table
    (1000, 128, 8003),     # a ragged last block of rows
    (37, 126, 515),        # a row of 126 floats: the 4-byte path
    (5, 4, 1),
])
def test_row_gather_kernel_matches_index_select(cuda, R, L, G):
    from edvr_tpu_torch.ops import gather
    gen = torch.Generator().manual_seed(R + G)
    table = torch.randn(R, L, generator=gen).to(cuda)
    idx = torch.randint(0, R, (G,), generator=gen, dtype=torch.int32).to(
        cuda)
    before = dcn.LAUNCHES['row_gather']
    got = gather.row_gather_cuda(table, idx)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES['row_gather'] == before + 1
    assert torch.equal(got, table.index_select(0, idx))  # bitwise


def test_row_gather_kernel_refuses(cuda):
    from edvr_tpu_torch.ops import gather
    table = torch.randn(10, 128, device=cuda)
    for bad in (10, -1):
        idx = torch.tensor([0, 3, bad, 9], dtype=torch.int32, device=cuda)
        with pytest.raises(IndexError, match='outside'):
            gather.row_gather_cuda(table, idx)
    with pytest.raises(TypeError):
        gather.row_gather_cuda(table, idx.long())
    with pytest.raises(ValueError, match='CUDA'):
        gather.row_gather_cuda(table, idx.cpu())
    with pytest.raises(ValueError, match='contiguous'):
        gather.row_gather_cuda(table.t(), idx[:2].clamp(0, 3))


def _blend_args(seed, NP, K, lanes, c_per, cout):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=gen).to('cuda') for s in (
        (NP, K * lanes), (NP, K * lanes // c_per), (K * lanes, cout),
        (NP, cout))]


@pytest.mark.parametrize('NP,K,lanes,c_per,cout', [
    (70, 3, 32, 4, 24),
    (1000 + 13, 9, 128, 8, 64),    # EDVR-M, ragged rows
    (300, 9, 128, 16, 70),         # ragged channels
    (129, 1, 128, 32, 64),         # K=1 (tap_shared's warp)
    (65, 9, 128, 1, 8),
    (65, 9, 128, 2, 8),
])
def test_blend_kernel_matches_plain(cuda, NP, K, lanes, c_per, cout):
    from edvr_tpu_torch.ops import dcn_blend
    args = _blend_args(NP, NP, K, lanes, c_per, cout)
    before = dcn.LAUNCHES['blend_matmul']
    got = dcn_blend.blend_matmul_cuda(*args, c_per)
    want = dcn_blend.blend_matmul_group_plain(*args, c_per)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES['blend_matmul'] == before + 1
    # fp32 both sides, the same products summed in another order
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_blend_wrapper_refuses(cuda):
    from edvr_tpu_torch.ops import dcn_blend
    args = _blend_args(0, 64, 3, 24, 3, 8)  # c_per 3: no instantiation
    with pytest.raises(ValueError, match='c_per'):
        dcn_blend.blend_matmul_cuda(*args, 3)
    args = _blend_args(0, 64, 3, 32, 4, 8)
    with pytest.raises(TypeError):
        dcn_blend.blend_matmul_cuda(args[0].double(), *args[1:], 4)
    with pytest.raises(ValueError, match='CUDA'):
        dcn_blend.blend_matmul_cuda(args[0], args[1].cpu(), *args[2:], 4)
    with pytest.raises(ValueError, match='shapes'):
        dcn_blend.blend_matmul_cuda(*args[:3], args[3][:-1], 4)


@pytest.mark.parametrize('geo', [
    dict(n=5, cin=64, cout=64, h=45, w=80, dg=8, far=0.05),   # EDVR-M L3
    dict(n=2, cin=32, cout=16, h=17, w=30, dg=2, far=0.3),    # c_per 16
    dict(n=2, cin=16, cout=16, h=9, w=10, dg=2, k=1, padding=0),  # 1x1
])
def test_packed_route_matches_direct_route(cuda, monkeypatch, geo):
    """EDVR_TPU_DCN_PALLAS=1 on CUDA tensors: the forward and the x,
    offset, mask, weight and bias gradients through the gather and blend
    kernels (one of each per deformable group, no dcn_fwd/dcn_bwd) against
    the direct route's dcn_fwd/dcn_bwd kernels."""
    args, kw = _case(9, **geo)
    results = {}
    for route in ('direct', 'packed'):
        if route == 'packed':
            monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
        leaves = [a.clone().requires_grad_() for a in args]
        before = dict(dcn.LAUNCHES)
        out = dcn.modulated_deform_conv(*leaves, **kw)
        (out * out.cos()).sum().backward()
        torch.cuda.synchronize()
        results[route] = (out.detach(), [a.grad for a in leaves],
                          {k: dcn.LAUNCHES[k] - before[k] for k in before})
    dg = geo['dg']
    assert results['direct'][2] == dict(dcn_fwd=1, dcn_bwd=1, row_gather=0,
                                        blend_matmul=0)
    assert results['packed'][2] == dict(dcn_fwd=0, dcn_bwd=0, row_gather=dg,
                                         blend_matmul=dg)
    torch.testing.assert_close(results['packed'][0], results['direct'][0],
                               atol=1e-4, rtol=0)
    for name, g, w in zip(('dx', 'd_offset', 'd_mask', 'd_weight', 'd_bias'),
                          results['packed'][1], results['direct'][1]):
        assert _rel_err(g, w) <= BWD_TOL, (name, _rel_err(g, w))


def test_packed_edvr_step_cuda_matches_cpu(cuda, monkeypatch):
    """One EDVR training step through the packed route on the card (8
    gathers and 8 blends forward, no dcn_fwd/dcn_bwd) against the same
    step on the CPU's packed route."""
    monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
    torch.manual_seed(0)
    net = define_network(dict(type='EDVR', num_feat=16, deformable_groups=2,
                              num_extract_block=1,
                              num_reconstruct_block=1))
    with torch.no_grad():  # non-zero offsets, so the DCN samples move
        for mod in net.modules():
            if hasattr(mod, 'conv_offset'):
                mod.conv_offset.weight.normal_(0, 0.05)
    gen = torch.Generator().manual_seed(1)
    lq = torch.rand(2, 5, 3, 16, 16, generator=gen)
    grads = {}
    for dev in ('cpu', 'cuda'):
        net.to(dev).zero_grad()
        before = dict(dcn.LAUNCHES)
        net(lq.to(dev)).square().sum().backward()
        # a copy: moving the net moves its gradients' storage too
        grads[dev] = {n: p.grad.detach().clone().cpu()
                      for n, p in net.named_parameters()}
        counts = {k: dcn.LAUNCHES[k] - before[k] for k in before}
    assert counts == dict(dcn_fwd=0, dcn_bwd=0, row_gather=8,
                          blend_matmul=8)
    for name, g in grads['cpu'].items():
        assert _rel_err(grads['cuda'][name], g) <= 1e-3, name


def test_test_cli_on_card_matches_cpu(cuda, tmp_path):
    """``python -m edvr_tpu_torch.test`` on the card in a fresh process
    leaves TF32 off, so the EDVR-M it restores with (the golden weights)
    gives the CPU path's output within 3e-4."""
    import subprocess
    pytest.importorskip('cv2')
    pytest.importorskip('yaml')
    from test_torch_cli import _make_clips, _write_opt
    data = np.load(GOLDEN)
    state = {k: torch.from_numpy(data[k]) for k in data.files
             if not k.startswith('__')}
    config = json.loads(bytes(data['__config__']).decode())
    ckpt = str(tmp_path / 'golden.pth')
    torch.save({'params': state}, ckpt)
    root = str(tmp_path / 'clips')
    _make_clips(root, clips=('000',), frames=5, lq_hw=32)
    yml = _write_opt(tmp_path, root, 'card_cli', save_img=False)
    import yaml
    with open(yml) as f:
        opt = yaml.safe_load(f)
    opt['network_g'] = dict(type='EDVR', **{k: v for k, v in config.items()
                                            if k != 'type'})
    opt['path']['pretrain_network_g'] = ckpt
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f)
    lq = torch.rand(1, 5, 3, 32, 32, generator=torch.Generator()
                    .manual_seed(2))
    np.save(tmp_path / 'lq.npy', lq.numpy())
    code = (
        'import sys, numpy as np, torch\n'
        'from edvr_tpu_torch.test import main\n'
        'model = main(["-opt", sys.argv[1]])\n'
        'assert model.device.type == "cuda", model.device\n'
        'lq = torch.from_numpy(np.load(sys.argv[2])).cuda()\n'
        'with torch.no_grad():\n'
        '    np.save(sys.argv[3], model.net_g(lq).cpu().numpy())\n'
        'print(torch.backends.cuda.matmul.allow_tf32, '
        'torch.backends.cudnn.allow_tf32)\n')
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.environ.get('PYTHONPATH', '')]))
    proc = subprocess.run([sys.executable, '-c', code, yml,
                           str(tmp_path / 'lq.npy'),
                           str(tmp_path / 'out.npy')], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-2:] == ['False', 'False']
    net = define_network(config)
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        want = net.eval()(lq).numpy()
    np.testing.assert_allclose(np.load(tmp_path / 'out.npy'), want,
                               atol=3e-4, rtol=0)
