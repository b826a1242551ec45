"""Card-only tests of the port's CUDA kernels and CUDA path.

Run on a machine with a CUDA card (the repo-root conftest imports jax,
which such a machine may lack, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Everywhere else every test here skips; the decision is made inside the
``cuda`` fixture, never at import or collection time. This file imports no
jax.
"""

import json
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
    with pytest.raises(RuntimeError):
        dcn.dcn_fwd_cuda(x, off, mask, weight.requires_grad_(), bias, **kw)


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
