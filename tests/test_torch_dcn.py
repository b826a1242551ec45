"""The port's DCNv2 (edvr_tpu_torch/ops/dcn.py) against the JAX reference.

Inputs are drawn with numpy from a seed and handed to both frameworks;
JAX runs on the CPU at pinned float32 matmul precision (root conftest).
The plain PyTorch version is compared with the JAX gather path and with
the band kernel in Pallas interpret mode (the TPU kernel the CUDA kernel
replaces), at f32 with atol 1e-4. The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py);
here the wrapper's refusals are checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edvr_tpu.ops import dcn as jdcn
from edvr_tpu_torch import native
from edvr_tpu_torch.models.base_model import resolve_device
from edvr_tpu_torch.ops import dcn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4  # f32 both sides; sums taken in another order


def _case(seed, n, h, w, cin, cout, dg, stride=1, padding=1, dilation=1,
          groups=1, far=0.0):
    rng = np.random.RandomState(seed)
    K = 9
    oh = (h + 2 * padding - (dilation * 2 + 1)) // stride + 1
    ow = (w + 2 * padding - (dilation * 2 + 1)) // stride + 1
    x = rng.randn(n, h, w, cin).astype(np.float32)
    off = rng.uniform(-2, 2, (n, oh, ow, dg * 2 * K)).astype(np.float32)
    if far:
        sel = rng.rand(*off.shape) < far
        off = np.where(sel, rng.uniform(10, 25, off.shape) *
                       rng.choice([-1, 1], off.shape), off)
        off = off.astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(n, oh, ow, dg * K)))).astype(
        np.float32)
    weight = (rng.randn(3, 3, cin // groups, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, deformable_groups=dg)
    return (x, off, mask, weight, bias), kw


def _jax(arrays, kw):
    return np.asarray(jdcn.modulated_deform_conv(
        *(jnp.asarray(a) for a in arrays), **kw))


def _torch_args(arrays):
    """NHWC / HWIO numpy -> NCHW / OIHW tensors."""
    x, off, mask, weight, bias = arrays
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
    return (nchw(x), nchw(off), nchw(mask),
            torch.from_numpy(weight).permute(3, 2, 0, 1).contiguous(),
            torch.from_numpy(bias))


def _port(arrays, kw):
    out = dcn.modulated_deform_conv(*_torch_args(arrays), **kw)
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('geo', [
    dict(n=2, h=12, w=20, cin=64, cout=64, dg=8),              # c_per 8
    dict(n=2, h=12, w=20, cin=64, cout=64, dg=8, far=0.3),     # far taps
    dict(n=1, h=45, w=80, cin=64, cout=64, dg=8, far=0.01),    # EDVR L3
    dict(n=2, h=7, w=6, cin=4, cout=6, dg=2, stride=2),
    dict(n=2, h=7, w=6, cin=4, cout=6, dg=2, padding=0, dilation=2),
    dict(n=2, h=7, w=6, cin=4, cout=6, dg=2, groups=2),
])
def test_plain_matches_jax(geo):
    arrays, kw = _case(0, **geo)
    before = dcn.LAUNCHES['dcn_fwd']
    np.testing.assert_allclose(_port(arrays, kw), _jax(arrays, kw),
                               atol=ATOL, rtol=0)
    assert dcn.LAUNCHES['dcn_fwd'] == before  # CPU: no kernel launch


@pytest.mark.parametrize('cin,dg,far', [(16, 2, 0.01), (16, 2, 0.4),
                                        (64, 8, 0.05)])
def test_plain_matches_band_kernel_interpret(monkeypatch, cin, dg, far):
    """Against the TPU kernel itself: band_forward + outlier patch, run in
    Pallas interpret mode as tests/test_dcn_band.py runs it."""
    monkeypatch.setenv('EDVR_TPU_DCN_BAND', '1')
    monkeypatch.setenv('EDVR_TPU_DCN_BAND_INTERPRET', '1')
    monkeypatch.setenv('EDVR_TPU_DCN_BAND_MIN_P', '1024')
    arrays, kw = _case(3, n=1, h=32, w=64, cin=cin, cout=16, dg=dg, far=far)
    before = jdcn.DISPATCH_COUNTS['band']
    ref = _jax(arrays, kw)
    assert jdcn.DISPATCH_COUNTS['band'] == before + 1  # band path taken
    np.testing.assert_allclose(_port(arrays, kw), ref, atol=ATOL, rtol=0)


def test_plain_gradients_match_jax():
    arrays, kw = _case(5, n=1, h=6, w=7, cin=8, cout=4, dg=2, far=0.2)

    def jloss(*a):
        out = jdcn.modulated_deform_conv(*a, **kw)
        return jnp.sum(out * jnp.cos(out))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrays))
    targs = [t.requires_grad_() for t in _torch_args(arrays)]
    out = dcn.modulated_deform_conv(*targs, **kw)
    torch.sum(out * torch.cos(out)).backward()
    to_nhwc = lambda g: g.permute(0, 2, 3, 1).numpy()
    got = (to_nhwc(targs[0].grad), to_nhwc(targs[1].grad),
           to_nhwc(targs[2].grad), targs[3].grad.permute(2, 3, 1, 0).numpy())
    for g, j in zip(got, jgrads):
        np.testing.assert_allclose(g, np.asarray(j), atol=ATOL, rtol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back to the plain version."""
    arrays, kw = _case(1, n=1, h=8, w=8, cin=16, cout=16, dg=2)
    kw.pop('groups')
    before = dcn.LAUNCHES['dcn_fwd']
    with pytest.raises(ValueError, match='CUDA'):
        dcn.dcn_fwd_cuda(*_torch_args(arrays), **kw)
    assert dcn.LAUNCHES['dcn_fwd'] == before


def test_dispatch_refuses_other_devices():
    arrays, kw = _case(1, n=1, h=8, w=8, cin=16, cout=16, dg=2)
    meta = [t.to('meta') for t in _torch_args(arrays)]
    with pytest.raises(ValueError, match='unsupported device'):
        dcn.modulated_deform_conv(*meta, **kw)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        resolve_device(None)  # cuda is the default
    assert resolve_device('cpu') == torch.device('cpu')


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        native.nvcc_path()


@pytest.mark.parametrize('group_major', [True, False])
def test_fwd_kernel_layout_of_x(monkeypatch, group_major):
    """The forward wrapper's copy of x: group-major (n, dg, h, w, c_per),
    the layout csrc/dcn_fwd.cu reads (a corner's channels contiguous,
    neighbouring pixels c_per elements apart), or channels-last (n, h, w,
    cin) for an earlier source; element for element the same values."""
    monkeypatch.setattr(dcn, 'FWD_X_GROUP_MAJOR', group_major)
    n, cin, h, w, dg = 2, 12, 5, 7, 3
    x = torch.from_numpy(np.random.RandomState(0).randn(n, cin, h, w)
                         .astype(np.float32))
    got = dcn._fwd_x(x, dg)
    assert got.is_contiguous()
    if group_major:
        assert got.shape == (n, dg, h, w, cin // dg)
        for g in range(dg):
            for c in range(cin // dg):
                assert torch.equal(got[:, g, :, :, c], x[:, g * 4 + c])
    else:
        assert torch.equal(got, x.permute(0, 2, 3, 1))
