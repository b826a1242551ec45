"""The port's packed DCN route against the JAX package, on the CPU at
pinned float32 matmul precision (root conftest).

``EDVR_TPU_DCN_PALLAS=1`` sends both packages' DCN through the packed
route (``edvr_tpu/ops/dcn.py::_mdcn_packed``, gather branch). JAX runs its
blend kernel, ``dcn_pallas.blend_matmul_group``, in Pallas interpret mode
(``EDVR_TPU_DCN_PALLAS_INTERPRET=1``, as tests/test_dcn_pallas.py does),
and every test that compares with it asserts that the kernel traced. The
port runs the plain versions of its two kernels (``ops/gather.py``,
``ops/dcn_blend.py``) through their autograd Functions; the kernels
themselves are held against those plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py). Inputs are drawn with numpy
from a seed.
"""

import os.path as osp
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edvr_tpu.archs import edvr_arch as jarch
from edvr_tpu.models.losses import CharbonnierLoss as JaxCharbonnier
from edvr_tpu.ops import dcn as jdcn
from edvr_tpu.ops import dcn_pallas
from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.models import create_model
from edvr_tpu_torch.ops import dcn, dcn_blend, gather
from edvr_tpu_torch.utils.options import parse_dict
from test_torch_grad import SMALL, seeded_jax_params, train_opt

BLEND_TOL = 1e-5  # fp32 both sides, one product summed in another order
OUT_TOL = 1e-5    # the packed DCN's output, absolute
GRAD_TOL = 1e-4   # each gradient relative to its largest entry
STEP_TOL = 1e-4   # one EDVR step, as tests/test_torch_grad.py


@pytest.fixture
def packed(monkeypatch):
    """Both packages on the packed route, JAX's blend kernel interpreted
    and not yet traced (its trace count only moves on a trace)."""
    monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
    monkeypatch.setenv('EDVR_TPU_DCN_PALLAS_INTERPRET', '1')
    dcn_pallas.blend_matmul_group.clear_cache()


def _blend_case(seed, NP, K, lanes, c_per, cout):
    rng = np.random.RandomState(seed)
    slots = lanes // c_per
    return [rng.randn(*s).astype(np.float32) for s in
            ((NP, K * lanes), (NP, K * slots), (K * lanes, cout),
             (NP, cout))]


BLEND_CASES = [dict(NP=70, K=3, lanes=32, c_per=4, cout=24),
               dict(NP=70, K=9, lanes=128, c_per=8, cout=16)]


@pytest.mark.parametrize('case', BLEND_CASES)
def test_blend_plain_matches_jax_kernel(packed, case):
    """blend_matmul_group_plain against the Pallas kernel (interpret mode,
    NP=70 over blocks of 32 rows: a ragged last block)."""
    arrays = _blend_case(0, **case)
    before = dcn_pallas.TRACE_COUNTS['blend']
    want = dcn_pallas.blend_matmul_group(*map(jnp.asarray, arrays),
                                         c_per=case['c_per'], block_rows=32)
    assert dcn_pallas.TRACE_COUNTS['blend'] > before
    got = dcn_blend.blend_matmul_group_plain(*map(torch.from_numpy, arrays),
                                             case['c_per'])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLEND_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize('case', BLEND_CASES)
def test_blend_function_vjp_matches_jax(packed, case):
    """BlendMatmulGroupFunction's forward and its four cotangents against
    jax.vjp of blend_matmul_group_ad."""
    arrays = _blend_case(1, **case)
    dout = np.random.RandomState(2).randn(
        case['NP'], case['cout']).astype(np.float32)
    c_per = case['c_per']
    out, vjp = jax.vjp(
        lambda *a: dcn_pallas.blend_matmul_group_ad(*a, c_per),
        *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dout))

    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = dcn_blend.blend_matmul_group(*leaves, c_per)
    got.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=BLEND_TOL * np.abs(out).max(), rtol=0)
    for name, leaf, w in zip(('g_cat', 'cs_cat', 'wexp_g', 'out_prev'),
                             leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w,
                                   atol=BLEND_TOL * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_row_gather_function():
    """row_gather on the CPU is index_select, and its backward the
    scatter-add of repeated rows."""
    rng = np.random.RandomState(3)
    table = torch.from_numpy(rng.randn(11, 12).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 11, 40).astype(np.int32))
    leaf = table.clone().requires_grad_()
    out = gather.row_gather(leaf, idx)
    assert torch.equal(out, table[idx.long()])
    dout = torch.from_numpy(rng.randn(40, 12).astype(np.float32))
    out.backward(dout)
    want = torch.zeros_like(table)
    for i, r in enumerate(idx.tolist()):
        want[r] += dout[i]
    torch.testing.assert_close(leaf.grad, want, atol=1e-6, rtol=0)


def _dcn_case(seed, n, h, w, cin, cout, dg, far=0.0, outside=False):
    """NHWC/HWIO numpy inputs; ``far`` of the offsets 10-25 px away, and
    with ``outside`` the first tap of every group thrown off the image."""
    rng = np.random.RandomState(seed)
    K = 9
    x = rng.randn(n, h, w, cin).astype(np.float32)
    off = rng.uniform(-2, 2, (n, h, w, dg * 2 * K))
    if far:
        sel = rng.rand(*off.shape) < far
        off = np.where(sel, rng.uniform(10, 25, off.shape) *
                       rng.choice([-1, 1], off.shape), off)
    if outside:
        for g in range(dg):
            off[..., g * 2 * K:g * 2 * K + 2] = -40.0
    mask = 1 / (1 + np.exp(-rng.randn(n, h, w, dg * K)))
    weight = rng.randn(3, 3, cin, cout) * 0.1
    bias = rng.randn(cout)
    return [np.asarray(a, np.float32) for a in (x, off, mask, weight, bias)]


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


def _oihw(a):
    return torch.from_numpy(a).permute(3, 2, 0, 1).contiguous()


@pytest.mark.parametrize('geo', [
    dict(n=2, h=9, w=21, cin=16, cout=8, dg=2, far=0.2),         # c_per 8
    dict(n=1, h=8, w=19, cin=32, cout=6, dg=2, far=0.3,          # c_per 16
         outside=True),
    dict(n=1, h=12, w=20, cin=64, cout=16, dg=8, far=0.05),      # EDVR-M
])
def test_packed_route_matches_jax(packed, geo):
    """Output and the x, offset, mask and weight gradients of the port's
    packed route against JAX's, with far offsets and taps wholly outside."""
    arrays = _dcn_case(4, **geo)
    dg = geo['dg']
    kw = dict(stride=1, padding=1, dilation=1, groups=1,
              deformable_groups=dg)

    def jloss(*a):
        out = jdcn.modulated_deform_conv(*a, **kw)
        return jnp.sum(out * jnp.cos(out)), out

    before = dcn_pallas.TRACE_COUNTS['blend']
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *map(jnp.asarray, arrays))
    assert dcn_pallas.TRACE_COUNTS['blend'] > before, 'blend did not trace'

    x, off, mask = (_nchw(a).requires_grad_() for a in arrays[:3])
    weight = _oihw(arrays[3]).requires_grad_()
    launches = dict(dcn.LAUNCHES)
    out = dcn.modulated_deform_conv(x, off, mask, weight,
                                    torch.from_numpy(arrays[4]), **kw)
    torch.sum(out * torch.cos(out)).backward()
    assert dcn.LAUNCHES == launches  # CPU: the plain versions, no kernel
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jout), atol=OUT_TOL, rtol=0)
    got = [t.grad.permute(0, 2, 3, 1).numpy() for t in (x, off, mask)]
    got.append(weight.grad.permute(2, 3, 1, 0).numpy())
    for name, g, w in zip(('dx', 'd_offset', 'd_mask', 'd_weight'), got,
                          jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * np.abs(w).max(),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize('geo', [
    dict(n=2, cin=16, cout=8, h=7, w=9, dg=2),                       # c_per 8
    dict(n=1, cin=16, cout=6, h=9, w=11, dg=1, stride=2, groups=2),  # 16
    dict(n=2, cin=32, cout=8, h=6, w=20, dg=2, padding=0, dilation=2),
    dict(n=2, cin=16, cout=16, h=5, w=7, dg=2, k=1, padding=0),      # K=1
    dict(n=1, cin=8, cout=5, h=6, w=9, dg=8),                        # c_per 1
    dict(n=1, cin=8, cout=5, h=6, w=40, dg=4, far=0.5),              # c_per 2
    dict(n=1, cin=32, cout=4, h=5, w=6, dg=1),                       # c_per 32
])
def test_packed_route_matches_plain(geo):
    """_mdcn_packed against modulated_deform_conv_plain (strides,
    dilation, conv groups, 1x1 taps, every c_per the route takes)."""
    rng = np.random.RandomState(5)
    n, cin, cout, h, w, dg = (geo[k] for k in ('n', 'cin', 'cout', 'h', 'w',
                                                'dg'))
    k, stride = geo.get('k', 3), geo.get('stride', 1)
    padding, dilation = geo.get('padding', 1), geo.get('dilation', 1)
    groups = geo.get('groups', 1)
    oh = (h + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1
    ow = (w + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1
    off = rng.uniform(-3, 3, (n, dg * 2 * k * k, oh, ow))
    far = rng.rand(*off.shape) < geo.get('far', 0.1)
    off = np.where(far, rng.uniform(10, 25, off.shape) *
                   rng.choice([-1, 1], off.shape), off)
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in (
        rng.randn(n, cin, h, w), off,
        rng.rand(n, dg * k * k, oh, ow),
        rng.randn(cout, cin // groups, k, k) * 0.2, rng.randn(cout))]
    geo_args = (stride, padding, dilation, groups, dg)
    got = dcn._mdcn_packed(*args, *geo_args)
    want = dcn.modulated_deform_conv_plain(*args, *geo_args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=OUT_TOL,
                               rtol=0)


def test_dispatch_takes_packed_route_only_when_switched(monkeypatch):
    """The switch and the tile-width condition decide the route: a DCN
    call makes one gather and one blend per deformable group."""
    calls = {'gather': 0, 'blend': 0}
    plain_gather, plain_blend = (gather.row_gather_plain,
                                 dcn_blend.blend_matmul_group_plain)

    def counted(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(gather, 'row_gather_plain',
                        counted('gather', plain_gather))
    monkeypatch.setattr(dcn_blend, 'blend_matmul_group_plain',
                        counted('blend', plain_blend))
    rng = np.random.RandomState(6)

    def run(cin, dg):
        args = [torch.from_numpy(np.asarray(a, np.float32)) for a in (
            rng.randn(1, cin, 6, 7), rng.randn(1, dg * 18, 6, 7),
            rng.rand(1, dg * 9, 6, 7), rng.randn(4, cin, 3, 3))]
        dcn.modulated_deform_conv(*args, None, 1, 1, 1, 1, dg)

    run(16, 2)
    assert calls == {'gather': 0, 'blend': 0}  # the switch is off
    monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
    run(16, 2)
    assert calls == {'gather': 2, 'blend': 2}
    run(64, 1)  # c_per 64: a tile of one pixel, not the packed route
    assert calls == {'gather': 2, 'blend': 2}


def test_edvr_packed_forward_and_step_match_jax(packed):
    """A tiny EDVR (8 features, dg 2: c_per 4) through the packed route:
    the output and one training step's gradients against JAX's packed
    route with the blend kernel interpreted."""
    before = dcn_pallas.TRACE_COUNTS['blend']
    net, params = seeded_jax_params(3)
    rng = np.random.RandomState(7)
    lq = rng.rand(2, 5, 16, 16, 3).astype(np.float32)
    gt = rng.rand(2, 64, 64, 3).astype(np.float32)
    cri = JaxCharbonnier(loss_weight=1.0, reduction='sum')

    def jloss(p):
        out = net.apply({'params': p}, jnp.asarray(lq))
        return cri(out, jnp.asarray(gt)), out

    (loss, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    assert dcn_pallas.TRACE_COUNTS['blend'] > before, 'blend did not trace'
    state = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            params))
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           jgrads))

    torch_net = define_network(dict(type='EDVR', **SMALL))
    torch_net.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = torch_net(torch.from_numpy(lq).permute(0, 1, 4, 2, 3))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jout), atol=3e-4, rtol=0)

    with tempfile.TemporaryDirectory() as tmp:
        opt = parse_dict(train_opt(), is_train=True, root=tmp)
        opt['device'] = 'cpu'
        ckpt = osp.join(tmp, 'init.pth')
        torch.save({'params': state}, ckpt)
        opt['path']['pretrain_network_g'] = ckpt
        model = create_model(opt)
    model.feed_data({'lq': torch.from_numpy(lq).permute(0, 1, 4, 2, 3),
                     'gt': torch.from_numpy(gt).permute(0, 3, 1, 2)})
    model.optimize_parameters(1)
    np.testing.assert_allclose(model.get_current_log()['l_pix'],
                               float(loss), rtol=1e-5)
    named = dict(model.net_g.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        scale = np.abs(g.numpy()).max()
        assert scale > 0, name
        np.testing.assert_allclose(named[name].grad.numpy() / scale,
                                   g.numpy() / scale, atol=STEP_TOL,
                                   err_msg=name)
