"""Gradients of the port against the JAX package, on the CPU at pinned
float32 (root conftest):

* the plain DCNv2's autograd against ``band_backward``, the TPU kernel the
  CUDA backward replaces, run in Pallas interpret mode with far offsets;
* a float64 finite-difference check of the plain DCNv2's autograd;
* one EDVR training step's gradients (num_feat 8, dg 2, 1+1 blocks, TSA)
  through the port's engine against ``jax.grad`` of the JAX network under
  the same Charbonnier loss, from the same seeded parameters carried over
  by ``convert.jax_params_to_state_dict``.
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
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.models import create_model
from edvr_tpu_torch.ops import dcn
from edvr_tpu_torch.utils.options import parse_dict
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# band kernel vs plain autograd, each gradient relative to its largest
# entry: the bound tests/test_dcn_band.py holds the band path to against
# the gather path (one-hot MXU contractions summed in another order)
BAND_TOL = 5e-5
# one EDVR step, each parameter's gradient relative to its largest entry:
# f32 on both sides through ~20 layers and 4 DCNs, other conv algorithms
STEP_TOL = 1e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize('seed,far', [(3, 0.0), (4, 0.02)])
def test_plain_grads_match_band_backward_interpret(monkeypatch, seed, far):
    from edvr_tpu.ops import dcn_band
    monkeypatch.setenv('EDVR_TPU_DCN_BAND', '1')
    monkeypatch.setenv('EDVR_TPU_DCN_BAND_INTERPRET', '1')
    monkeypatch.setenv('EDVR_TPU_DCN_BAND_MIN_P', '1024')
    rng = np.random.RandomState(seed)
    n, h, w, cin, cout, dg = 1, 32, 64, 16, 16, 2
    x = rng.randn(n, h, w, cin).astype(np.float32)
    off = rng.uniform(-2, 2, (n, h, w, dg * 18)).astype(np.float32)
    if far:
        sel = rng.rand(*off.shape) < far
        off = np.where(sel, rng.uniform(10, 25, off.shape) *
                       rng.choice([-1, 1], off.shape), off).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(n, h, w, dg * 9)))).astype(np.float32)
    weight = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)

    def jloss(*a):
        out = jdcn.modulated_deform_conv(*a, None, stride=1, padding=1,
                                         dilation=1, groups=1,
                                         deformable_groups=dg)
        return jnp.sum(out * jnp.cos(out * 3))

    before = jdcn.DISPATCH_COUNTS['band']
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, off, mask, weight)))
    # the band kernels ran: dispatched here, and band_backward traced
    assert jdcn.DISPATCH_COUNTS['band'] == before + 1
    assert dcn_band.TRACE_COUNTS['bwd'] > 0

    leaves = [_nchw(a).contiguous().requires_grad_()
              for a in (x, off, mask)]
    leaves.append(torch.from_numpy(weight).permute(3, 2, 0, 1).contiguous()
                  .requires_grad_())
    out = dcn.modulated_deform_conv(*leaves, None, 1, 1, 1, 1, dg)
    torch.sum(out * torch.cos(out * 3)).backward()
    got = [t.grad.permute(0, 2, 3, 1).numpy() for t in leaves[:3]]
    got.append(leaves[3].grad.permute(2, 3, 1, 0).numpy())
    for name, g, w_ in zip(('dx', 'd_offset', 'd_mask', 'd_weight'), got,
                           want):
        w_ = np.asarray(w_)
        scale = np.abs(w_).max()
        np.testing.assert_allclose(g / scale, w_ / scale, atol=BAND_TOL,
                                   err_msg=name)


def test_plain_gradcheck_float64():
    """Finite differences of the plain DCNv2 in float64, offsets within
    and beyond the image, against its autograd."""
    rng = np.random.RandomState(0)
    n, cin, cout, h, w, dg = 1, 4, 3, 5, 6, 2
    x = torch.from_numpy(rng.randn(n, cin, h, w))
    off = rng.uniform(-1.5, 1.5, (n, dg * 18, h, w))
    off[0, :4] += 6.3  # some taps partly or wholly outside
    off = torch.from_numpy(off)
    mask = torch.from_numpy(rng.uniform(0.1, 0.9, (n, dg * 9, h, w)))
    weight = torch.from_numpy(rng.randn(cout, cin, 3, 3) * 0.3)
    bias = torch.from_numpy(rng.randn(cout))
    args = [t.requires_grad_() for t in (x, off, mask, weight, bias)]
    assert torch.autograd.gradcheck(
        lambda *a: dcn.modulated_deform_conv_plain(*a, 1, 1, 1, 1, dg),
        args, eps=1e-6, atol=1e-7, rtol=1e-5, fast_mode=True)


SMALL = dict(num_in_ch=3, num_out_ch=3, num_feat=8, num_frame=5,
             deformable_groups=2, num_extract_block=1,
             num_reconstruct_block=1, center_frame_idx=None, hr_in=False,
             with_predeblur=False, with_tsa=True)


def seeded_jax_params(seed=0, offset_scale=0.05):
    """The small EDVR's flax parameter tree (by eval_shape, nothing
    compiled), every leaf drawn from a numpy seed; conv_offset's weights
    are seeded noise too, so the DCN samples move and its gradients are
    not trivial."""
    net = jarch.EDVR(**SMALL)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 5, 16, 16, 3)))['params']
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        if 'conv_offset' in name:
            return (rng.randn(*s.shape) * offset_scale).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 16
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return net, jax.tree_util.tree_map_with_path(draw, shapes)


def train_opt(**train):
    """A port option dict for the small EDVR's training engine."""
    opt = dict(name='torch_step', model_type='EDVRModel', scale=4,
               num_gpu=1, manual_seed=0, network_g=dict(type='EDVR', **SMALL),
               path=dict(pretrain_network_g=None, strict_load_g=True),
               train=dict(optim_g=dict(type='Adam', lr=4e-4, weight_decay=0,
                                       betas=[0.9, 0.99]),
                          scheduler=dict(type='CosineAnnealingRestartLR',
                                         periods=[8], restart_weights=[1],
                                         eta_min=1e-7),
                          total_iter=8, warmup_iter=-1, dcn_lr_mul=1,
                          mixed_precision=None, tsa_iter=0,
                          pixel_opt=dict(type='CharbonnierLoss',
                                         loss_weight=1.0, reduction='sum')))
    opt['train'].update(train)
    return opt


def test_edvr_step_grads_match_jax():
    net, params = seeded_jax_params()
    rng = np.random.RandomState(1)
    lq = rng.rand(2, 5, 16, 16, 3).astype(np.float32)
    gt = rng.rand(2, 64, 64, 3).astype(np.float32)
    cri = JaxCharbonnier(loss_weight=1.0, reduction='sum')
    loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: cri(net.apply({'params': p}, jnp.asarray(lq)),
                      jnp.asarray(gt))))(params)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           jgrads))

    with tempfile.TemporaryDirectory() as tmp:
        opt = parse_dict(train_opt(), is_train=True, root=tmp)
        opt['device'] = 'cpu'
        ckpt = osp.join(tmp, 'init.pth')
        torch.save({'params': jax_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, params))}, ckpt)
        opt['path']['pretrain_network_g'] = ckpt
        model = create_model(opt)
    model.feed_data({'lq': torch.from_numpy(lq).permute(0, 1, 4, 2, 3),
                     'gt': _nchw(gt)})
    model.optimize_parameters(1)
    np.testing.assert_allclose(model.get_current_log()['l_pix'],
                               float(loss), rtol=1e-5)
    named = dict(model.net_g.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        got = named[name].grad.numpy()
        scale = np.abs(g.numpy()).max()
        assert scale > 0, name
        np.testing.assert_allclose(got / scale, g.numpy() / scale,
                                   atol=STEP_TOL, err_msg=name)
