"""The port's StyleGAN2 slice against the JAX package, on the CPU at the
goldens' widths: ``upfirdn2d`` (an asymmetric kernel, every resampling
pattern the networks use and a crop; values, gradients and a second-order
gradient) and ``fused_leaky_relu``; the generator and discriminator against
their goldens and against the JAX modules (JAX's parameters carried by
``jax_params_to_state_dict``, explicit noise, truncation, mixing), the
noise strengths' gradients included; ``r1_penalty`` and
``g_path_regularize``; one engine iteration with both regularisers
against the JAX engine; ``tensor2img``'s grid; ``FFHQDataset``; the
official remaps; the train CLI on a tiny StyleGAN2 config (checkpoint,
resume) and the shipped 256 Cmul2 YAML built at full width.

The two engines draw the generator's injected noise from different
generators. The engine test makes it zero in both (``zero_noise``), so
that the path-length step, which runs after the G step has moved the
noise strengths, sees the same images; the noise itself is held to JAX's
through the modules with explicit noise lists.
"""

import copy
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
import torch.nn.functional as F
import yaml

from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.models import create_model, losses
from edvr_tpu_torch.ops.fused_act import fused_leaky_relu
from edvr_tpu_torch.ops.upfirdn2d import upfirdn2d
from edvr_tpu_torch.utils.options import parse_dict
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
GOLDEN_DIR = osp.join(REPO, 'tests', 'data', 'golden')
SHIPPED = osp.join(REPO, 'options', 'train', 'StyleGAN',
                   'train_StyleGAN2_256_Cmul2_FFHQ.yml')
# the goldens at the JAX package's own tolerance's tenth
# (tests/test_arch_parity.py: 3e-4), relative to max|out|
GOLDEN_TOL = 3e-5
# the same float32 weights through both packages, relative to each max
JAX_TOL = 1e-5
# one engine iteration's parameters, as tests/test_torch_gan.py
PARAM_ATOL = 1e-6

G_SMALL = dict(type='StyleGAN2Generator', out_size=16, num_style_feat=16,
               num_mlp=2, channel_multiplier=1, narrow=0.0625)
D_SMALL = dict(type='StyleGAN2Discriminator', out_size=16,
               channel_multiplier=1, narrow=0.0625, stddev_group=4)


def _nhwc(t):
    return np.moveaxis(np.asarray(t), -3, -1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _rel(got, want):
    """max|got - want| / max|want|; a None gradient (a parameter the
    function does not reach) is JAX's zero."""
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else np.asarray(got)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def jax_net(opt):
    from edvr_tpu.archs import define_network as jax_define
    return jax_define({k: v for k, v in opt.items() if k != 'noise_seed'})


def seeded_g(opt, seed, noise_std=1.0, strength_std=0.1):
    """A JAX StyleGAN2Generator of ``opt`` with numpy-drawn parameters
    (``jax.eval_shape`` of its init: nothing compiled): weights N(0, 1),
    biases N(0, 0.01), noise strengths N(0, strength_std^2) (zero in an
    initial state), stored noises N(0, noise_std^2). Returns (net, params,
    noises)."""
    net = jax_net(opt)
    shapes = jax.eval_shape(
        lambda k: net.init({'params': k}, [jnp.zeros(
            (1, opt['num_style_feat']))], randomize_noise=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = str(getattr(path[-1], 'key', path[-1]))
        if s.shape == (1,):
            return (rng.randn(*s.shape) * strength_std).astype(np.float32)
        if 'bias' in leaf:
            return (rng.randn(*s.shape) * 0.1).astype(np.float32)
        return rng.randn(*s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes['params'])
    noises = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * noise_std).astype(np.float32),
        shapes['noises'])
    return net, params, noises


def seeded_d(opt, seed):
    net = jax_net(opt)
    size = opt['out_size']
    shapes = jax.eval_shape(lambda k: net.init(k, jnp.zeros(
        (4, size, size, 3))), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * (0.1 if len(s.shape) == 1 else 1))
        .astype(np.float32), shapes['params'])
    return net, params


def port_g(opt, params, noises):
    net = define_network(opt)
    net.load_state_dict(jax_params_to_state_dict(_tree(params),
                                                 noises=_tree(noises)),
                        strict=True)
    return net


# ---------------------------------------------------------------------- #
# ops
# ---------------------------------------------------------------------- #
# (up, down, pad): upfirdn_upsample, upfirdn_downsample, the smoothing
# after an upsampling 3x3 (and 1x1) conv and before a downsampling 3x3 /
# 1x1 conv, a 4-tuple pad, and crops
UPFIRDN_CASES = [(2, 1, (2, 1)), (1, 2, (1, 1)), (1, 1, (1, 1)),
                 (1, 1, (2, 2)), (1, 1, (2, 1)), (1, 1, (1, 0, 2, 1)),
                 (2, 2, (2, -1)), (1, 1, (-1, 2, 0, -1))]


@pytest.mark.parametrize('up,down,pad', UPFIRDN_CASES)
def test_upfirdn2d_matches_jax(up, down, pad):
    """Values, the input's and the kernel's gradients and a second-order
    gradient (d/dx of |d f/dx|^2 for f = sum(c * out^2)) against
    ``edvr_tpu.ops.upfirdn2d`` with an asymmetric kernel (the shipped
    [1, 3, 3, 1] is symmetric and cannot show a missing flip)."""
    from edvr_tpu.ops.upfirdn2d import upfirdn2d as jax_upfirdn2d
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 9, 3).astype(np.float32)
    k = rng.rand(4, 3).astype(np.float32)
    out_shape = jax.eval_shape(lambda a: jax_upfirdn2d(
        a, jnp.asarray(k), up, down, pad), jnp.asarray(x)).shape
    c = rng.randn(*out_shape).astype(np.float32)
    v = rng.randn(*x.shape).astype(np.float32)

    def jf(a, kk):
        return jnp.sum(jnp.asarray(c) * jax_upfirdn2d(a, kk, up, down,
                                                      pad)**2)

    def jsecond(a, kk):
        g = jax.grad(jf)(a, kk)
        return jnp.sum(g * jnp.asarray(v))

    want = jax_upfirdn2d(jnp.asarray(x), jnp.asarray(k), up, down, pad)
    jgx, jgk = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    jhx = jax.grad(jsecond)(jnp.asarray(x), jnp.asarray(k))

    xt = _nchw(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    got = upfirdn2d(xt, kt, up, down, pad)
    assert tuple(got.shape) == (2, 3) + tuple(out_shape[1:3])
    np.testing.assert_allclose(_nhwc(got.detach()), np.asarray(want),
                               rtol=0, atol=JAX_TOL * np.abs(want).max())
    f = (_nchw(c) * got**2).sum()
    gx, gk = torch.autograd.grad(f, (xt, kt), create_graph=True)
    hx, = torch.autograd.grad((gx * _nchw(v)).sum(), xt)
    for name, a, b in (('dx', _nhwc(gx.detach()), jgx),
                       ('dk', gk.detach().numpy(), jgk),
                       ('d2x', _nhwc(hx), jhx)):
        assert _rel(a, b) <= JAX_TOL, (name, _rel(a, b))


# (kind, arguments, input shape, weight shape): StyleGAN2's 3x3 and 1x1
# convolutions, stride 2 on an odd and an even map, the one-channel FIR,
# a grouped one, the upsampling transposed convolution, and one with
# padding and output padding
CONV_CASES = [
    ('conv', dict(stride=1, padding=1), (2, 4, 9, 7), (6, 4, 3, 3)),
    ('conv', dict(stride=2, padding=0), (2, 4, 9, 8), (6, 4, 3, 3)),
    ('conv', dict(stride=2, padding=0), (2, 4, 8, 8), (6, 4, 1, 1)),
    ('conv', dict(stride=1, padding=0), (6, 1, 9, 8), (1, 1, 4, 4)),
    ('conv', dict(stride=2, padding=0, groups=4), (2, 4, 9, 8),
     (4, 1, 4, 4)),
    ('convT', dict(stride=2, padding=0), (2, 4, 5, 6), (4, 6, 3, 3)),
    ('convT', dict(stride=2, padding=1, output_padding=1), (2, 4, 5, 6),
     (4, 6, 3, 3))]


@pytest.mark.parametrize('kind,kw,x_shape,w_shape', CONV_CASES)
def test_conv_grad_matches_autograd(kind, kw, x_shape, w_shape):
    """``ops/conv_grad.py`` against ``F.conv2d`` / ``F.conv_transpose2d``
    in float64: the output bitwise, the first derivatives of every input
    and the second derivatives (of a random projection of the first ones,
    bias included) within float64 rounding; and no node of the
    second-order graph is PyTorch's own convolution backward, whose double
    backward is the slow generic one."""
    from edvr_tpu_torch.ops import conv_grad
    gen = torch.Generator().manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                  dtype=torch.float64)
    x, w = rand(*x_shape), rand(*w_shape)
    groups = kw.get('groups', 1)
    b = rand(w_shape[1] * groups if kind == 'convT' else w_shape[0])
    ops = {'conv': (F.conv2d, conv_grad.conv2d),
           'convT': (F.conv_transpose2d, conv_grad.conv_transpose2d)}[kind]
    results = []
    for op in ops:
        args = [t.clone().requires_grad_() for t in (x, w, b)]
        y = op(*args, **kw)
        c = torch.randn(y.shape, generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64)
        firsts = torch.autograd.grad((c * y * y).sum(), args,
                                     create_graph=True)
        proj = sum((g * torch.randn(g.shape, generator=torch.Generator()
                                    .manual_seed(2 + i), dtype=torch.float64)
                    ).sum() for i, g in enumerate(firsts))
        seconds = torch.autograd.grad(proj, args)
        results.append((y, firsts, seconds))
        if op is ops[1]:
            seen, stack = set(), [f.grad_fn for f in firsts]
            while stack:
                node = stack.pop()
                if node is None or node in seen:
                    continue
                seen.add(node)
                assert 'ConvolutionBackward' not in type(node).__name__
                stack.extend(n for n, _ in node.next_functions)
    (y0, f0, s0), (y1, f1, s1) = results
    assert torch.equal(y0, y1)
    for a, b_ in (*zip(f0, f1), *zip(s0, s1)):
        torch.testing.assert_close(b_.detach(), a.detach(), rtol=0,
                                   atol=1e-13 * a.abs().max().item())


def test_fused_leaky_relu_matches_jax():
    from edvr_tpu.ops.fused_act import fused_leaky_relu as jax_flrelu
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    want, (jgx, jgb) = jax.value_and_grad(
        lambda a, bb: jnp.sum(jax_flrelu(a, bb)**2), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(b))
    xt = _nchw(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    got = (fused_leaky_relu(xt, bt)**2).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert _rel(_nhwc(xt.grad), jgx) <= 1e-6
    assert _rel(bt.grad, jgb) <= 1e-6
    # the (n, c) form of EqualLinear's activation
    x2 = rng.randn(3, 6).astype(np.float32)
    np.testing.assert_allclose(
        fused_leaky_relu(torch.from_numpy(x2), torch.from_numpy(b)).numpy(),
        np.asarray(jax_flrelu(jnp.asarray(x2), jnp.asarray(b))), rtol=1e-6)


# ---------------------------------------------------------------------- #
# the networks
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('name', ['g', 'g_mix', 'd'])
def test_stylegan2_golden(name):
    data = np.load(osp.join(GOLDEN_DIR, f'arch_stylegan2_{name}.npz'))
    config = json.loads(bytes(data['__config__']).decode())
    inject = config.pop('__mix_inject__', None)
    net = define_network(config)
    prefix = 'g.' if name != 'd' else ''
    net.load_state_dict({k[len(prefix):]: torch.from_numpy(data[k])
                         for k in data.files if not k.startswith('__')},
                        strict=True)
    x = torch.from_numpy(data['__input__'])
    with torch.no_grad():
        if name == 'd':
            out = net(x)
        elif inject is not None:
            out, _ = net([x[:, 0], x[:, 1]], randomize_noise=False,
                         inject_index=inject)
        else:
            out, _ = net([x], randomize_noise=False)
    want = data['__output__']
    assert out.shape == want.shape
    assert _rel(out.numpy(), want) <= GOLDEN_TOL


def test_generator_matches_jax():
    """Truncation, a mix at inject_index 3, explicit noise and nonzero
    noise strengths: the image, the latent, and every parameter's
    gradient of a random projection of the image (noise strengths
    included) against JAX's."""
    opt = dict(G_SMALL, out_size=32)
    net_j, params, noises = seeded_g(opt, 2)
    net = port_g(opt, params, noises)
    rng = np.random.RandomState(3)
    z1, z2 = (rng.randn(2, 16).astype(np.float32) for _ in range(2))
    trunc = rng.randn(1, 16).astype(np.float32) * 0.1
    noise = [rng.randn(2, 2**((i + 5) // 2), 2**((i + 5) // 2), 1)
             .astype(np.float32) for i in range(net.num_layers)]
    c = rng.randn(2, 32, 32, 3).astype(np.float32)
    kw = dict(truncation=0.7, inject_index=3, return_latents=True)

    def jloss(p):
        img, lat = net_j.apply({'params': p, 'noises': noises},
                               [jnp.asarray(z1), jnp.asarray(z2)],
                               noise=[jnp.asarray(n) for n in noise],
                               truncation_latent=jnp.asarray(trunc), **kw)
        return jnp.sum(img * jnp.asarray(c)), (img, lat)

    (_, (jimg, jlat)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    img, lat = net([torch.from_numpy(z1), torch.from_numpy(z2)],
                   noise=[_nchw(n) for n in noise],
                   truncation_latent=torch.from_numpy(trunc), **kw)
    assert _rel(_nhwc(img.detach()), jimg) <= JAX_TOL
    assert _rel(lat.detach(), jlat) <= JAX_TOL
    (img * _nchw(c)).sum().backward()
    want = jax_params_to_state_dict(_tree(jgrads))
    for name, p in net.named_parameters():
        assert _rel(p.grad, want[name]) <= JAX_TOL, name
    assert any(n.endswith('style_convs.3.weight') for n in want)
    # one style, stored noises; the explicit inject_index is required
    with torch.no_grad():
        got, none = net([torch.from_numpy(z1)], randomize_noise=False)
    jgot, _ = net_j.apply({'params': params, 'noises': noises},
                          [jnp.asarray(z1)], randomize_noise=False)
    assert none is None and _rel(_nhwc(got), jgot) <= JAX_TOL
    with pytest.raises(ValueError, match='inject_index'):
        net([torch.from_numpy(z1), torch.from_numpy(z2)])


def test_generator_noise_and_mean_latent():
    """Drawn noise comes from the generator's own ``torch.Generator``
    seeded by ``noise_seed`` (the same draw from the same seed, another
    from another; a copy starts its own afresh), and ``mean_latent`` is the
    mean of the style MLP over the generator's codes."""
    net = define_network(dict(G_SMALL, noise_seed=5))
    for m in net.modules():  # noise strengths that show the noise
        if hasattr(m, 'modulated_conv') and hasattr(m, 'activate'):
            m.weight.data.fill_(1.0)
    z = [torch.randn(2, 16, generator=torch.Generator().manual_seed(0))]
    with torch.no_grad():
        a, _ = net(z, generator=torch.Generator().manual_seed(1))
        b, _ = net(z, generator=torch.Generator().manual_seed(1))
        c, _ = net(z)
        stored, _ = net(z, randomize_noise=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, stored)
    with torch.no_grad():
        again, _ = copy.deepcopy(net)(z)
    assert torch.equal(again, c)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        mean = net.mean_latent(8, gen)
        want = net.style_mlp(torch.randn(
            8, 16, generator=torch.Generator().manual_seed(4))).mean(
                0, keepdim=True)
    torch.testing.assert_close(mean, want, rtol=0, atol=0)


def test_discriminator_matches_jax():
    """Output and every parameter's gradient, at a batch of 8 (two groups
    of the minibatch stddev, population variance)."""
    net_j, params = seeded_d(D_SMALL, 4)
    net = define_network(D_SMALL)
    net.load_state_dict(jax_params_to_state_dict(_tree(params)), strict=True)
    x = np.random.RandomState(5).randn(8, 16, 16, 3).astype(np.float32)
    c = np.random.RandomState(6).randn(8, 1).astype(np.float32)
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (jnp.sum(o * c), o))(net_j.apply(
            {'params': p}, jnp.asarray(x))), has_aux=True))(params)
    out = net(_nchw(x))
    assert _rel(out.detach(), jout) <= JAX_TOL
    (out * torch.from_numpy(c)).sum().backward()
    want = jax_params_to_state_dict(_tree(jgrads))
    for name, p in net.named_parameters():
        assert _rel(p.grad, want[name]) <= JAX_TOL, name


# ---------------------------------------------------------------------- #
# the regularisers
# ---------------------------------------------------------------------- #
def test_r1_penalty_matches_jax():
    from edvr_tpu.models.losses import r1_penalty as jax_r1
    net_j, params = seeded_d(D_SMALL, 7)
    net = define_network(D_SMALL)
    net.load_state_dict(jax_params_to_state_dict(_tree(params)), strict=True)
    x = np.random.RandomState(8).randn(4, 16, 16, 3).astype(np.float32)
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: jax_r1(
        lambda img: net_j.apply({'params': p}, img), jnp.asarray(x))))(
            params)
    xt = _nchw(x).requires_grad_()
    got = losses.r1_penalty(net(xt), xt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_g = jax_params_to_state_dict(_tree(jgrads))
    for name, p in net.named_parameters():
        assert _rel(p.grad, want_g[name]) <= 1e-4, name


def test_g_path_regularize_matches_jax():
    """The penalty, the batch's mean path length, the moved running mean
    and every parameter's gradient, with explicit noise and nonzero noise
    strengths."""
    from edvr_tpu.models.losses import g_path_regularize as jax_path
    net_j, params, noises = seeded_g(G_SMALL, 9)
    net = port_g(G_SMALL, params, noises)
    rng = np.random.RandomState(10)
    z = rng.randn(2, 16).astype(np.float32)
    noise = [rng.randn(2, 2**((i + 5) // 2), 2**((i + 5) // 2), 1)
             .astype(np.float32) for i in range(net.num_layers)]
    path_noise = rng.randn(2, 16, 16, 3).astype(np.float32) / 16

    def jloss(p):
        v = {'params': p, 'noises': noises}
        lat = net_j.apply(v, jnp.asarray(z), method=net_j.style_mlp)
        lat = jnp.repeat(lat[:, None], net.num_latent, axis=1)
        return jax_path(lambda la: net_j.apply(
            v, [la], input_is_latent=True,
            noise=[jnp.asarray(n) for n in noise])[0], lat,
            jnp.asarray(path_noise), jnp.float32(0.5))

    (jpen, (jlen, jmean)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda r: (r[0], r[1:]))(jloss(p)), has_aux=True))(
            params)
    latent = net.style_mlp(torch.from_numpy(z))[:, None].repeat(
        1, net.num_latent, 1)
    img, _ = net([latent], input_is_latent=True,
                 noise=[_nchw(n) for n in noise])
    pen, length, mean = losses.g_path_regularize(
        img, latent, _nchw(path_noise), torch.tensor(0.5))
    pen.backward()
    np.testing.assert_allclose(pen.item(), float(jpen), rtol=1e-4)
    np.testing.assert_allclose(length.item(), float(jlen), rtol=1e-5)
    np.testing.assert_allclose(mean.item(), float(jmean), rtol=1e-6)
    assert not mean.requires_grad
    want = jax_params_to_state_dict(_tree(jgrads))
    for name, p in net.named_parameters():
        assert _rel(p.grad, want[name]) <= 1e-4, name


def test_gradient_penalty_loss_matches_jax():
    from edvr_tpu.models.losses import gradient_penalty_loss as jax_gp
    net_j, params = seeded_d(D_SMALL, 11)
    net = define_network(D_SMALL)
    net.load_state_dict(jax_params_to_state_dict(_tree(params)), strict=True)
    rng = np.random.RandomState(12)
    real, fake = (rng.randn(4, 16, 16, 3).astype(np.float32)
                  for _ in range(2))
    alpha = rng.rand(4, 1, 1, 1).astype(np.float32)
    weight = rng.rand(4, 16, 16, 3).astype(np.float32)
    for w in (None, weight):
        want = jax.jit(lambda r, f, a, ww: jax_gp(
            lambda img: net_j.apply({'params': params}, img), r, f, a, ww))(
                jnp.asarray(real), jnp.asarray(fake), jnp.asarray(alpha),
                None if w is None else jnp.asarray(w))
        got = losses.gradient_penalty_loss(
            net, _nchw(real), _nchw(fake), torch.from_numpy(alpha),
            None if w is None else _nchw(w))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# ---------------------------------------------------------------------- #
# the engine
# ---------------------------------------------------------------------- #
def sg2_opt(**train):
    opt = {
        'name': 'sg2', 'model_type': 'StyleGAN2Model', 'num_gpu': 1,
        'manual_seed': 0, 'network_g': dict(G_SMALL),
        'network_d': dict(D_SMALL), 'path': {},
        'train': {
            # a small lr: Adam with b1 = 0 steps each entry by ~lr, so the
            # first iteration's parameters differ by lr where a gradient
            # entry's float32 rounding differs in sign
            'optim_g': dict(type='Adam', lr=1e-4),
            'optim_d': dict(type='Adam', lr=1e-4),
            'scheduler': dict(type='MultiStepLR', milestones=[600000],
                              gamma=0.5),
            'total_iter': 4, 'warmup_iter': -1,
            'gan_opt': dict(type='GANLoss', gan_type='wgan_softplus',
                            loss_weight=1.0),
            'r1_reg_weight': 10, 'path_reg_weight': 2,
            'net_g_reg_every': 1, 'net_d_reg_every': 1,
            'mixing_prob': 0.9, 'path_batch_shrink': 2},
        'val': {'num_val_samples': 4},
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 100}}
    opt['train'].update(train)
    return opt


def jax_engine(opt, params_g, noises_g, params_d):
    """The JAX StyleGAN2 engine of ``opt`` set up as
    tests/test_torch_gan.py sets up its GAN engines: a shell with the given
    networks' parameters, its own optimizers, schedules and jitted steps
    (``_build_steps``), on one device, and its draws from
    ``RandomState(seed + 7)`` in its ``__init__``'s order."""
    from edvr_tpu.archs import define_network as jax_define
    from edvr_tpu.models import create_model as _  # noqa: F401 (registers)
    from edvr_tpu.models.losses import build_loss as jax_build_loss
    from edvr_tpu.utils.registry import MODEL_REGISTRY as JAX_MODELS
    eng = object.__new__(JAX_MODELS.get('StyleGAN2Model'))
    eng.opt, eng.schedulers, eng.log_dict = opt, {}, {}
    eng.replicate = lambda tree: tree
    eng.eval_params = lambda tree: tree
    eng.net_g = jax_define(opt['network_g'])
    eng.net_d = jax_define(opt['network_d'])
    eng.num_style_feat = opt['network_g']['num_style_feat']
    eng._rng = np.random.RandomState(opt['manual_seed'] + 7)
    eng._noise_key = jax.random.PRNGKey(opt['manual_seed'] + 11)
    eng.params_g, eng.noises_g, eng.params_d = params_g, noises_g, params_d
    eng.fixed_sample = jnp.asarray(eng._rng.randn(
        opt['val']['num_val_samples'], eng.num_style_feat).astype(
            np.float32))
    eng.params_g_ema = jax.tree_util.tree_map(jnp.copy, params_g)
    train = opt['train']
    eng.cri_gan = jax_build_loss(train['gan_opt'])
    for k in ('r1_reg_weight', 'path_reg_weight', 'net_g_reg_every',
              'net_d_reg_every', 'mixing_prob', 'path_batch_shrink'):
        setattr(eng, k, train[k])
    eng.mean_path_length = jnp.float32(0.)
    eng.setup_optimizers()
    eng.setup_schedulers()
    eng._build_steps()
    return eng


def zero_noise(monkeypatch, model):
    """Zero injected noise in both engines: JAX's drawn noise (the only
    ``jax.random.normal`` of its steps; the path noise is numpy's) and the
    port generator's."""
    monkeypatch.setattr(jax.random, 'normal',
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    forward = model.net_g.forward

    def forward_zero_noise(styles, **kw):
        b = styles[0].shape[0]
        kw['noise'] = [torch.zeros(b, 1, 2**((i + 5) // 2),
                                   2**((i + 5) // 2))
                       for i in range(model.net_g.num_layers)]
        return forward(styles, **kw)

    monkeypatch.setattr(model.net_g, 'forward', forward_zero_noise)


@pytest.fixture(scope='module')
def engine_pair(tmp_path_factory):
    """One iteration of both engines (D, R1, G, path length, EMA) from the
    same networks and real batch, zero noise in both; returns (JAX engine,
    port engine, logs, the port's parameters before the iteration)."""
    mp = pytest.MonkeyPatch()
    opt = sg2_opt()
    # an initial state's zero noise strengths and stored noises
    _, params_g, noises_g = seeded_g(G_SMALL, 13, noise_std=0.,
                                     strength_std=0.)
    _, params_d = seeded_d(D_SMALL, 14)
    model = create_model(dict(parse_dict(
        json.loads(json.dumps(opt)), is_train=True,
        root=str(tmp_path_factory.mktemp('sg2'))), device='cpu'))
    state_g = jax_params_to_state_dict(_tree(params_g),
                                       noises=_tree(noises_g))
    model.net_g.load_state_dict(state_g, strict=True)
    model.net_g_ema.load_state_dict(state_g, strict=True)
    model.net_d.load_state_dict(jax_params_to_state_dict(_tree(params_d)),
                                strict=True)
    try:
        zero_noise(mp, model)
        jmodel = jax_engine(opt, params_g, noises_g, params_d)
        real = (np.random.RandomState(15).rand(4, 16, 16, 3) * 2 - 1).astype(
            np.float32)
        jmodel.real_img = jnp.asarray(real)
        jmodel.optimize_parameters(1)
        model.feed_data({'gt': _nchw(real)})
        model.optimize_parameters(1)
    finally:
        mp.undo()
    return jmodel, model, state_g


def test_engine_iteration_matches_jax(engine_pair):
    """The log (JAX's keys), D's and G's parameters, the EMA and the mean
    path length after an iteration that takes every branch: both engines
    drew the same latents, mixing and path noise from ``RandomState(7)``."""
    jmodel, model, state_g = engine_pair
    jlog = {k: float(v) for k, v in jmodel.log_dict.items()}
    log = model.get_current_log()
    assert set(log) == set(jlog) == {'l_d', 'real_score', 'fake_score',
                                     'l_d_r1', 'l_g', 'l_g_path',
                                     'path_length'}
    for k in jlog:
        np.testing.assert_allclose(log[k], jlog[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(model.mean_path_length),
                               float(jmodel.mean_path_length), rtol=1e-5)
    for net, jparams in ((model.net_g, jmodel.params_g),
                         (model.net_d, jmodel.params_d),
                         (model.net_g_ema, jmodel.params_g_ema)):
        want = jax_params_to_state_dict(_tree(jparams))
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
    moved = [n for n, p in model.net_g.named_parameters()
             if not torch.equal(p.detach(), state_g[n])]
    assert len(moved) > len(state_g) // 2
    ema = dict(model.net_g_ema.named_parameters())
    assert all(not torch.equal(ema[n], p) for n, p in
               model.net_g.named_parameters() if n in moved)
    # both engines' generators stayed in step
    assert model.rng.randint(1 << 30) == jmodel._rng.randint(1 << 30)


def test_engine_validation_grid_matches_jax(engine_pair, tmp_path):
    """The written grid of the EMA generator's fixed samples (their noise
    strengths are zero): JAX's ``tensor2img`` of the same output tiles it
    bit for bit, and JAX's own output within one level."""
    from edvr_tpu.utils import tensor2img as jax_tensor2img
    jmodel, model, _ = engine_pair
    jout, _ = jax.jit(lambda v, z: jmodel.net_g.apply(
        v, [z], randomize_noise=False))(
            {'params': jmodel.params_g_ema, 'noises': jmodel.noises_g},
            jmodel.fixed_sample)
    with torch.no_grad():
        out, _ = model.net_g_ema([model.fixed_sample],
                                 randomize_noise=False)
    assert _rel(_nhwc(out), jout) <= JAX_TOL
    model.opt['path']['visualization'] = str(tmp_path)
    model.nondist_validation(None, 1, None, True)
    grid = cv2.imread(str(tmp_path / 'train' / 'train_1.png'))
    assert grid.shape == (2 * 18 + 2, 2 * 18 + 2, 3)
    want = jax_tensor2img(np.asarray(jout), min_max=(-1, 1))
    np.testing.assert_array_equal(
        grid, jax_tensor2img(_nhwc(out), min_max=(-1, 1)))
    assert np.abs(grid.astype(int) - want).max() <= 1


@pytest.mark.parametrize('b', [1, 2, 5, 9])
def test_tensor2img_grid_matches_jax(b):
    """A batch tiles into JAX's grid, bit for bit in uint8; gray too."""
    from edvr_tpu.utils import tensor2img as jax_tensor2img
    from edvr_tpu_torch.utils import tensor2img
    x = np.random.RandomState(b).randn(b, 7, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tensor2img(_nchw(x), min_max=(-1, 1)),
        jax_tensor2img(x, min_max=(-1, 1)))
    np.testing.assert_array_equal(tensor2img(_nchw(x[..., :1])),
                                  jax_tensor2img(x[..., :1]))


def test_engine_refusals_and_save(tmp_path):
    with pytest.raises(NotImplementedError,
                       match='mixed_precision is only supported'):
        create_model(dict(parse_dict(sg2_opt(mixed_precision='bf16'),
                                     is_train=True, root=str(tmp_path)),
                          device='cpu'))
    opt = parse_dict(sg2_opt(), is_train=True, root=str(tmp_path))
    opt['train']['optim_d'] = dict(type='SGD', lr=1e-3)
    with pytest.raises(NotImplementedError, match='SGD'):
        create_model(dict(opt, device='cpu'))
    model = create_model(dict(parse_dict(sg2_opt(), is_train=True,
                                         root=str(tmp_path)), device='cpu'))
    model.save(0, 3)
    ckpt = torch.load(osp.join(model.opt['path']['models'], 'net_g_3.pth'),
                      weights_only=True)
    assert set(ckpt) == {'params', 'params_ema'}
    assert osp.exists(osp.join(model.opt['path']['models'], 'net_d_3.pth'))
    state = torch.load(osp.join(model.opt['path']['training_states'],
                                '3.state'), weights_only=True)
    assert set(state['optimizers']) == {'optimizer_g', 'optimizer_d'}
    group = model.optimizer_g.param_groups[0]
    assert group['betas'] == (0.0, 0.99**0.5) and group['eps'] == 1e-8
    np.testing.assert_allclose(model.get_current_learning_rate(1),
                               [0.5e-4, 0.5e-4])


# ---------------------------------------------------------------------- #
# data, remaps, the CLI
# ---------------------------------------------------------------------- #
def write_ffhq(monkeypatch, root, n, size, seed=0):
    """``n`` seeded PNGs named as FFHQ's first ``n``, and ``FFHQDataset``
    made to list only those (it lists FFHQ's 70,000 names, which
    ``test_ffhq_dataset_matches_jax`` checks)."""
    from edvr_tpu_torch.data import ffhq_dataset
    monkeypatch.setattr(ffhq_dataset, 'FFHQ_SIZE', n)
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        cv2.imwrite(osp.join(root, f'{i:08d}.png'),
                    rng.randint(0, 256, (size, size, 3), np.uint8))
    return root


def test_ffhq_dataset_matches_jax(tmp_path):
    from edvr_tpu.data.ffhq_dataset import FFHQDataset as Jax
    from edvr_tpu_torch.data import create_dataset
    from edvr_tpu_torch.data.ffhq_dataset import FFHQDataset
    rng = np.random.RandomState(0)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f'{i:08d}.png'),
                    rng.randint(0, 256, (12, 12, 3), np.uint8))
    opt = dict(name='FFHQ', type='FFHQDataset', phase='train',
               dataroot_gt=str(tmp_path), io_backend=dict(type='disk'),
               use_hflip=True, mean=[0.5, 0.4, 0.3], std=[0.5, 0.6, 0.7])
    ours = FFHQDataset(dict(opt), rng=random.Random(3))
    ref = Jax(dict(opt))
    assert len(ours) == len(ref) == 70000
    random.seed(3)
    flips = []
    for i in (0, 1, 2, 0, 1, 2):
        want, got = ref[i], ours[i]
        assert got['gt_path'] == want['gt_path']
        np.testing.assert_allclose(got['gt'].numpy(),
                                   np.moveaxis(want['gt'], -1, 0),
                                   rtol=1e-6, atol=1e-7)
        flips.append(bool((got['gt'] != ours.__class__(
            dict(opt, use_hflip=False))[i]['gt']).any()))
    assert any(flips) and not all(flips)
    with pytest.raises(NotImplementedError, match='A.9'):
        create_dataset(dict(opt, io_backend=dict(type='lmdb'),
                            dataroot_gt='ffhq.lmdb'))


def test_official_remaps_match_jax(tmp_path):
    """Official-keyed G and D (the inverse maps of
    tests/test_convert_official.py) through the port's and the JAX remap,
    then the port's command on an official ``.pth`` of G, loaded
    strictly."""
    from edvr_tpu.convert import official as jofficial
    from edvr_tpu_torch.convert import official
    from test_convert_official import sg2_g_to_official
    for name, source, to_official, jname in (
            ('g', 'StyleGAN2G', sg2_g_to_official, 'StyleGAN2Generator'),
            ('d', 'StyleGAN2D', lambda k: k.replace('conv_body', 'convs'),
             'StyleGAN2Discriminator')):
        data = np.load(osp.join(GOLDEN_DIR, f'arch_stylegan2_{name}.npz'))
        prefix = 'g.' if name == 'g' else ''
        state = {to_official(k[len(prefix):]): torch.from_numpy(data[k])
                 for k in data.files if not k.startswith('__')}
        state['unknown.weight'] = torch.zeros(1)
        got = official.REMAPPERS[source](state)
        want = jofficial.REMAPPERS[jname](state)
        assert set(got[0]) == set(want[0]) and got[1] == want[1] == [
            'unknown.weight']
        assert set(got[0]) == {k[len(prefix):] for k in data.files
                               if not k.startswith('__')}
        pth = str(tmp_path / f'official_{name}.pth')
        torch.save({'g_ema': {k: v for k, v in state.items()
                              if k != 'unknown.weight'}}, pth)
        out = str(tmp_path / f'net_{name}.pth')
        official.main(['--source', source, '--pth', pth, '--param_key',
                       'g_ema', '--out', out])
        config = json.loads(bytes(data['__config__']).decode())
        config.pop('__mix_inject__', None)
        define_network(config).load_state_dict(
            torch.load(out, weights_only=True)['params'], strict=True)


def test_train_cli_checkpoint_resume(tmp_path, monkeypatch):
    """A tiny StyleGAN2 config through ``python -m edvr_tpu_torch.train
    --device cpu`` on seeded FFHQ-named PNGs: 4 iterations (R1 at 2 and 4,
    path length at 4) with JAX's log keys, checkpoints and validation grids
    at 2 and 4; ``net_g_2.pth`` loads into G and its EMA; resumed from
    iteration 2, the run takes iterations 3 and 4 with the optimizers'
    state carried (their Adam step counts end as the whole run's)."""
    from edvr_tpu_torch.train import main
    monkeypatch.chdir(tmp_path)
    root = write_ffhq(monkeypatch, str(tmp_path / 'ffhq'), 4, 16)
    opt = sg2_opt(net_g_reg_every=4, net_d_reg_every=2)
    opt.update(
        name='sg2_cli',
        datasets=dict(train=dict(
            name='FFHQ', type='FFHQDataset', dataroot_gt=root,
            io_backend=dict(type='disk'), use_hflip=True,
            mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5], use_shuffle=True,
            num_worker_per_gpu=0, batch_size_per_gpu=4,
            dataset_enlarge_ratio=1, prefetch_mode=None)),
        path=dict(pretrain_network_g=None, strict_load_g=True,
                  resume_state=None),
        val=dict(val_freq=2, num_val_samples=4, save_img=True),
        logger=dict(print_freq=1, save_checkpoint_freq=2,
                    use_tb_logger=False))
    yml = str(tmp_path / 'sg2.yml')
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f)
    full = main(['-opt', yml, '--device', 'cpu'])
    exp = tmp_path / 'experiments' / 'sg2_cli'
    assert set(full.get_current_log()) == {
        'l_d', 'real_score', 'fake_score', 'l_d_r1', 'l_g', 'l_g_path',
        'path_length'}
    assert all(np.isfinite(v) for v in full.get_current_log().values())
    for it in (2, 4):
        grid = cv2.imread(str(exp / 'visualization' / 'train' /
                              f'train_{it}.png'))
        assert grid.shape == (2 * 18 + 2, 2 * 18 + 2, 3)
    assert (exp / 'models' / 'net_g_latest.pth').exists()

    def steps(model):
        return {name: {int(s['step']) for s in o.state.values()}
                for name, o in model.optimizers.items()}

    # every parameter steps in every update, as in the JAX engine
    assert steps(full) == {'optimizer_g': {5}, 'optimizer_d': {6}}

    ckpt = torch.load(str(exp / 'models' / 'net_g_2.pth'), weights_only=True)
    loaded = create_model(dict(parse_dict(dict(
        sg2_opt(), path=dict(pretrain_network_g=str(
            exp / 'models' / 'net_g_2.pth'))), is_train=True,
        root=str(tmp_path / 'load')), device='cpu'))
    for net, key in ((loaded.net_g, 'params'),
                     (loaded.net_g_ema, 'params_ema')):
        for k, v in net.state_dict().items():
            assert torch.equal(v, ckpt[key][k]), (key, k)
    assert any(not torch.equal(ckpt['params'][k], ckpt['params_ema'][k])
               for k in ckpt['params'] if 'noises' not in k)

    resumed = main(['-opt', yml, '--device', 'cpu', '--force_yml',
                    f'path:resume_state={exp}/training_states/2.state'])
    assert steps(resumed) == steps(full)
    assert all(np.isfinite(v) for v in resumed.get_current_log().values())


def test_shipped_yml_builds(tmp_path, monkeypatch):
    """``train_StyleGAN2_256_Cmul2_FFHQ.yml`` unchanged through the train
    CLI's option parsing, loaders and ``create_model`` at full width, with
    one cut: its lmdb backend is refused (A.9), so the data is a disk tree;
    then one real batch fed (global batch 24: 3 x 8 GPUs in one process)
    and the G forward's shape."""
    from edvr_tpu_torch.train import (create_train_val_dataloader,
                                      parse_options, train_cudnn_env)
    from edvr_tpu_torch.utils import get_root_logger
    monkeypatch.chdir(tmp_path)
    opt = parse_options(True, ['-opt', SHIPPED, '--device', 'cpu'])
    with pytest.raises(NotImplementedError, match='A.9'):
        create_train_val_dataloader(opt, get_root_logger())
    root = write_ffhq(monkeypatch, str(tmp_path / 'ffhq'), 2, 256)
    opt = parse_options(True, [
        '-opt', SHIPPED, '--device', 'cpu', '--force_yml',
        'datasets:train:io_backend={type: disk}',
        f'datasets:train:dataroot_gt={root}',
        'datasets:train:num_worker_per_gpu=0'])
    loader, _, val_loader, _, total = create_train_val_dataloader(
        opt, get_root_logger())
    assert val_loader is None and total == 800000
    assert train_cudnn_env(opt['network_g']) == {}
    model = create_model(opt)
    assert type(model).__name__ == 'StyleGAN2Model'
    # every parameter of JAX's networks of the same options, by shape
    for net, key in ((model.net_g, 'network_g'), (model.net_d, 'network_d')):
        size = opt[key]['out_size']
        jnet = jax_net(opt[key])
        args = ([jnp.zeros((1, 512))],) if key == 'network_g' else (
            jnp.zeros((4, size, size, 3)),)
        shapes = jax.eval_shape(lambda k: jnet.init(k, *args),
                                jax.random.PRNGKey(0))['params']
        want = jax_params_to_state_dict(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes))
        assert {k: tuple(v.shape) for k, v in want.items()} == {
            k: tuple(p.shape) for k, p in net.named_parameters()}
    batch = next(iter(loader))
    model.feed_data(batch)
    assert tuple(model.real_img.shape) == (24, 3, 256, 256)
    assert model.real_img.min() >= -1 and model.real_img.max() <= 1
    group = model.optimizer_d.param_groups[0]
    np.testing.assert_allclose(group['lr'], 0.002 * 16 / 17)
    np.testing.assert_allclose(group['betas'], (0.0, 0.99**(16 / 17)))
