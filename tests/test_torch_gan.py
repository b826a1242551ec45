"""The port's GAN slice against the JAX package, on the CPU at the goldens'
tiny widths: ``GANLoss``, ``WeightedTVLoss``, ``PerceptualLoss`` and the VGG
feature extractor, ``VGGStyleDiscriminator128`` (golden, train and eval
mode, flax's running statistics), one SRGAN / ESRGAN / VideoGAN G + D step
against the JAX engine (losses, both networks' parameters, D's BatchNorm
statistics), the ``net_d_init_iters`` gate, the refusals, save and resume,
and the train CLI on a tiny MSRGAN config.

The JAX engine is built with ``network_d.train: true``: as shipped it
builds the discriminator with flax's ``train`` False, so its BatchNorm
normalises by the running statistics and never moves them
(``test_discriminator_matches_jax[eval]``); the port
trains BatchNorm as BasicSR does and the JAX engine's docstring describes.
"""

import glob
import json
import os
import os.path as osp

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from edvr_tpu.models import losses as jlosses
from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.archs.discriminator_arch import frozen_running_stats
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.models import create_model, losses
from edvr_tpu_torch.utils.options import parse_dict
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_DIR = osp.join(osp.dirname(__file__), 'data', 'golden')
# one step's parameters, as tests/test_torch_train.py holds the optimizer
PARAM_ATOL = 1e-6
# losses (the second step's from parameters that differ by up to
# PARAM_ATOL) and BatchNorm statistics (variances of order 1; flax takes
# the variance as E[x^2] - E[x]^2, torch.var_mean in two passes): float32
# on both sides, other conv algorithms and summation orders
LOSS_RTOL = 1e-4
STATS_RTOL = 1e-5
STATS_ATOL = 1e-6


def _nhwc(t):
    return np.moveaxis(np.asarray(t), -3, -1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def seeded_variables(net, sample, seed):
    """A flax module's variables by ``jax.eval_shape`` of its init (nothing
    compiled or run eagerly), the params drawn from a numpy seed: kernels
    N(0, 1 / fan_in), BatchNorm scales 1 + N(0, 0.01), biases N(0, 0.01),
    DCN offsets N(0, 0.0025) so that the samples move; ``batch_stats``
    as flax initialises them (mean 0, variance 1)."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), sample)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        leaf = name.rsplit('/', 1)[-1]
        if 'conv_offset' in name:
            a = rng.randn(*s.shape) * 0.05
        elif leaf == 'scale':
            a = 1 + rng.randn(*s.shape) * 0.1
        elif len(s.shape) == 1:
            a = rng.randn(*s.shape) * 0.1
        else:
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return a.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes['params'])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: np.full(s.shape, float(p[-1].key == 'var'), np.float32),
        dict(shapes).get('batch_stats', {}))
    return params, stats


def jax_perceptual(opt, seed=0):
    """``edvr_tpu``'s PerceptualLoss with a seeded VGG, set up without its
    eager VGG init (``edvr_tpu/models/losses.py:223-254``)."""
    from edvr_tpu.archs.vgg_arch import VGGFeatureExtractor as JaxVGG
    loss = object.__new__(jlosses.PerceptualLoss)
    loss.perceptual_weight = opt.get('perceptual_weight', 1.0)
    loss.style_weight = opt.get('style_weight', 0.)
    loss.layer_weights = opt['layer_weights']
    loss.criterion_type = opt.get('criterion', 'l1')
    loss.vgg = JaxVGG(layer_name_list=tuple(opt['layer_weights']),
                      vgg_type=opt.get('vgg_type', 'vgg19'),
                      use_input_norm=opt.get('use_input_norm', True),
                      range_norm=opt.get('range_norm', False))
    params, _ = seeded_variables(loss.vgg, jnp.zeros((1, 32, 32, 3)), seed)
    loss.vgg_variables = {'params': params}
    return loss


# ---------------------------------------------------------------------- #
# losses
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('is_disc', [True, False])
@pytest.mark.parametrize('target_is_real', [True, False])
@pytest.mark.parametrize('gan_type', ['vanilla', 'lsgan', 'wgan',
                                      'wgan_softplus', 'hinge'])
def test_gan_loss_matches_jax(gan_type, target_is_real, is_disc):
    x = np.random.RandomState(0).randn(4, 1).astype(np.float32) * 2
    opt = dict(type='GANLoss', gan_type=gan_type, real_label_val=0.9,
               fake_label_val=0.1, loss_weight=0.3)
    ours, ref = losses.build_loss(opt), jlosses.build_loss(opt)
    xt = torch.from_numpy(x).requires_grad_()
    got = ours(xt, target_is_real, is_disc=is_disc)
    got.backward()
    want, gwant = jax.value_and_grad(
        lambda v: ref(v, target_is_real, is_disc=is_disc))(jnp.asarray(x))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant),
                               rtol=1e-5, atol=1e-8)


def test_gan_loss_refuses_unknown_type():
    with pytest.raises(NotImplementedError, match='GAN type'):
        losses.build_loss(dict(type='GANLoss', gan_type='relativistic'))


@pytest.mark.parametrize('weighted', [False, True])
def test_weighted_tv_loss_matches_jax(weighted):
    rng = np.random.RandomState(1)
    pred, weight = (rng.rand(2, 9, 7, 3).astype(np.float32)
                    for _ in range(2))
    ours = losses.build_loss(dict(type='WeightedTVLoss', loss_weight=0.5))
    ref = jlosses.build_loss(dict(type='WeightedTVLoss', loss_weight=0.5))
    got = ours(_nchw(pred), _nchw(weight) if weighted else None)
    want = ref(jnp.asarray(pred), jnp.asarray(weight) if weighted else None)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------- #
# the VGG feature extractor and the perceptual loss
# ---------------------------------------------------------------------- #
def _golden_vgg_state(data):
    state = {k: torch.from_numpy(data[k]) for k in data.files
             if k.startswith('vgg_net.')}
    # the reference's ImageNet constants are the port's fixed buffers
    np.testing.assert_allclose(data['mean'].ravel(), [0.485, 0.456, 0.406],
                               rtol=1e-6)
    np.testing.assert_allclose(data['std'].ravel(), [0.229, 0.224, 0.225],
                               rtol=1e-6)
    return state


def test_vgg_extractor_golden():
    data = np.load(osp.join(GOLDEN_DIR, 'vgg_extractor.npz'))
    net = define_network(dict(type='VGGFeatureExtractor',
                              layer_name_list=['relu2_2', 'conv4_4']))
    net.load_state_dict(_golden_vgg_state(data), strict=True)
    with torch.no_grad():
        feats = net(torch.from_numpy(data['__input__']))
    for layer in ('relu2_2', 'conv4_4'):
        np.testing.assert_allclose(feats[layer].numpy(),
                                   data[f'__feat_{layer}__'], rtol=3e-5,
                                   atol=1e-3, err_msg=layer)


def test_perceptual_loss_golden(tmp_path):
    """The golden's VGG written as torchvision's ``vgg19.pth``
    (``features.<index>``) and read by the loss from that path."""
    from edvr_tpu_torch.archs.vgg_arch import NAMES
    data = np.load(osp.join(GOLDEN_DIR, 'perceptual_loss.npz'))
    idx_of = {n: i for i, n in enumerate(NAMES['vgg19'])}
    state = {}
    for k, v in _golden_vgg_state(data).items():
        _, layer, pname = k.split('.')
        state[f'features.{idx_of[layer]}.{pname}'] = v
    state['classifier.0.weight'] = torch.zeros(2, 2)  # ignored
    path = str(tmp_path / 'vgg19.pth')
    torch.save(state, path)
    loss = losses.build_loss(dict(
        type='PerceptualLoss', layer_weights={'relu2_2': 0.5, 'conv4_4': 1.0},
        vgg_type='vgg19', perceptual_weight=1.0, style_weight=0.7,
        criterion='l1', vgg_pretrain_path=path))
    lp, ls = loss(torch.from_numpy(data['__a__']),
                  torch.from_numpy(data['__b__']))
    assert abs(lp.item() - float(data['__lp__'])) < 2e-4
    assert abs(ls.item() - float(data['__ls__'])) < 2e-4


@pytest.mark.parametrize('vgg_type,layers,kw', [
    ('vgg19', ('relu1_2', 'conv2_2'), {}),
    ('vgg16', ('relu2_1',), dict(range_norm=True, use_input_norm=False)),
    ('vgg11', ('conv3_1',), dict(remove_pooling=True)),
    ('vgg13', ('relu2_2',), dict(pooling_stride=1)),
    ('vgg16_bn', ('relu2_1',), {}),
])
def test_vgg_extractor_matches_jax(vgg_type, layers, kw):
    """Each VGG type and option against the JAX module; the bn variant's
    batch norms run on their running statistics in train mode too, as the
    JAX module's always do."""
    from edvr_tpu.archs.vgg_arch import VGGFeatureExtractor as JaxVGG
    x = np.random.RandomState(2).rand(1, 20, 20, 3).astype(np.float32)
    jnet = JaxVGG(layer_name_list=layers, vgg_type=vgg_type, **kw)
    params, stats = seeded_variables(jnet, jnp.asarray(x), 1)
    # non-trivial running statistics for the bn variant
    stats = jax.tree_util.tree_map(lambda a: a + 0.5, stats)
    want = jax.jit(lambda v, a: jnet.apply(v, a))(
        {'params': params, 'batch_stats': stats} if stats else
        {'params': params}, jnp.asarray(x))
    net = define_network(dict(type='VGGFeatureExtractor',
                              layer_name_list=layers, vgg_type=vgg_type,
                              **kw))
    net.load_state_dict(jax_params_to_state_dict(_tree(params), _tree(stats),
                                                 vgg_type=vgg_type))
    net.train()
    with torch.no_grad():
        got = net(_nchw(x))
    for layer in layers:
        np.testing.assert_allclose(_nhwc(got[layer].numpy()),
                                   np.asarray(want[layer]), rtol=1e-5,
                                   atol=1e-5, err_msg=layer)


@pytest.mark.parametrize('criterion', ['l1', 'l2', 'fro'])
def test_perceptual_loss_matches_jax(criterion):
    """Perceptual and style terms and the input's gradient; the JAX loss's
    random VGG carried into the port's."""
    opt = dict(type='PerceptualLoss',
               layer_weights={'relu1_2': 0.3, 'conv2_2': 1.0},
               vgg_type='vgg19', perceptual_weight=0.8, style_weight=0.6,
               criterion=criterion, vgg_pretrain_path='/nonexistent.pth')
    ref = jax_perceptual(opt)
    ours = losses.build_loss(dict(opt))
    ours.vgg.load_state_dict(jax_params_to_state_dict(
        _tree(ref.vgg_variables['params']), vgg_type='vgg19'))
    rng = np.random.RandomState(3)
    x, gt = (rng.rand(2, 24, 24, 3).astype(np.float32) for _ in range(2))

    def jloss(v):
        lp, ls = ref(v, jnp.asarray(gt))
        return lp + ls, (lp, ls)

    (_, (jlp, jls)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    lp, ls = ours(xt, _nchw(gt))
    (lp + ls).backward()
    np.testing.assert_allclose(lp.item(), float(jlp), rtol=1e-5)
    np.testing.assert_allclose(ls.item(), float(jls), rtol=1e-5)
    g = _nhwc(xt.grad.numpy())
    np.testing.assert_allclose(g, np.asarray(jgrad), rtol=0,
                               atol=1e-5 * np.abs(jgrad).max())
    assert not any(p.requires_grad for p in ours.vgg.parameters())


# ---------------------------------------------------------------------- #
# the discriminator
# ---------------------------------------------------------------------- #
def test_discriminator_golden():
    data = np.load(osp.join(GOLDEN_DIR, 'arch_vggstyle_d128.npz'))
    net = define_network(json.loads(bytes(data['__config__']).decode()))
    net.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files
                         if not k.startswith('__')}, strict=True)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(data['__input__']))
    np.testing.assert_allclose(out.numpy(), data['__output__'], atol=3e-4)
    with pytest.raises(ValueError, match='128x128'):
        net(torch.zeros(1, 3, 64, 64))


@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_discriminator_matches_jax(mode):
    """Output, and in train mode the running statistics after two forwards
    against flax's ``batch_stats`` (biased variance, momentum 0.9); torch's
    own update (unbiased variance) misses them."""
    from edvr_tpu.archs.discriminator_arch import \
        VGGStyleDiscriminator128 as JaxD
    rng = np.random.RandomState(4)
    xs = [rng.rand(3, 128, 128, 3).astype(np.float32) for _ in range(2)]
    jnet = JaxD(num_in_ch=3, num_feat=4, train=mode == 'train')
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(2), jnp.asarray(xs[0]))
    # non-trivial running statistics for the eval-mode case
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(rng.randn(*a.shape)).astype(np.float32) + 0.5,
        _tree(variables['batch_stats']))
    params, first = _tree(variables['params']), stats
    net = define_network(dict(type='VGGStyleDiscriminator128', num_in_ch=3,
                              num_feat=4))
    net.load_state_dict(jax_params_to_state_dict(params, stats), strict=True)
    net.train(mode == 'train')
    # torch's own BatchNorm2d on what bn4_1 (4x4 px) reads
    plain = torch.nn.BatchNorm2d(32).train()
    plain.load_state_dict(net.bn4_1.state_dict())

    def feed_plain(module, args):
        plain(args[0])

    net.bn4_1.register_forward_pre_hook(feed_plain)
    apply = jax.jit(lambda v, x: jnet.apply(v, x, mutable=['batch_stats']))
    for x in xs:
        out, upd = apply({'params': params, 'batch_stats': stats},
                         jnp.asarray(x))
        stats = _tree(upd['batch_stats'])
        with torch.no_grad():
            got = net(_nchw(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-4,
                                   atol=1e-5)
    want = jax_params_to_state_dict(params, stats)
    for name, buf in net.named_buffers():
        if 'running' in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=name)
    if mode == 'eval':
        # the finding behind the JAX engine's ``network_d.train: true``
        # below: the JAX discriminator's ``train`` defaults to False, as a
        # shipped YAML's network_d builds it, and then a
        # ``mutable=['batch_stats']`` forward leaves its statistics as
        # they were
        assert not JaxD(num_in_ch=3, num_feat=4).train
        np.testing.assert_array_equal(want['bn4_1.running_var'].numpy(),
                                      jax_params_to_state_dict(
                                          params, first)['bn4_1.running_var'])
    if mode == 'train':
        # the unbiased update misses flax's by ~2% of the variance here
        gap = (plain.running_var - net.bn4_1.running_var).abs().max()
        assert gap > 100 * STATS_ATOL
        assert int(net.bn0_1.num_batches_tracked) == 2
        before = net.bn0_1.running_mean.clone()
        with torch.no_grad(), frozen_running_stats(net):
            net(_nchw(xs[0]))
        assert torch.equal(before, net.bn0_1.running_mean)


# ---------------------------------------------------------------------- #
# the engines
# ---------------------------------------------------------------------- #
EDVR_SMALL = dict(type='EDVR', num_in_ch=3, num_out_ch=3, num_feat=8,
                  num_frame=5, deformable_groups=2, num_extract_block=1,
                  num_reconstruct_block=1, center_frame_idx=None,
                  hr_in=False, with_predeblur=False, with_tsa=True)


def gan_opt(model_type, **train):
    g = (EDVR_SMALL if model_type == 'VideoGANModel' else
         dict(type='MSRResNet', num_in_ch=3, num_out_ch=3, num_feat=8,
              num_block=1, upscale=4))
    opt = {
        'name': 'gan_step', 'model_type': model_type, 'scale': 4,
        'num_gpu': 1, 'manual_seed': 0,
        'network_g': dict(g),
        'network_d': dict(type='VGGStyleDiscriminator128', num_in_ch=3,
                          num_feat=4),
        'path': {'pretrain_network_g': None, 'strict_load_g': True},
        'train': {
            # Adam's first step is lr * g / (|g| + eps) per entry, so an
            # entry near 0 (a cancellation) turns its float32 rounding
            # (~1e-8 here, two conv libraries) into a step of up to lr;
            # eps 1e-4 bounds that to lr * 1e-8 / eps, well inside
            # PARAM_ATOL, and leaves larger entries' steps at ~lr
            'optim_g': dict(type='Adam', lr=1e-4, weight_decay=1e-4,
                            betas=[0.9, 0.99], eps=1e-4),
            'optim_d': dict(type='Adam', lr=2e-4, weight_decay=0,
                            betas=[0.9, 0.99], eps=1e-4),
            'scheduler': dict(type='MultiStepLR', milestones=[2],
                              gamma=0.5),
            'total_iter': 4, 'warmup_iter': -1,
            # weights well above the shipped 1e-2 / 5e-3, so that no
            # gradient of the tiny networks sits near Adam's eps, where
            # float32 rounding would decide the step's size
            'pixel_opt': dict(type='L1Loss', loss_weight=1.0,
                              reduction='mean'),
            'gan_opt': dict(type='GANLoss', gan_type='vanilla',
                            real_label_val=1.0, fake_label_val=0.0,
                            loss_weight=0.5),
            'net_d_iters': 1, 'net_d_init_iters': 0,
        },
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 100},
    }
    if model_type != 'VideoGANModel':
        opt['train']['perceptual_opt'] = dict(
            type='PerceptualLoss', layer_weights={'conv1_2': 1.0},
            vgg_type='vgg19', perceptual_weight=1.0,
            style_weight=0.5 if model_type == 'SRGANModel' else 0,
            criterion='l1', vgg_pretrain_path='/nonexistent.pth')
    if model_type == 'VideoGANModel':
        # EDVR's gradients agree with JAX's to ~1e-4 of each tensor's
        # largest entry, not per entry (tests/test_torch_grad.py, STEP_TOL:
        # DCN samples within rounding of an integer), which Adam's
        # per-entry normalisation would blow up to a good part of a step;
        # with eps 1 the first step is ~lr * g (|g| < 1 here), so
        # PARAM_ATOL holds G's step to that gradient agreement
        for name in ('optim_g', 'optim_d'):
            opt['train'][name]['eps'] = 1.0
    opt['train'].update(train)
    return opt


def port_model(opt, root, **over):
    opt = parse_dict(json.loads(json.dumps(opt)), is_train=True, root=root)
    opt['device'] = 'cpu'
    opt['path'].update(over)
    return create_model(opt)


def batches(model_type, n, seed=6):
    rng = np.random.RandomState(seed)
    lq_shape = (2, 5, 32, 32, 3) if model_type == 'VideoGANModel' else (
        2, 32, 32, 3)
    return [dict(lq=rng.rand(*lq_shape).astype(np.float32),
                 gt=rng.rand(2, 128, 128, 3).astype(np.float32))
            for _ in range(n)]


def to_port(batch):
    return {k: _nchw(v) for k, v in batch.items()}


def jax_engine(opt):
    """The JAX GAN engine of ``opt['model_type']`` set up as
    tests/test_torch_train.py sets up the JAX engine: a shell with seeded
    networks (``seeded_variables``), the engine's own optimizers,
    schedules and jitted step (``_make_gan_train_step``), on one device.
    Its discriminator is built with ``train: true``."""
    from edvr_tpu.archs import define_network as jax_define
    from edvr_tpu.models import create_model as _  # noqa: F401 (registers)
    from edvr_tpu.utils.registry import MODEL_REGISTRY as JAX_MODELS
    eng = object.__new__(JAX_MODELS.get(opt['model_type']))
    eng.opt, eng.schedulers, eng.log_dict = opt, {}, {}
    eng.replicate = lambda tree: tree
    video = opt['model_type'] == 'VideoGANModel'
    eng.net_g = jax_define(opt['network_g'])
    eng.params_g, _ = seeded_variables(
        eng.net_g, jnp.zeros((1, 5, 32, 32, 3) if video else
                             (1, 32, 32, 3)), 7)
    eng.net_d = jax_define(dict(opt['network_d'], train=True))
    eng.params_d, eng.bstats_d = seeded_variables(
        eng.net_d, jnp.zeros((1, 128, 128, 3)), 8)
    train = opt['train']
    eng.cri_pix = jlosses.build_loss(train['pixel_opt'])
    eng.cri_perceptual = (jax_perceptual(train['perceptual_opt'])
                          if train.get('perceptual_opt') else None)
    eng.cri_gan = jlosses.build_loss(train['gan_opt'])
    eng.net_d_iters = train['net_d_iters']
    eng.net_d_init_iters = train['net_d_init_iters']
    eng.setup_optimizers()
    eng.setup_schedulers()
    eng._train_step = eng._make_gan_train_step()
    return eng


@pytest.mark.parametrize('model_type,init_iters', [
    ('SRGANModel', 0), ('SRGANModel', 1), ('ESRGANModel', 0),
    ('VideoGANModel', 0)])
def test_gan_step_matches_jax_engine(tmp_path, model_type, init_iters):
    """Two G + D steps of the port's engine against the JAX engine's from
    the same parameters and batches: the log, G's and D's parameters and
    D's running statistics. With ``net_d_init_iters`` 1, step 1 leaves G
    and its Adam state as they were and moves D, in both."""
    opt = gan_opt(model_type, net_d_init_iters=init_iters)
    jmodel = jax_engine(opt)
    model = port_model(opt, str(tmp_path))
    model.net_g.load_state_dict(jax_params_to_state_dict(
        _tree(jmodel.params_g)), strict=True)
    model.net_d.load_state_dict(jax_params_to_state_dict(
        _tree(jmodel.params_d), _tree(jmodel.bstats_d)), strict=True)
    if model.cri_perceptual is not None:
        model.cri_perceptual.vgg.load_state_dict(jax_params_to_state_dict(
            _tree(jmodel.cri_perceptual.vgg_variables['params']),
            vgg_type='vgg19'))
    g0 = {k: v.clone() for k, v in model.net_g.state_dict().items()}

    for it, batch in enumerate(batches(model_type, 2), start=1):
        jmodel.lq, jmodel.gt = jnp.asarray(batch['lq']), jnp.asarray(
            batch['gt'])
        jmodel.optimize_parameters(it)
        model.feed_data(to_port(batch))
        model.optimize_parameters(it)
        jlog = {k: float(v) for k, v in jmodel.log_dict.items()}
        log = model.get_current_log()
        assert set(log) == set(jlog), (sorted(log), sorted(jlog))
        for k in jlog:
            np.testing.assert_allclose(log[k], jlog[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=(it, k))
        if it == 1 and init_iters:
            for k, v in model.net_g.state_dict().items():
                assert torch.equal(v, g0[k]), k
            assert not model.optimizer_g.state
            assert model.optimizer_d.state
        want_g = jax_params_to_state_dict(_tree(jmodel.params_g))
        want_d = jax_params_to_state_dict(_tree(jmodel.params_d),
                                          _tree(jmodel.bstats_d))
        for net, want in ((model.net_g, want_g), (model.net_d, want_d)):
            for name, v in net.state_dict().items():
                if name.endswith('num_batches_tracked'):
                    continue
                stats = 'running' in name
                np.testing.assert_allclose(
                    v.numpy(), want[name].numpy(),
                    rtol=STATS_RTOL if stats else 0,
                    atol=STATS_ATOL if stats else PARAM_ATOL,
                    err_msg=(it, name))
    # G stepped once (init_iters 1) or twice; D's statistics moved by the
    # G-step forwards that counted, and by both D forwards of each step
    tracked = int(model.net_d.bn0_1.num_batches_tracked)
    assert tracked == 2 * 2 + (2 - init_iters)


def test_gan_refusals(tmp_path):
    with pytest.raises(NotImplementedError,
                       match='mixed_precision is only supported'):
        port_model(gan_opt('SRGANModel', mixed_precision='bf16'),
                   str(tmp_path))
    with pytest.raises(NotImplementedError, match='optimizer'):
        port_model(gan_opt('SRGANModel', optim_d=dict(type='SGD', lr=1)),
                   str(tmp_path))


def test_gan_save_resume_equals_uninterrupted(tmp_path):
    """4 straight steps == 2 steps, save, resume from the state and the
    run's own net_g / net_d, 2 steps: G, D (running statistics included)
    and both Adam states."""
    from edvr_tpu_torch.models.base_model import load_resume_state
    from edvr_tpu_torch.utils import check_resume
    data = [to_port(b) for b in batches('SRGANModel', 4)]
    opt = gan_opt('SRGANModel', perceptual_opt=None)

    def run(model, iters):
        for it in iters:
            model.feed_data(data[it - 1])
            model.optimize_parameters(it)

    ref = port_model(opt, str(tmp_path / 'a'))
    run(ref, range(1, 5))
    first = port_model(opt, str(tmp_path / 'b'))
    run(first, range(1, 3))
    first.save(0, 2)
    ckpt = torch.load(osp.join(first.opt['path']['models'], 'net_d_2.pth'),
                      weights_only=True)['params']
    assert 'bn4_1.running_var' in ckpt
    state_path = osp.join(first.opt['path']['training_states'], '2.state')
    ropt = parse_dict(json.loads(json.dumps(opt)), is_train=True,
                      root=str(tmp_path / 'b'))
    ropt['device'] = 'cpu'
    ropt['path']['resume_state'] = state_path
    state = load_resume_state(ropt)
    assert set(state['optimizers']) == {'optimizer_g', 'optimizer_d'}
    check_resume(ropt, state['iter'])
    resumed = create_model(ropt)
    resumed.resume_training(state)
    run(resumed, range(3, 5))
    for net in ('net_g', 'net_d'):
        want = getattr(ref, net).state_dict()
        for k, v in getattr(resumed, net).state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0,
                                       msg=f'{net}.{k}')


def _write_pairs(root, n=3, lq_hw=(32, 32), scale=4, seed=0):
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


def test_train_cli_msrgan(tmp_path, monkeypatch):
    """``python -m edvr_tpu_torch.train --device cpu`` on a tiny MSRGAN
    config: paired PNG crops, the G + D steps, checkpoints of both networks
    and the training state, a validation pass with PSNR and SSIM."""
    monkeypatch.chdir(tmp_path)
    from edvr_tpu_torch.train import main
    root = _write_pairs(str(tmp_path / 'pairs'))
    opt = gan_opt('SRGANModel')
    opt['train']['total_iter'] = 2
    opt['name'] = 'msrgan_tiny'
    opt['datasets'] = dict(
        train=dict(name='pairs', type='PairedImageDataset',
                   dataroot_gt=f'{root}/gt', dataroot_lq=f'{root}/lq',
                   filename_tmpl='{}', io_backend=dict(type='disk'),
                   gt_size=128, use_flip=True, use_rot=True,
                   use_shuffle=True, num_worker_per_gpu=0,
                   batch_size_per_gpu=2, dataset_enlarge_ratio=1,
                   prefetch_mode=None),
        val=dict(name='pairs_val', type='PairedImageDataset',
                 dataroot_gt=f'{root}/gt', dataroot_lq=f'{root}/lq',
                 io_backend=dict(type='disk')))
    opt['val'] = dict(val_freq=2, save_img=True, metrics=dict(
        psnr=dict(type='calculate_psnr', crop_border=4,
                  test_y_channel=False),
        ssim=dict(type='calculate_ssim', crop_border=4,
                  test_y_channel=False)))
    opt['logger'] = dict(print_freq=1, save_checkpoint_freq=2,
                         use_tb_logger=False)
    yml = str(tmp_path / 'msrgan.yml')
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    model = main(['-opt', yml, '--device', 'cpu'])
    exp = tmp_path / 'experiments' / 'msrgan_tiny'
    assert sorted(os.listdir(exp / 'models')) == [
        'net_d_2.pth', 'net_d_latest.pth', 'net_g_2.pth',
        'net_g_latest.pth']
    assert os.listdir(exp / 'training_states') == ['2.state']
    log = model.get_current_log()
    assert set(log) == {'l_g_pix', 'l_g_percep', 'l_g_style', 'l_g_gan',
                        'l_d_real', 'l_d_fake', 'out_d_real', 'out_d_fake'}
    assert all(np.isfinite(v) for v in log.values())
    assert set(model.metric_results) == {'psnr', 'ssim'}
    assert all(np.isfinite(v) for v in model.metric_results.values())
    assert len(glob.glob(str(exp / 'visualization' / '*' / '*_2.png'))) == 3
