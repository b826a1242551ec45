"""Two faults of the port against the JAX package, on the CPU.

C.8: a StyleGAN2 ``.ckpt`` written as the JAX engine writes it
(``edvr_tpu/models/stylegan2_model.py::save``: ``params`` and
``params_ema`` only, no stored noises) loads strictly into the port, whose
generator fills the absent ``noises.noise<i>`` with the JAX engine's values
(zeros), and samples as JAX does.

C.9: EDVR-L woTSA at full width (128 features, 5 + 40 blocks) from the same
weights takes three fp32 Adam steps in the JAX engine and in the port's CPU
path (``-m slow``): whether the loss grows on the card because of the port or
because of the seeded start.
"""

import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from edvr_tpu.models.base_model import dump_checkpoint
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.models import create_model
from edvr_tpu_torch.utils.options import parse_dict
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# the same float32 weights through both packages, relative to max|out|
JAX_TOL = 1e-5
G_TINY = dict(type='StyleGAN2Generator', out_size=16, num_style_feat=16,
              num_mlp=2, channel_multiplier=1, narrow=0.0625)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def jax_g_params(opt, seed):
    """A JAX StyleGAN2Generator of ``opt`` and params drawn from a numpy
    seed into the tree of ``jax.eval_shape`` of its init (nothing
    compiled): weights N(0, 1), biases N(0, 0.01), noise strengths
    N(0, 0.01)."""
    from edvr_tpu.archs import define_network as jax_define
    net = jax_define(dict(opt))
    shapes = jax.eval_shape(
        lambda k: net.init({'params': k}, [jnp.zeros(
            (1, opt['num_style_feat']))], randomize_noise=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = str(getattr(path[-1], 'key', path[-1]))
        if s.shape == (1,) or 'bias' in leaf:
            return (rng.randn(*s.shape) * 0.1).astype(np.float32)
        return rng.randn(*s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes['params'])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes['noises'])
    return net, params, zeros


@pytest.mark.parametrize('param_key', ['params', 'params_ema'])
def test_jax_stylegan2_ckpt_loads_strictly(tmp_path, param_key):
    """The JAX engine's checkpoint has no ``noises`` (its stored noises are
    zeros whatever the seed); the port's strict load takes it under either
    ``param_key_g`` (and the EMA copy from ``params_ema``), and a sample
    with the stored noises matches JAX's ``apply`` at 1e-5 of max|out|.
    The parent tree's strict load fails on the missing noise keys."""
    net_j, params, zeros = jax_g_params(G_TINY, 3)
    _, params_ema, _ = jax_g_params(G_TINY, 4)
    path = str(tmp_path / 'net_g_latest.ckpt')
    dump_checkpoint({'params': _tree(params), 'params_ema': _tree(params_ema)},
                    path)
    opt = {
        'name': 'c8', 'model_type': 'StyleGAN2Model', 'num_gpu': 0,
        'manual_seed': 0, 'network_g': dict(G_TINY),
        'network_d': dict(type='StyleGAN2Discriminator', out_size=16,
                          channel_multiplier=1, narrow=0.0625),
        'path': {'pretrain_network_g': path, 'strict_load_g': True,
                 'param_key_g': param_key},
        'train': {'optim_g': dict(type='Adam', lr=1e-4),
                  'optim_d': dict(type='Adam', lr=1e-4),
                  'scheduler': dict(type='MultiStepLR', milestones=[10],
                                    gamma=0.5),
                  'total_iter': 1, 'warmup_iter': -1,
                  'gan_opt': dict(type='GANLoss', gan_type='wgan_softplus',
                                  loss_weight=1.0),
                  'r1_reg_weight': 10, 'path_reg_weight': 2,
                  'net_g_reg_every': 4, 'net_d_reg_every': 16,
                  'mixing_prob': 0.9},
        'val': {'num_val_samples': 4},
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 100}}
    model = create_model(dict(parse_dict(json.loads(json.dumps(opt)),
                                         is_train=True, root=str(tmp_path)),
                              device='cpu'))
    z = np.random.RandomState(5).randn(2, 16).astype(np.float32)
    for net, tree in ((model.net_g, {'params': params,
                                     'params_ema': params_ema}[param_key]),
                      (model.net_g_ema, params_ema)):
        for name, buf in net.noises.named_buffers():
            assert torch.equal(buf, torch.zeros_like(buf)), name
        with torch.no_grad():
            got, _ = net([torch.from_numpy(z)], randomize_noise=False)
        want, _ = net_j.apply({'params': tree, 'noises': zeros},
                              [jnp.asarray(z)], randomize_noise=False)
        want = np.moveaxis(np.asarray(want), -1, 1)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= JAX_TOL, err


def test_stylegan2_load_keeps_given_noises_and_strictness():
    """A given ``noises.noise<i>`` loads as it is; any other missing key
    still fails a strict load."""
    from edvr_tpu_torch.archs import define_network
    net = define_network(dict(G_TINY))
    state = {k: torch.randn_like(v) for k, v in net.state_dict().items()}
    net.load_state_dict(state, strict=True)
    assert torch.equal(net.noises.noise0, state['noises.noise0'])
    del state['noises.noise0']
    net.load_state_dict(state, strict=True)
    assert not net.noises.noise0.any()
    del state['constant_input.weight']
    with pytest.raises(RuntimeError, match='constant_input.weight'):
        net.load_state_dict(state, strict=True)


# ---------------------------------------------------------------------- #
# C.9
# ---------------------------------------------------------------------- #
WOTSA_YML = osp.join(REPO, 'options', 'train', 'EDVR',
                     'train_EDVR_L_x4_SR_REDS_woTSA.yml')
C9_STEPS = 3
C9_LQ = 32


def _c9_opt():
    """The woTSA YAML's network and training block, fp32 (its
    ``mixed_precision: bf16`` set to null), for the port's engine."""
    with open(WOTSA_YML) as f:
        shipped = yaml.safe_load(f)
    train = dict(shipped['train'], mixed_precision=None)
    return dict(name='c9', model_type='EDVRModel', scale=4, num_gpu=1,
                manual_seed=10, network_g=shipped['network_g'],
                path=dict(pretrain_network_g=None, strict_load_g=True),
                train=train)


def _c9_batches():
    rng = np.random.RandomState(9)
    return [(rng.rand(1, 5, C9_LQ, C9_LQ, 3).astype(np.float32),
             rng.rand(1, 4 * C9_LQ, 4 * C9_LQ, 3).astype(np.float32))
            for _ in range(C9_STEPS)]


def _c9_port_start(opt, tmp_path):
    """The port's seeded start of chip_smoke.py's edvr_l_train: the engine's
    seeded initialisation, each DCN pack's ``conv_offset`` weights drawn by
    ``tools/train_edvr_l.py::seed_offsets``."""
    from edvr_tpu_torch.tools.train_edvr_l import seed_offsets
    model = create_model(dict(parse_dict(json.loads(json.dumps(opt)),
                                         is_train=True, root=str(tmp_path)),
                              device='cpu'))
    seed_offsets(model.net_g, 0)
    return {k: v.clone() for k, v in model.net_g.state_dict().items()}


@pytest.mark.slow  # ~5 min: EDVR-L's JAX init and train step compile on CPU
@pytest.mark.parametrize('start', ['jax_init', 'port_seeded'])
def test_edvr_l_wotsa_steps_match_jax(tmp_path, start):
    """Three fp32 Adam steps of EDVR-L woTSA (the shipped YAML's network,
    optimizer, schedule and Charbonnier sum; batch 1, 32x32 LQ) from the
    same weights in the JAX engine's own train step and in the port's CPU
    engine. ``jax_init``: a real JAX ``init`` carried across by
    ``jax_params_to_state_dict``; ``port_seeded``: the port's seeded start
    of the card run (chip_smoke.py's edvr_l_train) carried into the JAX
    tree by ``convert_state_dict``. The losses of the two engines agree at
    every step, so whatever the loss does is the start's and the
    optimizer's, not the port's. ``-s`` prints the readings."""
    from edvr_tpu.archs.edvr_arch import EDVR as JaxEDVR
    from edvr_tpu.convert import convert_state_dict
    from edvr_tpu.models.edvr_model import EDVRModel as JaxEDVRModel
    from edvr_tpu.models.losses import build_loss as jax_build_loss
    opt = _c9_opt()
    net_cfg = {k: v for k, v in opt['network_g'].items() if k != 'type'}
    jnet = JaxEDVR(**net_cfg)
    sample = jnp.zeros((1, 5, C9_LQ, C9_LQ, 3))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(10), sample)['params']
    if start == 'jax_init':
        init = jax_params_to_state_dict(_tree(params))
    else:
        init = _c9_port_start(opt, tmp_path / 'seed')
        params, unmatched = convert_state_dict(
            {k: v.numpy() for k, v in init.items()}, _tree(params))
        assert not unmatched, unmatched[:5]

    shell = object.__new__(JaxEDVRModel)
    shell.opt = dict(opt, dist=False)
    shell.net_g = jnet
    shell.params_g, shell.schedulers = params, {}
    shell.replicate = lambda tree: tree
    shell.cri_pix = jax_build_loss(opt['train']['pixel_opt'])
    shell.cri_perceptual = None
    shell.setup_optimizers()
    shell.setup_schedulers()
    step = shell._make_train_step()
    p, state, jlosses = params, shell.opt_state_g, []
    batches = _c9_batches()
    for it, (lq, gt) in enumerate(batches, 1):
        lr = jnp.float32(shell.schedulers['optimizer_g'](it))
        p, state, logs = step(p, state, jnp.asarray(lq), jnp.asarray(gt),
                              lr, jnp.int32(it))
        jlosses.append(float(logs['l_pix']))

    model = create_model(dict(parse_dict(json.loads(json.dumps(opt)),
                                         is_train=True,
                                         root=str(tmp_path / 'port')),
                              device='cpu'))
    model.net_g.load_state_dict(init, strict=True)
    losses = []
    for it, (lq, gt) in enumerate(batches, 1):
        model.feed_data({'lq': torch.from_numpy(lq).permute(0, 1, 4, 2, 3),
                         'gt': torch.from_numpy(gt).permute(0, 3, 1, 2)})
        model.optimize_parameters(it)
        losses.append(float(model.get_current_log()['l_pix']))
    print(f'C.9 {start}: port losses {losses}, JAX losses {jlosses}')
    assert np.isfinite(losses).all() and np.isfinite(jlosses).all()
    for a, b in zip(losses, jlosses):
        assert abs(a - b) <= C9_LOSS_RTOL * abs(b), (losses, jlosses)


# the losses' agreement after Adam steps: a gradient entry near zero whose
# float32 sum rounds to the other sign moves its weight by ~2 lr the other
# way, so steps 2 and 3 differ by more than the first step's rounding
C9_LOSS_RTOL = 1e-2
