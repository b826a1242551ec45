"""EDVR's default centre frame, ``remat`` and the training CLI at EDVR-L's
shape, on the CPU.

The port's EDVR built without ``center_frame_idx`` against the JAX
package's (its default is 2, ``None`` meaning ``num_frame // 2``) at
``num_frame=7``, weights carried over by ``jax_params_to_state_dict``, at
3e-4 as tests/test_torch_edvr.py; ``remat`` (each trunk block recomputed
in the backward pass) against the plain trunks, fp32 and under the bf16
step's ``torch.func.functional_call``, and its parameter names in both
packages; the training CLI on a tiny EDVR-L-shaped network (c_per 16,
``remat: true``) and its cuDNN choice by network.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from edvr_tpu.archs import edvr_arch as jarch
from edvr_tpu_torch import train
from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.test import INFERENCE_CUDNN_ENV
from test_torch_train import _write_train_yml
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 3e-4  # as tests/test_torch_edvr.py
# a tiny EDVR without center_frame_idx, 7 frames
NO_CENTER = dict(num_feat=8, num_frame=7, deformable_groups=2,
                 num_extract_block=1, num_reconstruct_block=1)
# EDVR-L's shape cut in width and depth: dg 2 of 32 features is c_per 16,
# as 128 features in 8 groups
L_SHAPED = dict(num_feat=32, num_frame=5, deformable_groups=2,
                num_extract_block=2, num_reconstruct_block=3)


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: the test
    workers share the machine's cores, and torch's default of one thread
    per core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(shapes, seed):
    """Every leaf of a flax parameter shape tree from a numpy seed; the
    offset convs too, so the DCN samples move."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        if 'conv_offset' in name:
            return (rng.randn(*s.shape) * 0.05).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 16
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_default_center_frame_matches_jax():
    """Without center_frame_idx both packages centre a 7-frame window on
    frame 2 (TSA's reference, the PCD reference and the base image)."""
    jnet = jarch.EDVR(**NO_CENTER)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 7, 16, 16, 3)))['params']
    params = _draw(shapes, 0)
    lq = np.random.RandomState(1).rand(2, 7, 16, 16, 3).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)({'params': params},
                                          jnp.asarray(lq)))

    net = define_network(dict(type='EDVR', **NO_CENTER)).eval()
    net.load_state_dict(jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(lq).permute(0, 1, 4, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL, rtol=0)
    assert net.center_frame_idx == 2 and net.fusion.center_frame_idx == 2
    # None still means num_frame // 2
    assert define_network(dict(type='EDVR', **NO_CENTER,
                               center_frame_idx=None)).center_frame_idx == 3


def test_remat_keeps_the_parameter_tree():
    """nn.remat renames nothing in JAX's tree (the trunk blocks are named
    block_<i> explicitly), and the port's state_dict keys do not change
    with remat: one carried-over tree loads strictly into both."""
    trees = {}
    for remat in (False, True):
        jnet = jarch.EDVR(**L_SHAPED, remat=remat)
        trees[remat] = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 5, 16, 16, 3)))['params']
    flat = {r: {jax.tree_util.keystr(p): s.shape for p, s in
                jax.tree_util.tree_leaves_with_path(t)}
            for r, t in trees.items()}
    assert flat[True] == flat[False]
    state = jax_params_to_state_dict(_draw(trees[True], 2))
    nets = {r: define_network(dict(type='EDVR', **L_SHAPED, remat=r))
            for r in (False, True)}
    assert list(nets[True].state_dict()) == list(nets[False].state_dict())
    for net in nets.values():
        net.load_state_dict(state, strict=True)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_remat_matches_plain_trunks(dtype):
    """EDVR(remat=True) in training: the output and every parameter's
    gradient equal the plain trunks' bit for bit, in fp32 and in the bf16
    step's form (``torch.func.functional_call`` on bf16 parameter copies,
    which are unbound by the time the backward recomputes); each trunk
    block is called twice, its forward and its recomputation."""
    torch.manual_seed(0)
    nets = {r: define_network(dict(type='EDVR', **L_SHAPED, remat=r))
            for r in (False, True)}
    with torch.no_grad():
        for name, p in nets[False].named_parameters():
            if 'conv_offset' in name:
                p.copy_(torch.randn(p.shape) * 0.01)
    nets[True].load_state_dict(nets[False].state_dict())
    lq = torch.from_numpy(np.random.RandomState(3).rand(
        2, 5, 3, 16, 16).astype(np.float32))
    outs, grads, calls = {}, {}, {}
    for remat, net in nets.items():
        net.train()
        count = [0]
        for blocks in (net.feature_extraction, net.reconstruction):
            for block in blocks:
                # a pre-hook: the recomputation stops early, after the
                # block's last saved tensor, before a forward hook would run
                block.register_forward_pre_hook(
                    lambda *_, count=count: count.__setitem__(0, count[0] + 1))
        if dtype == 'fp32':
            out = net(lq)
        else:
            params = {n: p.to(torch.bfloat16)
                      for n, p in net.named_parameters()}
            out = torch.func.functional_call(
                net, params, (lq.to(torch.bfloat16),)).float()
        (out * out.cos()).sum().backward()
        outs[remat] = out.detach()
        grads[remat] = {n: p.grad for n, p in net.named_parameters()}
        calls[remat] = count[0]
    blocks = L_SHAPED['num_extract_block'] + L_SHAPED['num_reconstruct_block']
    assert calls == {False: blocks, True: 2 * blocks}
    assert torch.equal(outs[True], outs[False])
    assert grads[True].keys() == grads[False].keys()
    for name, g in grads[False].items():
        assert g is not None and torch.equal(grads[True][name], g), name
    # in eval or without autograd remat changes nothing
    with torch.no_grad():
        nets[True].eval(), nets[False].eval()
        assert torch.equal(nets[True](lq), nets[False](lq))


def test_train_cli_edvr_l_shaped_with_remat(tmp_path, monkeypatch):
    """``python -m edvr_tpu_torch.train``'s main on the CPU with an
    EDVR-L-shaped network (c_per 16) and ``remat: true``, in bf16 and in
    fp32: it trains, validates and saves; the network is built with
    remat."""
    monkeypatch.chdir(tmp_path)
    yml = _write_train_yml(tmp_path, name='edvr_l_shaped')
    with open(yml) as f:
        opt = yaml.safe_load(f)
    opt['network_g'].update(L_SHAPED, remat=True)
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    for mp in ('bf16', '~'):
        model = train.main(['-opt', yml, '--device', 'cpu', '--force_yml',
                            f'train:mixed_precision={mp}',
                            'train:total_iter=2'])
        assert model.net_g.remat and model.net_g.fusion.center_frame_idx == 2
        assert np.isfinite(model.get_current_log()['l_pix'])
        assert np.isfinite(model.metric_results['000']).all()
    assert os.path.exists(tmp_path / 'experiments' / 'edvr_l_shaped' /
                          'models' / 'net_g_latest.pth')


def test_train_cudnn_choice_by_network(monkeypatch):
    """The training CLI takes the test CLI's cuDNN choice for EDVR-L (128
    features) in fp32 and PyTorch's default for EDVR-L in bf16, EDVR-M and
    other networks; values already in the environment are kept."""
    for key in INFERENCE_CUDNN_ENV:
        # set, then deleted: monkeypatch restores the key's state (unset or
        # its value) after the test, also for what the policy writes
        monkeypatch.setenv(key, '')
        monkeypatch.delenv(key)
    edvr = dict(type='EDVR', num_feat=64, num_reconstruct_block=10)
    assert train.train_cudnn_env(edvr) == {}
    assert train.train_cudnn_env(dict(type='DUF', num_feat=128)) == {}
    assert train.use_train_cudnn_policy({'network_g': edvr}) == {}
    assert not any(k in os.environ for k in INFERENCE_CUDNN_ENV)
    edvr_l = dict(edvr, num_feat=128, num_reconstruct_block=40)
    assert train.train_cudnn_env(edvr_l) == INFERENCE_CUDNN_ENV
    monkeypatch.setenv('CUDNN_CONV_WSCAP_DBG', '512')
    assert train.use_train_cudnn_policy(
        {'network_g': edvr_l}) == INFERENCE_CUDNN_ENV
    assert os.environ['TORCH_CUDNN_V8_API_DISABLED'] == '1'
    assert os.environ['CUDNN_CONV_WSCAP_DBG'] == '512'
    # the run's precision: EDVR-L capped in fp32 only (train.mixed_precision
    # unset or null), the default in bf16; EDVR-M's default either way
    assert train.train_cudnn_env(edvr_l, None) == INFERENCE_CUDNN_ENV
    assert train.train_cudnn_env(edvr_l, 'bf16') == {}
    assert train.train_cudnn_env(edvr, 'bf16') == {}
    assert train.train_cudnn_env(edvr, None) == {}
    for key in INFERENCE_CUDNN_ENV:
        monkeypatch.delenv(key)
    assert train.use_train_cudnn_policy(
        {'network_g': edvr_l, 'train': {'mixed_precision': 'bf16'}}) == {}
    assert not any(k in os.environ for k in INFERENCE_CUDNN_ENV)
    assert train.use_train_cudnn_policy(
        {'network_g': edvr_l, 'train': {'mixed_precision': None}}
    ) == INFERENCE_CUDNN_ENV
    assert os.environ['TORCH_CUDNN_V8_API_DISABLED'] == '1'
