"""The port's FID and StyleGAN2 tools against the JAX package, on the CPU:
the FID InceptionV3 with seeded weights (JAX's carried by name) on a small
input, ``calculate_fid`` on seeded statistics (singular ones included),
the bilinear resize to 299 against ``edvr_tpu/ops/resize.py``, the weight
file loader, and the sampling and FID tools (``--device cpu``) on a
seeded 16 px generator at the tools' own widths.
"""

import os.path as osp

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edvr_tpu_torch.metrics import fid
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FEAT_TOL = 1e-5  # relative to max|feature|


def seeded_inception(seed):
    """The JAX FID network's variables drawn from numpy (``jax.eval_shape``
    of its init): conv kernels N(0, 2 / fan_in), BatchNorm scales 1 +
    N(0, 0.01), biases and running means N(0, 0.01), running variances in
    [0.5, 1.5]; and the same as a torch state dict by name."""
    from edvr_tpu.archs.inception import FIDInceptionV3 as JaxInception
    net = JaxInception()
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 75, 75, 3)))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == 'kernel':
            a = rng.randn(*s.shape) * np.sqrt(2 / np.prod(s.shape[:-1]))
        elif leaf == 'var':
            a = rng.rand(*s.shape) + 0.5
        else:
            a = (leaf == 'scale') + rng.randn(*s.shape) * 0.1
        return a.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    names = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
             'mean': 'running_mean', 'var': 'running_var'}
    state = {}
    for path, v in jax.tree_util.tree_flatten_with_path(variables)[0]:
        keys = [k.key for k in path[1:]]
        key = '.'.join(keys[:-1] + [names[keys[-1]]])
        state[key] = torch.from_numpy(np.ascontiguousarray(
            v.transpose(3, 2, 0, 1) if v.ndim == 4 else v))
        if keys[-1] == 'mean':
            state[key.rsplit('.', 1)[0] + '.num_batches_tracked'] = \
                torch.tensor(0)
    return net, variables, state


def test_inception_matches_jax(tmp_path):
    """pool3 features of the same seeded weights on a 107 px batch (every
    stage, the FID patches' pools included, at a size the CPU runs fast),
    through ``load_patched_inception_v3`` from a ``.pth`` with
    torchvision's extra ``fc`` keys; the network stays in eval mode."""
    net_j, variables, state = seeded_inception(0)
    x = np.random.RandomState(1).rand(2, 107, 107, 3).astype(np.float32)
    want = jax.jit(net_j.apply)(variables, jnp.asarray(x))
    path = str(tmp_path / 'pt_inception.pth')
    torch.save({**state, 'fc.weight': torch.zeros(1008, 2048),
                'fc.bias': torch.zeros(1008)}, path)
    net = fid.load_patched_inception_v3(path, device='cpu')
    net.train()
    assert not net.training
    feats = fid.extract_inception_features(
        [torch.from_numpy(np.moveaxis(x, -1, 1).copy())], net)
    assert feats.shape == (2, 2048) and feats.dtype == np.float64
    want = np.asarray(want)
    np.testing.assert_allclose(feats, want, rtol=0,
                               atol=FEAT_TOL * np.abs(want).max())
    state['Mixed_7c.branch_pool.conv.weight'] = torch.zeros(1)
    torch.save(state, path)
    with pytest.raises(RuntimeError, match='size mismatch'):
        fid.load_patched_inception_v3(path, device='cpu')


def test_calculate_fid_matches_jax(capsys):
    from edvr_tpu.metrics.fid import calculate_fid as jax_fid
    rng = np.random.RandomState(2)
    feats = [rng.randn(40, 8) @ rng.randn(8, 8) + rng.randn(8)
             for _ in range(2)]
    stats = [(f.mean(0), np.cov(f, rowvar=False)) for f in feats]
    got = fid.calculate_fid(*stats[0], *stats[1])
    assert got == jax_fid(*stats[0], *stats[1]) and got > 0
    assert abs(fid.calculate_fid(*stats[0], *stats[0])) < 1e-6
    # rank-deficient covariances (3 samples of 8 features)
    low = [rng.randn(3, 8) for _ in range(2)]
    low = [(f.mean(0), np.cov(f, rowvar=False)) for f in low]
    got = fid.calculate_fid(*low[0], *low[1])
    assert np.isfinite(got) and got == jax_fid(*low[0], *low[1])


def test_inception_input_matches_jax_resize():
    """[-1, 1] -> [0, 1], clipped, 299 x 299 by ``F.interpolate``
    (bilinear, align_corners False) against the JAX tool's resize."""
    from edvr_tpu.ops.resize import interpolate
    from edvr_tpu_torch.tools.calculate_stylegan2_fid import inception_input
    img = np.random.RandomState(3).randn(2, 3, 64, 48).astype(np.float32)
    got = inception_input(torch.from_numpy(img)).numpy()
    want = interpolate(jnp.clip((jnp.asarray(np.moveaxis(img, 1, -1)) + 1)
                                / 2, 0, 1), size=(299, 299),
                       mode='bilinear')
    # the two sum the same weighted taps in another order (float32)
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 1),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope='module')
def g_pth(tmp_path_factory):
    """A seeded 16 px Cmul2 generator (the tools' 512 style features and 8
    MLP layers) as a ``.pth`` with ``params`` and ``params_ema``; stored
    noises and noise strengths nonzero."""
    from edvr_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
    torch.manual_seed(0)
    net = StyleGAN2Generator(out_size=16, channel_multiplier=2)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if 'noise' in name or name.endswith('conv1.weight') or (
                    'style_convs' in name and name.count('.') == 2
                    and name.endswith('weight')):
                t.normal_(0, 0.1)
    path = str(tmp_path_factory.mktemp('g') / 'net_g.pth')
    torch.save({'params': {k: v * 0 for k, v in net.state_dict().items()},
                'params_ema': net.state_dict()}, path)
    return path, net


def test_sampling_tool(g_pth, tmp_path):
    """``--device cpu``: the PNGs of the codes the tool's generator draws,
    through the truncation toward the mean of ``truncation_mean`` codes
    and the stored noises, as ``tensor2img`` writes them; the same seed
    gives the same images."""
    from edvr_tpu_torch.tools import inference_stylegan2 as tool
    from edvr_tpu_torch.utils import tensor2img
    path, net = g_pth
    out = str(tmp_path / 'samples')
    paths = tool.main(['--ckpt', path, '--out_size', '16', '--nums', '3',
                       '--output', out, '--truncation_mean', '64',
                       '--seed', '5', '--device', 'cpu'])
    assert [osp.basename(p) for p in paths] == [f'{i:08d}.png'
                                                for i in range(3)]
    gen = torch.Generator().manual_seed(5)
    net = net.eval()
    with torch.no_grad():
        mean = net.style_mlp(torch.randn(64, 512, generator=gen)).mean(
            0, keepdim=True)
        for p in paths:
            z = torch.randn(1, 512, generator=gen)
            img, _ = net([z], truncation=0.7, truncation_latent=mean,
                         randomize_noise=False)
            np.testing.assert_array_equal(
                cv2.imread(p), tensor2img(img, min_max=(-1, 1)))
    again = tool.main(['--ckpt', path, '--out_size', '16', '--nums', '1',
                       '--output', str(tmp_path / 'again'),
                       '--truncation_mean', '64', '--seed', '5',
                       '--device', 'cpu'])
    np.testing.assert_array_equal(cv2.imread(again[0]), cv2.imread(paths[0]))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            tool.main(['--ckpt', path, '--out_size', '16', '--nums', '1',
                       '--output', out])


def test_fid_tool(g_pth, tmp_path, capsys, monkeypatch):
    """``--device cpu``, 4 samples in batches of 2 at 16 px, seeded
    inception weights and seeded statistics: the tool hands
    ``calculate_fid`` the mean and covariance of the features of the same
    draws and the file's statistics, and prints what it returns
    (``calculate_fid`` itself is held to JAX's above; its 2048-wide
    ``sqrtm`` is left out here for time)."""
    from edvr_tpu_torch.tools import calculate_stylegan2_fid as tool
    from edvr_tpu_torch.tools.inference_stylegan2 import build_generator
    path, _ = g_pth
    _, _, state = seeded_inception(4)
    incep = str(tmp_path / 'pt_inception.pth')
    torch.save(state, incep)
    rng = np.random.RandomState(6)
    a = rng.randn(2048, 16)
    stats = str(tmp_path / 'stats.npz')
    np.savez(stats, mean=rng.randn(2048) * 0.1, cov=a @ a.T / 16)
    calls = []
    monkeypatch.setattr(fid, 'calculate_fid',
                        lambda *args: calls.append(args) or 12.5)
    got = tool.main([path, '--fid_stats', stats, '--inception_weights',
                     incep, '--out_size', '16', '--batch_size', '2',
                     '--num_sample', '4', '--seed', '7', '--device', 'cpu'])
    assert got == 12.5 and 'fid: 12.5' in capsys.readouterr().out
    inception = fid.load_patched_inception_v3(incep, device='cpu')
    feats, secs = tool.sample_features(
        build_generator(path, 16, 2, device='cpu'), inception, 4, 2, seed=7)
    assert feats.shape == (4, 2048) and len(secs) == 2
    assert np.isfinite(feats).all() and feats.std(0).max() > 0
    (mu, cov, mu_s, cov_s), = calls
    np.testing.assert_allclose(mu, feats.mean(0), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(cov, np.cov(feats, rowvar=False), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_array_equal(cov_s, np.load(stats)['cov'])
    np.testing.assert_array_equal(mu_s, np.load(stats)['mean'])
