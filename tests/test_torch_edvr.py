"""The port's EDVR slice against the JAX package and the golden fixture.

A small EDVR (16 features, dg=2, 1+1 blocks) with seeded random weights
restores a 7-frame 32x32 clip through the JAX ``make_clip_restore_fn`` and
through the port's, the weights carried across by
``jax_params_to_state_dict``; the full-width EDVR-M golden
(tests/data/golden/arch_edvr_m_full.npz) is reproduced on the CPU. Both at
atol 3e-4, as tests/test_arch_parity.py. The helpers around the clip path
(window tables, PSNR, tensor2img, checkpoint loading) are compared with
their JAX counterparts.
"""

import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edvr_tpu.archs import edvr_arch as jarch
from edvr_tpu.data.data_util import \
    generate_frame_indices as j_generate_frame_indices
from edvr_tpu.metrics.psnr_ssim import calculate_psnr as j_psnr
from edvr_tpu.models.base_model import dump_checkpoint
from edvr_tpu.utils.img_util import tensor2img as j_tensor2img
from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.archs import edvr_arch
from edvr_tpu_torch.convert import (jax_params_to_state_dict,
                                    load_state_dict_file)
from edvr_tpu_torch.data.data_util import generate_frame_indices
from edvr_tpu_torch.metrics import calculate_psnr
from edvr_tpu_torch.ops import dcn
from edvr_tpu_torch.utils import tensor2img
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 3e-4
GOLDEN = osp.join(osp.dirname(__file__), 'data', 'golden',
                  'arch_edvr_m_full.npz')
SMALL = dict(num_feat=16, num_frame=5, deformable_groups=2,
             num_extract_block=1, num_reconstruct_block=1)


@pytest.fixture(scope='module')
def small_jax():
    """JAX EDVR with every parameter drawn from a numpy seed, so the
    offsets are non-zero and the DCN samples move; and its clip output.
    The tree comes from ``jax.eval_shape`` of the init (its values would
    all be redrawn; an eager init takes ~30 s)."""
    model = jarch.EDVR(**SMALL)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 5, 32, 32, 3)))['params']
    rng = np.random.RandomState(0)

    def redraw(leaf):
        fan_in = (int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1
                  else 16)
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map(redraw, params)
    clip = np.random.RandomState(1).rand(7, 32, 32, 3).astype(np.float32)
    idx = jarch.clip_window_indices(7, 5, 'reflection_circle')
    fn = jarch.make_clip_restore_fn(model, win_batch=1)
    out = np.asarray(fn({'params': params}, jnp.asarray(clip),
                        jnp.asarray(idx)))
    return jax.tree_util.tree_map(np.asarray, params), clip, out


@pytest.mark.parametrize('win_batch', [1, 3])
def test_clip_restore_matches_jax(small_jax, win_batch):
    params, clip, want = small_jax
    net = define_network(dict(type='EDVR', **SMALL)).eval()
    net.load_state_dict(jax_params_to_state_dict(params), strict=True)
    idx = edvr_arch.clip_window_indices(7, 5, 'reflection_circle')
    before = dcn.LAUNCHES['dcn_fwd']
    got = edvr_arch.make_clip_restore_fn(net, win_batch=win_batch)(
        torch.from_numpy(clip).permute(0, 3, 1, 2), idx)
    assert dcn.LAUNCHES['dcn_fwd'] == before  # CPU: plain DCN, no kernel
    assert got.shape == (7, 3, 128, 128)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL, rtol=0)


def test_golden_edvr_m_full_cpu():
    data = np.load(GOLDEN)
    net = define_network(json.loads(bytes(data['__config__']).decode()))
    net.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files
                         if not k.startswith('__')}, strict=True)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(data['__input__']))
    np.testing.assert_allclose(out.numpy(), data['__output__'], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('padding', ['reflection_circle', 'reflection',
                                     'replicate', 'circle'])
def test_window_tables_match_jax(padding):
    for T in (1, 3, 7, 100):
        np.testing.assert_array_equal(
            edvr_arch.clip_window_indices(T, 5, padding),
            jarch.clip_window_indices(T, 5, padding))
        assert (generate_frame_indices(T // 2, T, 7, padding) ==
                j_generate_frame_indices(T // 2, T, 7, padding))


@pytest.mark.parametrize('crop_border,test_y', [(0, False), (4, True)])
def test_psnr_and_tensor2img_match_jax(crop_border, test_y):
    rng = np.random.RandomState(2)
    a = rng.rand(3, 40, 48).astype(np.float32) * 1.2 - 0.1
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.05, 0, 1)
    img_a, img_b = tensor2img(torch.from_numpy(a)), tensor2img(
        torch.from_numpy(b[None]))
    np.testing.assert_array_equal(img_a, j_tensor2img(a.transpose(1, 2, 0)))
    np.testing.assert_array_equal(img_b, j_tensor2img(b.transpose(1, 2, 0)))
    assert calculate_psnr(img_a, img_b, crop_border,
                          test_y_channel=test_y) == pytest.approx(
        j_psnr(img_a, img_b, crop_border, test_y_channel=test_y),
        rel=1e-12)


def test_load_state_dict_file(tmp_path, small_jax):
    params = small_jax[0]
    state = jax_params_to_state_dict(params)
    pth = str(tmp_path / 'net.pth')
    torch.save({'params': {f'module.{k}': v for k, v in state.items()}}, pth)
    ckpt = str(tmp_path / 'net.ckpt')
    dump_checkpoint({'params': params}, ckpt)
    for path in (pth, ckpt):
        got = load_state_dict_file(path)
        assert got.keys() == state.keys()
        for k in state:
            torch.testing.assert_close(got[k], state[k], atol=0, rtol=0)
    foreign = tmp_path / 'foreign.ckpt'
    foreign.write_bytes(b'not a checkpoint')
    with pytest.raises(ValueError, match='refusing to unpickle'):
        load_state_dict_file(str(foreign))
