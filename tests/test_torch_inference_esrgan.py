"""``python -m edvr_tpu_torch.tools.inference_esrgan`` (the port of
``inference/inference_esrgan.py``) on the CPU:

* :func:`restore` of a narrow RRDBNet (seeded JAX parameters carried by
  ``jax_params_to_state_dict`` into a ``.pth``) against the JAX RRDBNet
  through the JAX tool's own pre- and post-processing: the network's
  output within JAX_TOL, the uint8 images within one level;
* the CLI over a folder against the JAX tool's PNGs at the published width
  (64 features, 23 blocks, grow 32) from one ``.pth`` (``-m slow``: XLA
  compiles the whole RRDBNet).
"""

import glob
import os
import os.path as osp
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edvr_tpu.archs.rrdbnet_arch import RRDBNet as JaxRRDBNet
from edvr_tpu_torch.archs.rrdbnet_arch import RRDBNet
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.tools import inference_esrgan
from test_torch_gan import seeded_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_TOL = 1e-5  # of max|out|, as tests/test_torch_image_sr.py's JAX_TOL
SMALL = dict(num_feat=8, num_block=1, num_grow_ch=4)


def _jax_tool_output(apply, img):
    """The JAX tool's steps (inference/inference_esrgan.py:48-53) on one
    BGR float32 image: (the network's RGB output, the BGR uint8 image)."""
    out = np.asarray(apply(jnp.asarray(img[:, :, [2, 1, 0]][None])))[0]
    bgr = out[:, :, [2, 1, 0]]
    return out, (np.clip(bgr, 0, 1) * 255.0).round().astype(np.uint8)


def _images(root, n, hw, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(root)
    for i in range(n):
        cv2.imwrite(osp.join(root, f'img{i}.png'),
                    (rng.rand(*hw, 3) * 255).astype(np.uint8))
    return sorted(glob.glob(osp.join(root, '*.png')))


def test_restore_matches_jax_rrdbnet(tmp_path):
    net = JaxRRDBNet(num_in_ch=3, num_out_ch=3, **SMALL)
    params, _ = seeded_variables(net, jnp.zeros((1, 8, 8, 3)), 4)
    pth = str(tmp_path / 'rrdb.pth')
    torch.save({'params': jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params))}, pth)
    port = inference_esrgan.build_rrdbnet(pth, 'cpu', **SMALL)
    apply = jax.jit(lambda x: net.apply({'params': params}, x))
    for path in _images(str(tmp_path / 'in'), 2, (12, 10), seed=5):
        img = cv2.imread(path, cv2.IMREAD_COLOR).astype(np.float32) / 255.
        want, want_u8 = _jax_tool_output(apply, img)
        got_u8 = inference_esrgan.restore(port, img)
        with torch.no_grad():
            got = port(torch.from_numpy(np.ascontiguousarray(
                img[:, :, ::-1].transpose(2, 0, 1)))[None])[0]
        got = got.numpy().transpose(1, 2, 0)
        assert np.abs(got - want).max() <= JAX_TOL * np.abs(want).max()
        assert got_u8.shape == (48, 40, 3) and got_u8.dtype == np.uint8
        assert np.abs(got_u8.astype(int) - want_u8).max() <= 1


def test_tool_refuses_a_wrong_checkpoint_and_a_missing_card(tmp_path):
    pth = str(tmp_path / 'small.pth')
    torch.save({'params': RRDBNet(**SMALL).state_dict()}, pth)
    with pytest.raises(RuntimeError, match='size mismatch'):
        inference_esrgan.build_rrdbnet(pth, 'cpu')  # the published width
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            inference_esrgan.build_rrdbnet(pth, 'cuda', **SMALL)


@pytest.mark.slow  # ~30 s: XLA compiles the 23-block RRDBNet
def test_cli_matches_jax_tool_at_full_width(tmp_path):
    torch.manual_seed(0)
    pth = str(tmp_path / 'esrgan.pth')
    torch.save({'params': RRDBNet().state_dict()}, pth)
    _images(str(tmp_path / 'in'), 2, (16, 12), seed=6)
    out = subprocess.run(
        [sys.executable, osp.join(REPO, 'inference', 'inference_esrgan.py'),
         '--model_path', pth, '--input', str(tmp_path / 'in'),
         '--output', str(tmp_path / 'jax')],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS='cpu'))
    assert out.returncode == 0, out.stderr[-3000:]
    paths = inference_esrgan.main([
        '--model_path', pth, '--input', str(tmp_path / 'in'),
        '--output', str(tmp_path / 'port'), '--device', 'cpu'])
    assert [osp.basename(p) for p in paths] == ['img0_ESRGAN.png',
                                                'img1_ESRGAN.png']
    for path in paths:
        got = cv2.imread(path).astype(int)
        want = cv2.imread(osp.join(str(tmp_path / 'jax'),
                                   osp.basename(path))).astype(int)
        assert got.shape == want.shape == (64, 48, 3)
        assert np.abs(got - want).max() <= 1
