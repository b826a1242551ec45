"""The port's MATLAB functions and NIQE against the JAX package and the
substrate golden: bicubic ``imresize`` (with and without antialiasing, at
the golden's scales and at Vid4's x1/4 and x4), the YCbCr conversions,
the metrics' Y channel through them, and ``calculate_niqe``, directly and
through ``calculate_metric``. All host numpy on both sides."""

import os.path as osp

import numpy as np
import pytest

from edvr_tpu.metrics.metric_util import to_y_channel as jax_to_y
from edvr_tpu.metrics.niqe import calculate_niqe as jax_niqe
from edvr_tpu.utils import matlab_functions as jmatlab
from edvr_tpu_torch.metrics import calculate_metric, calculate_niqe
from edvr_tpu_torch.metrics.metric_util import to_y_channel
from edvr_tpu_torch.utils import matlab_functions as matlab

GOLDEN = osp.join(osp.dirname(__file__), 'data', 'golden', 'substrate.npz')
# the golden's MATLAB outputs, as tests/test_matlab_and_metrics.py holds
# the JAX package to them
MATLAB_ATOL = 2e-5
COLOR_ATOL = 1e-6
NIQE_RTOL = 1e-6


@pytest.fixture(scope='module')
def g():
    return np.load(GOLDEN)


@pytest.mark.parametrize('name,scale,antialias', [
    ('down4', 0.25, True), ('up4', 4.0, True), ('down3', 1 / 3, True),
    ('down2_noaa', 0.5, False)])
def test_imresize_matches_golden_and_jax(g, name, scale, antialias):
    img = g['imresize_input']
    out = matlab.imresize(img, scale, antialias)
    ref = g[f'imresize_{name}']
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=MATLAB_ATOL)
    np.testing.assert_array_equal(out, jmatlab.imresize(img, scale,
                                                        antialias))


def test_imresize_vid4_inputs_match_jax():
    """BIx4 and BIx4up_direct as the Vid4 tree makes them: x1/4 of an
    8-bit frame, then x4 of that rounded to 8 bits; 2-D input too."""
    rng = np.random.RandomState(3)
    hr = rng.randint(0, 256, (44, 36, 3)).astype(np.float32) / 255.
    lr = matlab.imresize(hr, 1 / 4)
    np.testing.assert_array_equal(lr, jmatlab.imresize(hr, 1 / 4))
    lr8 = np.round(np.clip(lr, 0, 1) * 255.) / 255.
    np.testing.assert_array_equal(matlab.imresize(lr8, 4),
                                  jmatlab.imresize(lr8, 4))
    assert matlab.imresize(lr8, 4).shape == (44, 36, 3)
    np.testing.assert_array_equal(matlab.imresize(hr[:, :, 0], 0.5),
                                  jmatlab.imresize(hr[:, :, 0], 0.5))


def test_color_conversions_match_golden_and_jax(g):
    u8 = g['ycbcr_input_u8']
    f32 = u8.astype(np.float32) / 255.
    np.testing.assert_array_equal(matlab.rgb2ycbcr(u8), g['rgb2ycbcr_u8'])
    np.testing.assert_allclose(matlab.rgb2ycbcr(f32), g['rgb2ycbcr_f32'],
                               atol=COLOR_ATOL)
    np.testing.assert_allclose(matlab.rgb2ycbcr(f32, y_only=True),
                               g['rgb2ycbcr_y_f32'], atol=COLOR_ATOL)
    np.testing.assert_allclose(matlab.bgr2ycbcr(f32, y_only=True),
                               g['bgr2ycbcr_y_f32'], atol=COLOR_ATOL)
    ycbcr = g['rgb2ycbcr_f32']
    np.testing.assert_allclose(matlab.ycbcr2rgb(ycbcr), g['ycbcr2rgb_f32'],
                               atol=COLOR_ATOL)
    np.testing.assert_allclose(matlab.ycbcr2bgr(ycbcr), g['ycbcr2bgr_f32'],
                               atol=COLOR_ATOL)
    for fn in ('rgb2ycbcr', 'bgr2ycbcr'):
        for img in (u8, f32):
            for y_only in (False, True):
                got = getattr(matlab, fn)(img, y_only=y_only)
                want = getattr(jmatlab, fn)(img, y_only=y_only)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    for fn in ('ycbcr2rgb', 'ycbcr2bgr'):
        for img in (u8, f32):
            np.testing.assert_array_equal(getattr(matlab, fn)(img),
                                          getattr(jmatlab, fn)(img))
    with pytest.raises(TypeError):
        matlab.rgb2ycbcr(u8.astype(np.float64))


def test_y_channel_matches_jax(g):
    """The metrics' Y channel now comes from ``bgr2ycbcr``: the same values
    as the JAX package's."""
    img = g['ycbcr_input_u8'].astype(np.float64)
    np.testing.assert_array_equal(to_y_channel(img), jax_to_y(img))


def _textured(h, w, seed):
    """A smooth image with noise on the [0, 255] scale, BGR."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / 17.
    base = 128 + 60 * np.sin(yy)[..., None] * np.cos(xx * 1.3)[..., None]
    img = base + rng.randn(h, w, 3) * 12
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize('convert_to,crop', [('y', 0), ('gray', 4)])
def test_niqe_matches_jax(convert_to, crop):
    img = _textured(200, 196, seed=5)
    got = calculate_niqe(img, crop, convert_to=convert_to)
    want = jax_niqe(img, crop, convert_to=convert_to)
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= NIQE_RTOL * abs(want), (got, want)
    via = calculate_metric(dict(img=img), dict(
        type='calculate_niqe', crop_border=crop, convert_to=convert_to))
    assert via == got


def test_niqe_reads_a_copy_of_the_jax_parameters():
    """The port's pristine-model file is a byte-for-byte copy of the JAX
    package's, read relative to the module."""
    from edvr_tpu.metrics import niqe as jniqe
    from edvr_tpu_torch.metrics import niqe
    with open(niqe._PRIS_PATH, 'rb') as a, open(jniqe._PRIS_PATH, 'rb') as b:
        assert a.read() == b.read()
    assert osp.dirname(niqe._PRIS_PATH) == osp.dirname(niqe.__file__)
