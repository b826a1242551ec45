"""The port's DFDNet slice against the JAX package, on the CPU: each
``dfdnet_util`` block and ``SFTUpBlock`` (JAX variables from
``jax.eval_shape`` of the init, seeded numpy values), the whole network at
its fixed widths on a 128 px face with a seeded 3-entry dictionary (the JAX
network is eager by design: concrete part locations, an ``int(argmax)``),
the entries each swap chose, ``state_dict_from_jax``, ``fold_spectral_norm``
against ``torch.nn.utils.spectral_norm``, ``remap_dfdnet`` and its command,
``umeyama_similarity`` and ``FaceRestorationHelper``'s warp and paste against
JAX's helper, ``get_part_location``, and (``-m slow``) the 512 px golden.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edvr_tpu_torch.archs import dfdnet_util as util
from edvr_tpu_torch.archs.dfdnet_arch import (DFDNet, SFTUpBlock,
                                              nearest_indices,
                                              state_dict_from_jax)
from edvr_tpu_torch.convert import fold_spectral_norm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = osp.join(osp.dirname(__file__), 'data', 'golden', 'dfdnet_full.npz')
# the same float32 weights through both packages, relative to max|out|
JAX_TOL = 1e-5
# the golden, at tests/test_dfdnet.py's tolerance
GOLDEN_TOL = 3e-4
PARTS = ('left_eye', 'right_eye', 'nose', 'mouth')
SIZES = {'256': 128, '128': 256, '64': 512, '32': 512}


def _nhwc(t):
    return np.moveaxis(np.asarray(t), 1, -1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, 1)))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _draw(shapes, seed):
    """Seeded values into a tree of shapes: kernels N(0, 1 / fan_in),
    biases N(0, 0.01)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        a = rng.standard_normal(s.shape, dtype=np.float32)
        if len(s.shape) == 1:
            return a * np.float32(0.1)
        return a / np.float32(np.sqrt(np.prod(s.shape[:-1])))

    return jax.tree_util.tree_map(draw, shapes)


# ---------------------------------------------------------------------- #
# blocks
# ---------------------------------------------------------------------- #
def test_blur_mean_std_adain_match_jax():
    from edvr_tpu.archs import dfdnet_util as jutil
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 11, 5).astype(np.float32)
    y = rng.randn(3, 6, 7, 5).astype(np.float32) * 2 + 1
    assert _rel(_nhwc(util.blur(_nchw(x))), jutil.blur(jnp.asarray(x))) \
        <= JAX_TOL
    for got, want in zip(util.calc_mean_std(_nchw(x)),
                         jutil.calc_mean_std(jnp.asarray(x))):
        assert _rel(_nhwc(got), want) <= JAX_TOL
    got = util.adaptive_instance_normalization(_nchw(y), _nchw(x[:1]))
    want = jutil.adaptive_instance_normalization(jnp.asarray(y),
                                                 jnp.asarray(x[:1]))
    assert _rel(_nhwc(got), want) <= JAX_TOL


def _block_cases():
    from edvr_tpu.archs import dfdnet_arch as jarch
    from edvr_tpu.archs import dfdnet_util as jutil
    return {
        'attention': (jutil.AttentionBlock(8), util.AttentionBlock(8), 1),
        'conv_block_sn': (jutil.ConvBlockSN(8, 3, 2),
                          util.ConvBlockSN(8, 8, 3, 2), 1),
        'ms_dilation': (jutil.MSDilationBlock(8, dilation=(4, 3, 2, 1)),
                        util.MSDilationBlock(8, dilation=(4, 3, 2, 1)), 1),
        'up_res': (jutil.UpResBlock(8), util.UpResBlock(8), 1),
        'sft_up': (jarch.SFTUpBlock(8, 6), SFTUpBlock(8, 6), 2),
    }


@pytest.mark.parametrize('name', ['attention', 'conv_block_sn', 'ms_dilation',
                                  'up_res', 'sft_up'])
def test_block_matches_jax(name):
    """Each block from the same seeded variables (JAX's tree carried by
    ``jax_params_to_state_dict``, with DFDNet's key rules) at 1e-5."""
    jnet, net, n_in = _block_cases()[name]
    rng = np.random.RandomState(1)
    xs = [rng.randn(1, 12, 10, 8).astype(np.float32) for _ in range(n_in)]
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(x) for x in xs])['params']
    params = _draw(shapes, 2)
    want = jax.jit(jnet.apply)({'params': params},
                               *[jnp.asarray(x) for x in xs])
    # the block where DFDNet has one, so that its keys take DFDNet's rules
    scope, depth = {'attention': (('attn_blocks_nose_64',), 2),
                    'conv_block_sn': (('multi_scale_dilation',
                                       'conv_blocks_1'), 3),
                    'ms_dilation': (('multi_scale_dilation',), 1),
                    'up_res': (('upsample4_2',), 2),
                    'sft_up': (('upsample1',), 1)}[name]
    tree = jax.tree_util.tree_map(np.asarray, params)
    for s in reversed(scope):
        tree = {s: tree}
    state = {k.split('.', depth)[depth]: v
             for k, v in state_dict_from_jax(tree).items()}
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = net(*[_nchw(x) for x in xs])
    assert got.shape == (1, 6 if name == 'sft_up' else 8,
                         *[2 * s if name == 'sft_up' else s
                           for s in (12, 10)])
    assert _rel(_nhwc(got), want) <= JAX_TOL


# ---------------------------------------------------------------------- #
# the network
# ---------------------------------------------------------------------- #
# part windows (x0, y0, x1, y1) in a 128 px face: at every feature size
# (locations // 2, 4, 8, 16) at least one feature pixel a side
SMALL_LOCS = [np.array([[16, 32, 48, 64]]), np.array([[80, 32, 112, 64]]),
              np.array([[48, 48, 80, 96]]), np.array([[32, 80, 96, 112]])]


def small_dict(seed=5, k=3):
    """A seeded 3-entry dictionary, NCHW as torch.load gives the official
    one, at each feature size's width."""
    rng = np.random.RandomState(seed)
    shapes = {'left_eye': (6, 6), 'right_eye': (6, 6), 'nose': (5, 5),
              'mouth': (7, 7)}
    return {size: {part: rng.randn(k, c, *shapes[part]).astype(np.float32)
                   for part in PARTS} for size, c in SIZES.items()}


def jax_dfdnet_params(seed):
    """The JAX DFDNet's params: shapes by ``jax.eval_shape`` of an init
    that calls every submodule once (the network's own ``__call__`` needs
    concrete values), seeded values."""
    from edvr_tpu.archs.dfdnet_arch import DFDNet as JaxDFDNet
    net = JaxDFDNet(num_feat=64)

    def touch(m, x):
        feats = m.vgg_extractor(x)
        for idx, f_size in enumerate(m.feature_sizes):
            layer = feats[m.vgg_layers[idx]]
            for part in m.parts:
                m._attn[f'{part}_{f_size}'](layer)
        f = m.multi_scale_dilation(feats['conv5_4'])
        f = m.upsample0(f, feats['conv5_4'])
        f = m.upsample1(f, feats['relu4_4'])
        f = m.upsample2(f, feats['relu3_4'])
        f = m.upsample3(f, feats['relu2_2'])
        f = m.up4_res3(m.up4_res2(m.up4_conv0(f)))
        return m.up4_conv4(f)

    shapes = jax.eval_shape(lambda k: net.init(
        k, jnp.zeros((1, 128, 128, 3)), method=touch),
        jax.random.PRNGKey(0))['params']
    return net, _draw(shapes, seed)


@pytest.fixture(scope='module')
def dfdnet_params():
    return jax_dfdnet_params(3)


def test_dfdnet_matches_jax(monkeypatch, dfdnet_params):
    """The whole network at num_feat 64 on a seeded 128 px face (in
    [-1, 1]) with a seeded 3-entry dictionary, against JAX's ``apply``:
    the output at 1e-5 of max|out| and the same entry chosen by each of the
    16 swaps.

    JAX's network is eager by design (``int(jnp.argmax(sim))``); run op by
    op it compiles each operation (~40 s on the CPU), so it runs under
    ``jax.jit`` with its argmax, the one call that needs a concrete value,
    returning the port's choice, while a callback records JAX's own softmax
    at that call: the argmax of JAX's values must be that choice, so the
    pinned index is JAX's own. A precondition, not a choice of data: where
    two entries' softmax values lie within float32's rounding of each
    other, the two packages' orders of summation may pick different ones,
    so each swap's top two are held more than 1e-4 apart."""
    jnet, params = dfdnet_params
    x = (np.random.RandomState(4).rand(1, 128, 128, 3) * 2 - 1).astype(
        np.float32)
    dict_np = small_dict()
    net = DFDNet(num_feat=64)
    net.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = net(_nchw(x), SMALL_LOCS,
                  {s: {p: torch.from_numpy(v) for p, v in d.items()}
                   for s, d in dict_np.items()})
    assert got.shape == (1, 3, 128, 128)
    order = [(p, s) for s in (256, 128, 64, 32) for p in PARTS]
    chosen = [net.selected[k] for k in order]
    assert len(set(chosen)) > 1  # the swaps do not all take one entry

    sims = {}

    def pinned_argmax(a, *args, **kw):
        i = len(sims)
        sims[i] = None
        jax.debug.callback(lambda v: sims.__setitem__(i, np.asarray(v)), a)
        return chosen[i]

    monkeypatch.setattr(jnp, 'argmax', pinned_argmax)
    want = jax.jit(lambda p, x, d: jnet.apply({'params': p}, x, SMALL_LOCS,
                                              d))(
        params, jnp.asarray(x),
        {s: {p: jnp.asarray(np.moveaxis(v, 1, -1)) for p, v in d.items()}
         for s, d in dict_np.items()})
    jax.block_until_ready(want)
    monkeypatch.undo()
    assert [int(np.argmax(sims[i])) for i in range(16)] == chosen
    assert _rel(_nhwc(got), want) <= JAX_TOL, _rel(_nhwc(got), want)
    for i, key in enumerate(order):
        for sim in (net.similarity[key].numpy(), sims[i]):
            top = np.sort(sim)[-2:]
            assert top[1] - top[0] > 1e-4, (key, sim)


def test_nearest_indices_match_jax():
    """The nearest resize back to each part's crop: JAX's float64 source
    rows for the sizes DFDNet meets (entries of 5-7 px onto crops of 1-40
    px)."""
    from edvr_tpu.ops.resize import _nearest_src
    for src in (5, 6, 7):
        for out in range(1, 41):
            assert nearest_indices(out, src).tolist() == \
                _nearest_src(out, src).tolist()


# ---------------------------------------------------------------------- #
# weights
# ---------------------------------------------------------------------- #
def test_fold_spectral_norm_matches_torch():
    """As tests/test_dfdnet.py::test_fold_spectral_norm, through the port's
    copy; and the JAX package's fold gives the same weight."""
    from edvr_tpu.convert.torch_import import fold_spectral_norm as jfold
    torch.manual_seed(0)
    conv = torch.nn.utils.spectral_norm(torch.nn.Conv2d(4, 6, 3))
    conv.eval()
    x = torch.randn(1, 4, 8, 8)
    with torch.no_grad():
        ref = conv(x)
    state = dict(conv.state_dict())
    folded = fold_spectral_norm(state)
    assert set(folded) == {'weight', 'bias'}
    plain = torch.nn.Conv2d(4, 6, 3)
    plain.load_state_dict(folded)
    with torch.no_grad():
        out = plain(x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    want = jfold({k: v.numpy() for k, v in state.items()})['weight']
    np.testing.assert_allclose(folded['weight'].numpy(), want, rtol=1e-6,
                               atol=0)


def official_dfdnet_keys():
    """A state dict in csxmli2016's official naming: one key per rule of
    ``remap_dfdnet`` and one it does not know."""
    keys = ['VggExtract.RGB_mean', 'VggExtract.RGB_std',
            'VggExtract.model.features.0.weight',
            'VggExtract.model.features.34.bias', 'le.0.weight_orig',
            're.2.weight_u', 'no.0.bias', 'mo.2.weight_v',
            'MSDilate.conv1.0.weight_orig', 'MSDilate.conv4.2.bias',
            'MSDilate.convi.weight_orig', 'up4.Model.0.weight',
            'up0.ScaleModel1.0.weight', 'up3.ShiftModel1.2.bias',
            'up1.conv1.1.weight_orig', 'up2.convup.1.bias', 'unknown.weight']
    return {k: torch.full((2,), float(i)) for i, k in enumerate(keys)}


def test_remap_dfdnet_matches_jax(tmp_path):
    from edvr_tpu.archs.vgg_arch import NAMES as JAX_NAMES
    from edvr_tpu.convert.official import remap_dfdnet as jremap
    from edvr_tpu_torch.convert import official
    state = official_dfdnet_keys()
    got, unmatched = official.remap_dfdnet(state)
    want, junmatched = jremap(state, list(JAX_NAMES['vgg19']))
    assert unmatched == junmatched == ['unknown.weight']
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in got)
    src = str(tmp_path / 'official.pth')
    torch.save(state, src)
    written, _ = official.main(['--source', 'DFDNet', '--pth', src, '--out',
                                str(tmp_path / 'out.pth')])
    assert list(written) == list(want)


def test_state_dict_from_jax_keys(dfdnet_params):
    """The JAX DFDNet tree's scopes reach every key of the port's DFDNet
    but the normalisation buffers, which loading fills."""
    _, params = dfdnet_params
    state = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    own = DFDNet(num_feat=64).state_dict()
    assert set(own) - set(state) == {'vgg_extractor.mean',
                                     'vgg_extractor.std'}
    assert set(state) <= set(own)
    assert all(state[k].shape == own[k].shape for k in state)
    assert 'attn_blocks.left_eye_256.0.weight' in state
    assert 'multi_scale_dilation.conv_blocks.3.2.weight' in state
    assert 'upsample4.3.body.2.bias' in state


# ---------------------------------------------------------------------- #
# the face pipeline after detection
# ---------------------------------------------------------------------- #
def face_case(seed=0):
    """A seeded 2-face BGR image at 192x256 and each face's 5 landmarks:
    the FFHQ template scaled and moved (no detector here)."""
    from edvr_tpu_torch.utils.face_util import FFHQ_TEMPLATE_1024
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (192, 256, 3)).astype(np.uint8)
    marks = [FFHQ_TEMPLATE_1024 * 0.09 + np.array([20., 15.]),
             FFHQ_TEMPLATE_1024 * 0.07 + np.array([140., 70.])
             + rng.randn(5, 2)]
    return img, marks


@pytest.mark.parametrize('upscale', [1, 2])
def test_face_helper_matches_jax(upscale):
    """``umeyama_similarity``, the warp and crop, and the paste at x1 and
    x2 with the soft mask, bitwise against JAX's helper on the same
    landmarks and faces."""
    from edvr_tpu.utils import face_util as jface
    from edvr_tpu_torch.utils import face_util
    img, marks = face_case()
    helpers = []
    for mod in (face_util, jface):
        h = mod.FaceRestorationHelper(upscale, face_size=64)
        h.input_img = img[..., ::-1].copy()  # RGB, as read_input_image
        h.all_landmarks_5 = [m.copy() for m in marks]
        h.warp_crop_faces()
        for face in h.cropped_faces:
            h.add_restored_face(np.ascontiguousarray(255 - face[..., ::-1]))
        helpers.append(h)
    port, jax_h = helpers
    for a, b in zip(port.affine_matrices + port.inverse_affine_matrices,
                    jax_h.affine_matrices + jax_h.inverse_affine_matrices):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.cropped_faces, jax_h.cropped_faces):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        face_util.umeyama_similarity(marks[1], port.face_template),
        jface.umeyama_similarity(marks[1], jax_h.face_template))
    got = port.paste_faces_to_input_image()
    assert got.shape == (192 * upscale, 256 * upscale, 3)
    written = []
    orig = jface.imwrite
    jface.imwrite = lambda im, path: written.append(im)
    try:
        jax_h.paste_faces_to_input_image('unused.png')
    finally:
        jface.imwrite = orig
    np.testing.assert_array_equal(got.astype(np.uint8), written[0])


def test_face_helper_without_dlib(monkeypatch):
    from edvr_tpu_torch.utils import face_util
    monkeypatch.setattr(face_util, 'HAS_DLIB', False)
    with pytest.raises(ImportError, match='dlib'):
        face_util.FaceRestorationHelper(2).init_dlib('a', 'b', 'c')


def test_get_part_location_matches_jax():
    import importlib.util
    from edvr_tpu_torch.tools.inference_dfdnet import get_part_location
    spec = importlib.util.spec_from_file_location(
        'jax_inference_dfdnet', osp.join(osp.dirname(osp.dirname(
            osp.abspath(__file__))), 'inference', 'inference_dfdnet.py'))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    marks = np.random.RandomState(2).rand(68, 2) * 400 + 50
    for a, b in zip(get_part_location(marks), jmod.get_part_location(marks)):
        np.testing.assert_array_equal(a, b)


def test_restore_face_and_tool_on_cpu(monkeypatch):
    """``restore_face`` on a 128 px face, and the tool's loader from a
    BasicSR-style state dict with spectral norms (folded as read; the file
    read is ``load_state_dict_file``'s, stubbed here rather than writing
    DFDNet's 480 MB)."""
    from edvr_tpu_torch.tools import inference_dfdnet as tool
    net = DFDNet(num_feat=64)
    state = {}
    for k, v in net.state_dict().items():
        if k.endswith('attn_blocks.nose_64.0.weight'):
            base = k[:-len('weight')]
            w_mat = v.reshape(v.shape[0], -1)
            u = torch.randn(v.shape[0])
            vv = torch.randn(w_mat.shape[1])
            state[base + 'weight_orig'] = v * 3
            state[base + 'weight_u'] = u
            state[base + 'weight_v'] = vv
        else:
            state[k] = v
    from edvr_tpu_torch import convert
    monkeypatch.setattr(convert, 'load_state_dict_file',
                        lambda path: state if path == 'DFDNet.pth' else None)
    loaded = tool.load_dfdnet('DFDNet.pth', 'cpu')
    k = 'attn_blocks.nose_64.0.weight'
    w = state[k + '_orig']
    sigma = state[k + '_u'] @ (w.reshape(w.shape[0], -1) @ state[k + '_v'])
    assert torch.allclose(loaded.state_dict()[k], w / sigma)
    face = np.random.RandomState(7).randint(0, 256, (128, 128, 3)).astype(
        np.uint8)
    dict_feat = tool.dict_to(small_dict(), 'cpu')
    res = tool.restore_face(loaded, face, SMALL_LOCS, dict_feat)
    assert res.shape == (128, 128, 3) and res.dtype == np.uint8


@pytest.mark.slow  # the 428 MB golden, a 512 px face on the CPU
def test_dfdnet_golden():
    """The golden's BasicSR state dict, folded, loads strictly; the 512 px
    output within 3e-4 of max|out| (tests/test_dfdnet.py's tolerance)."""
    data = np.load(GOLDEN)
    state = fold_spectral_norm({k[3:]: torch.from_numpy(data[k])
                                for k in data.files if k.startswith('sd.')})
    dict_feat = {}
    for k in data.files:
        if k.startswith('dict.'):
            _, size, part = k.split('.')
            dict_feat.setdefault(size, {})[part] = torch.from_numpy(data[k])
    net = DFDNet(num_feat=64)
    net.load_state_dict(state, strict=True)
    locs = [data['__locs__'][i] for i in range(4)]
    with torch.no_grad():
        out = net(torch.from_numpy(data['__input__']), locs, dict_feat)
    ref = data['__output__']
    assert _rel(out.numpy(), ref) <= GOLDEN_TOL
