"""Card-only tests of the port's CUDA kernels and CUDA path.

Run on a machine with a CUDA card (the repo-root conftest imports jax,
which such a machine may lack, hence ``--noconftest``):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Everywhere else every test here skips; the decision is made inside the
``cuda`` fixture, never at import or collection time. This file imports no
jax.
"""

import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from edvr_tpu_torch.archs import define_network  # noqa: E402
from edvr_tpu_torch.archs.edvr_arch import (  # noqa: E402
    clip_window_indices, make_clip_restore_fn)
from edvr_tpu_torch.ops import dcn  # noqa: E402

pytestmark = pytest.mark.gpu

GOLDEN = osp.join(osp.dirname(__file__), 'data', 'golden',
                  'arch_edvr_m_full.npz')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    # fp32 references: no TF32 in cuDNN convs or matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _case(seed, n, cin, cout, h, w, dg, k=3, stride=1, padding=1,
          dilation=1, far=0.0, bias=True):
    rng = np.random.RandomState(seed)
    K = k * k
    oh = (h + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1
    ow = (w + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1
    x = rng.randn(n, cin, h, w)
    off = rng.uniform(-2, 2, (n, dg * 2 * K, oh, ow))
    if far:
        sel = rng.rand(*off.shape) < far
        off = np.where(sel, rng.uniform(10, 40, off.shape)
                       * rng.choice([-1, 1], off.shape), off)
    mask = 1 / (1 + np.exp(-rng.randn(n, dg * K, oh, ow)))
    weight = rng.randn(cout, cin, k, k) / np.sqrt(cin * K)
    b = rng.randn(cout) if bias else None
    t = [torch.from_numpy(np.asarray(a, np.float32)).cuda()
         for a in (x, off, mask, weight)]
    t.append(torch.from_numpy(b.astype(np.float32)).cuda() if bias
             else None)
    return t, dict(stride=stride, padding=padding, dilation=dilation,
                   deformable_groups=dg)


def _blend_bf16_args(seed, NP, K, lanes, c_per, cout):
    """bf16 g_cat, cs_cat (coefficients in [0, 1]), wexp_g; f32 out_prev."""
    gen = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    return [torch.randn(NP, K * lanes, generator=gen).to('cuda', bf16),
            torch.rand(NP, K * lanes // c_per, generator=gen).to('cuda', bf16),
            (torch.randn(K * lanes, cout, generator=gen) * 0.1).to('cuda',
                                                                    bf16),
            torch.randn(NP, cout, generator=gen).to('cuda')]


@pytest.mark.parametrize('NP,K,lanes,c_per,cout', [
    (1000 + 13, 9, 128, 8, 64),    # EDVR-M, ragged rows
    (300, 9, 128, 16, 128),        # EDVR-L
    (300, 9, 128, 16, 70),         # ragged channels: wexp_g by plain loads
    (70, 3, 32, 4, 24),            # a width of 96: a ragged 64-wide chunk
    *[(777, K, 128, c_per, 64) for c_per in (1, 2, 4, 8, 16, 32)
      for K in (1, 9)],
    *[(777, K, 128, c_per, 128) for c_per in (1, 2, 4, 8, 16, 32)
      for K in (1, 9)],
    (1000 + 13, 9, 128, 16, 100),  # ragged rows and channels, one block
                                   # column of 128
    (100, 9, 128, 16, 200),        # cout above 128: two block columns
    (70, 3, 32, 4, 128),           # a ragged 64-wide chunk at cout 128
    (5, 1, 128, 1, 128),           # fewer rows than one block
])
def test_blend_bf16_kernel_matches_plain(cuda, NP, K, lanes, c_per, cout):
    """blend_matmul_bf16 against its plain version (the bf16 products,
    their exact values contracted in float32): one launch under its own
    count, a float32 result within 1e-4 of max|out| (the same bf16
    products summed in another order)."""
    from edvr_tpu_torch.ops import dcn_blend
    args = _blend_bf16_args(NP, NP, K, lanes, c_per, cout)
    before = dict(dcn.LAUNCHES)
    got = dcn_blend.blend_matmul_cuda(*args, c_per)
    want = dcn_blend.blend_matmul_group_plain(*args, c_per)
    torch.cuda.synchronize()
    assert {k: dcn.LAUNCHES[k] - before[k] for k in before} == _launches(
        blend_matmul_bf16=1)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_blend_bf16_wrapper_refuses(cuda):
    from edvr_tpu_torch.ops import dcn_blend
    g, cs, w, prev = _blend_bf16_args(0, 64, 9, 128, 8, 64)
    for bad in ((g.float(), cs, w), (g, cs.float(), w), (g, cs, w.float())):
        with pytest.raises(TypeError, match='one dtype'):
            dcn_blend.blend_matmul_cuda(*bad, prev, 8)
    with pytest.raises(TypeError, match='out_prev'):
        dcn_blend.blend_matmul_cuda(g, cs, w, prev.bfloat16(), 8)
    with pytest.raises(ValueError, match='multiple of 8'):
        dcn_blend.blend_matmul_cuda(g[:, :1148].contiguous(), cs[:, :1].
                                    contiguous(), w[:1148], prev, 8)
    with pytest.raises(ValueError, match='even count'):  # 1 slot of 8
        dcn_blend.blend_matmul_cuda(g[:, :8].contiguous(),
                                    cs[:, :1].contiguous(), w[:8], prev, 8)


@pytest.mark.parametrize('geo', [
    dict(n=5, cin=64, cout=64, h=45, w=80, dg=8, far=0.05),   # EDVR-M L3
    dict(n=2, cin=64, cout=64, h=33, w=47, dg=8, far=0.5),
    dict(n=1, cin=16, cout=16, h=32, w=64, dg=2, far=0.01),
    dict(n=2, cin=16, cout=24, h=20, w=28, dg=4),             # c_per 4
    dict(n=1, cin=6, cout=70, h=13, w=17, dg=3),              # c_per 2
    dict(n=1, cin=4, cout=8, h=11, w=9, dg=4, bias=False),    # c_per 1
    dict(n=2, cin=32, cout=16, h=17, w=21, dg=1, stride=2),   # c_per 32
    dict(n=1, cin=16, cout=16, h=19, w=23, dg=1, padding=0, dilation=2),
])
def test_kernel_matches_plain(cuda, geo):
    args, kw = _case(0, **geo)
    before = dcn.LAUNCHES['dcn_fwd']
    with torch.no_grad():
        got = dcn.dcn_fwd_cuda(*args, **kw)
        want = dcn.modulated_deform_conv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES['dcn_fwd'] == before + 1
    assert got.shape == want.shape
    # same fp32 arithmetic, other summation order
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# the tensor-core forward's slabs and chunks: EDVR-L's c_per 16 and cout 128
# (two 64-channel chunks on one column), tap_shared's K=1 (eight groups in
# one slab), and K*C_PER = 72 and 36 (a ragged last slab: half an m16n8k16
# depth in bf16)
TENSOR_CORE_GEOS = [
    dict(n=2, cin=128, cout=128, h=23, w=29, dg=8, far=0.05),   # EDVR-L
    dict(n=2, cin=64, cout=64, h=15, w=21, dg=8, k=1, padding=0,
         far=0.05),                                              # K=1
    dict(n=1, cin=8, cout=24, h=14, w=18, dg=1, far=0.1),       # 72 rows
    dict(n=2, cin=4, cout=16, h=10, w=12, dg=1),                # 36 rows
]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('geo', TENSOR_CORE_GEOS)
def test_fwd_tensor_core_geometries(cuda, geo, dtype):
    """The forward at the tensor-core kernel's slab and chunk edges, at the
    forward's unchanged tolerances (fp32 1e-4 absolute, bf16 1e-2 of
    max|out|)."""
    args, kw = _case(20, **geo)
    args = [a if a is None else a.to(dtype) for a in args]
    key = 'dcn_fwd' + dcn.KERNEL_DTYPES[dtype]
    before = dcn.LAUNCHES[key]
    with torch.no_grad():
        got = dcn.dcn_fwd_cuda(*args, **kw)
        want = dcn.modulated_deform_conv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES[key] == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        assert _rel_err(got, want) <= BF16_FWD_TOL, _rel_err(got, want)


def test_fwd_deep_n01_within_tol(cuda):
    """c_per 32, cin 128, cout 128 and N(0, 1) weights (outputs up to
    ~50), against the plain version in float64: the deep, large sums where
    truncating accumulators drift. tests/test_torch_tf32split.py emulates
    this case: a running sum misses 1e-4 (~5e-4), the kernel's 64-row slab
    sums hold it (~3e-5)."""
    args, kw = _case(21, n=1, cin=128, cout=128, h=16, w=20, dg=4,
                     far=0.05)
    rng = np.random.RandomState(22)
    args[3] = torch.from_numpy(rng.randn(128, 128, 3, 3).astype(
        np.float32)).cuda()
    with torch.no_grad():
        got = dcn.dcn_fwd_cuda(*args, **kw)
        want = dcn.modulated_deform_conv_plain(
            *(a.double() for a in args), **kw)
    torch.cuda.synchronize()
    assert want.abs().max() > 20
    torch.testing.assert_close(got.double(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fwd_is_deterministic(cuda, dtype):
    """No atomics: two runs of the forward are bitwise equal (cout 130:
    two chunks on one column and a ragged block of channels)."""
    args, kw = _case(23, n=3, cin=64, cout=130, h=27, w=35, dg=8, far=0.05)
    args = [a.to(dtype) for a in args]
    with torch.no_grad():
        first = dcn.dcn_fwd_cuda(*args, **kw)
        second = dcn.dcn_fwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kernel_taps_wholly_outside(cuda):
    """Offsets that throw every tap far outside the image give the bias."""
    args, kw = _case(1, n=1, cin=64, cout=64, h=12, w=20, dg=8)
    args[1] = torch.full_like(args[1], 1e6)
    with torch.no_grad():
        got = dcn.dcn_fwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    expect = args[4].view(1, -1, 1, 1).expand_as(got)
    torch.testing.assert_close(got, expect, atol=0, rtol=0)


def test_wrapper_refuses(cuda):
    args, kw = _case(2, n=1, cin=16, cout=16, h=8, w=8, dg=2)
    x, off, mask, weight, bias = args
    with pytest.raises(TypeError):
        dcn.dcn_fwd_cuda(x.double(), off, mask, weight, bias, **kw)
    with pytest.raises(ValueError):
        dcn.dcn_fwd_cuda(x, off, mask, weight.cpu(), bias, **kw)
    with pytest.raises(ValueError):
        dcn.dcn_fwd_cuda(x, off[:, :-2], mask, weight, bias, **kw)
    with pytest.raises(ValueError):
        dcn.dcn_fwd_cuda(x, off.transpose(2, 3).contiguous().transpose(
            2, 3), mask, weight, bias, **kw)
    with pytest.raises(ValueError):
        dcn.modulated_deform_conv(x, off, mask, weight[:, :8], bias,
                                  groups=2, **kw)
    with pytest.raises(ValueError):
        dcn.dcn_fwd_cuda(x[:, :12], off, mask, weight[:, :12], bias,
                         deformable_groups=4, stride=1, padding=1)
    with pytest.raises(ValueError):
        dcn.dcn_bwd_cuda(torch.zeros(1, 16, 4, 4, device=cuda), x, off,
                         mask, weight, **kw)
    with pytest.raises(ValueError, match='taps'):  # 1x3: neither 1x1 nor 3x3
        dcn.dcn_bwd_cuda(torch.zeros(1, 16, 8, 6, device=cuda), x,
                         torch.zeros(1, 12, 8, 6, device=cuda),
                         torch.zeros(1, 6, 8, 6, device=cuda),
                         weight[:, :, :1, :].contiguous(),
                         deformable_groups=2)


def test_golden_edvr_m_on_cuda(cuda):
    data = np.load(GOLDEN)
    net = define_network(json.loads(bytes(data['__config__']).decode()))
    net.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files
                         if not k.startswith('__')}, strict=True)
    net = net.to(cuda).eval()
    before = dcn.LAUNCHES['dcn_fwd']
    with torch.no_grad():
        out = net(torch.from_numpy(data['__input__']).to(cuda)).cpu()
    assert dcn.LAUNCHES['dcn_fwd'] == before + 4  # L3, L2, L1, cascade
    np.testing.assert_allclose(out.numpy(), data['__output__'], atol=3e-4)


def test_clip_restore_cuda_matches_cpu(cuda):
    torch.manual_seed(0)
    net = define_network(dict(type='EDVR', num_feat=16, deformable_groups=2,
                              num_extract_block=1,
                              num_reconstruct_block=1)).eval()
    with torch.no_grad():  # non-zero offsets, so the DCN samples move
        for mod in net.modules():
            if hasattr(mod, 'conv_offset'):
                mod.conv_offset.weight.normal_(0, 0.05)
    clip = torch.rand(7, 3, 32, 32, generator=torch.Generator()
                      .manual_seed(1))
    idx = clip_window_indices(7, 5)
    want = make_clip_restore_fn(net)(clip, idx)
    got = make_clip_restore_fn(net.to(cuda), win_batch=3)(clip.to(cuda),
                                                          idx).cpu()
    torch.testing.assert_close(got, want, atol=3e-4, rtol=0)


def _plain_grads(args, kw, dout):
    """Gradients of <dout, plain DCN> by autograd, on the card."""
    leaves = [a.detach().clone().requires_grad_() for a in args[:4]]
    out = dcn.modulated_deform_conv_plain(*leaves, args[4], **kw)
    return torch.autograd.grad(out, leaves, dout)


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def _launches(**counts):
    """A launch-count delta: the given kernel entries, every other 0."""
    return {k: counts.get(k, 0) for k in dcn.LAUNCHES}


# the one-launch backward at c_per 1, 2, 8 and 32 with n > 1 images and 13
# x 17 = 221 pixels, a ragged last 64-pixel tile
FUSED_BWD_GEOS = [dict(n=3, cin=2 * c, cout=48, h=13, w=17, dg=2, far=0.1)
                  for c in (1, 2, 8, 32)]

# fp32 on both sides; sums over up to K*c_per*cout (dcol), n*P (dW) and the
# scattered corners (dx, with atomics in a varying order) taken in another
# order, so each gradient is held relative to its own largest entry
BWD_TOL = 1e-4


@pytest.mark.parametrize('geo', [
    dict(n=20, cin=64, cout=64, h=16, w=16, dg=8, far=0.05),  # EDVR-M L3
    dict(n=2, cin=64, cout=64, h=33, w=47, dg=8, far=0.5),
    dict(n=2, cin=16, cout=24, h=20, w=28, dg=4),              # c_per 4
    dict(n=1, cin=6, cout=70, h=13, w=17, dg=3),               # c_per 2
    dict(n=1, cin=4, cout=8, h=11, w=9, dg=4, bias=False),     # c_per 1
    dict(n=2, cin=32, cout=16, h=17, w=21, dg=1, stride=2),    # c_per 32
    dict(n=1, cin=32, cout=130, h=12, w=14, dg=2, far=0.1),    # c_per 16
    dict(n=1, cin=16, cout=16, h=19, w=23, dg=1, padding=0, dilation=2),
    dict(n=2, cin=16, cout=16, h=9, w=10, dg=2, k=1, padding=0),  # 1x1
    *FUSED_BWD_GEOS,
])
def test_bwd_kernel_matches_plain(cuda, geo):
    args, kw = _case(3, **geo)
    with torch.no_grad():
        out = dcn.modulated_deform_conv_plain(*args, **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)
                       ).to(cuda)
    before = dcn.LAUNCHES['dcn_bwd']
    got = dcn.dcn_bwd_cuda(dout, *args[:4], **kw)
    want = _plain_grads(args, kw, dout)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES['dcn_bwd'] == before + 1
    for name, g, w in zip(('dx', 'd_offset', 'd_mask', 'd_weight'), got,
                          want):
        assert g.shape == w.shape, name
        assert _rel_err(g, w) <= BWD_TOL, (name, _rel_err(g, w))


def test_bwd_integer_offsets(cuda):
    """Offsets that are exactly integer (a fresh EDVR's zero conv_offset)
    take the floor convention of the plain version."""
    args, kw = _case(5, n=2, cin=64, cout=64, h=16, w=16, dg=8)
    args[1] = torch.randint(-3, 4, args[1].shape, device=cuda).float()
    dout = torch.randn(2, 64, 16, 16, device=cuda)
    got = dcn.dcn_bwd_cuda(dout, *args[:4], **kw)
    want = _plain_grads(args, kw, dout)
    for name, g, w in zip(('dx', 'd_offset', 'd_mask', 'd_weight'), got,
                          want):
        assert _rel_err(g, w) <= BWD_TOL, (name, _rel_err(g, w))


def test_bwd_taps_wholly_outside(cuda):
    """Taps thrown far outside the image give zero to every gradient."""
    args, kw = _case(6, n=1, cin=64, cout=64, h=12, w=20, dg=8)
    args[1] = torch.full_like(args[1], -1e6)
    dout = torch.randn(1, 64, 12, 20, device=cuda)
    for g in dcn.dcn_bwd_cuda(dout, *args[:4], **kw):
        assert torch.count_nonzero(g).item() == 0


def test_autograd_function_on_cuda(cuda):
    """modulated_deform_conv on CUDA tensors differentiates through both
    kernels, bias included, and agrees with plain autograd."""
    args, kw = _case(7, n=2, cin=32, cout=32, h=14, w=18, dg=4, far=0.05)
    leaves = [a.clone().requires_grad_() for a in args]
    before = dict(dcn.LAUNCHES)
    out = dcn.modulated_deform_conv(*leaves, **kw)
    (out * out.cos()).sum().backward()
    assert dcn.LAUNCHES['dcn_fwd'] == before['dcn_fwd'] + 1
    assert dcn.LAUNCHES['dcn_bwd'] == before['dcn_bwd'] + 1
    ref = [a.clone().requires_grad_() for a in args]
    out_p = dcn.modulated_deform_conv_plain(*ref, **kw)
    (out_p * out_p.cos()).sum().backward()
    for a, b in zip(leaves, ref):
        assert _rel_err(a.grad, b.grad) <= BWD_TOL


def test_edvr_train_steps_cuda_match_cpu(cuda):
    """Two EDVR training steps through the engine on the card and on the
    CPU from the same weights and batches: the gradients agree."""
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.utils.options import parse_dict
    import tempfile
    opt = dict(
        name='cuda_vs_cpu', model_type='EDVRModel', scale=4, num_gpu=1,
        manual_seed=0,
        network_g=dict(type='EDVR', num_in_ch=3, num_out_ch=3, num_feat=16,
                       num_frame=5, deformable_groups=2, num_extract_block=1,
                       num_reconstruct_block=1, center_frame_idx=None,
                       hr_in=False, with_predeblur=False, with_tsa=True),
        path=dict(pretrain_network_g=None, strict_load_g=True),
        train=dict(optim_g=dict(type='Adam', lr=4e-4, weight_decay=0,
                                betas=[0.9, 0.99]),
                   scheduler=dict(type='CosineAnnealingRestartLR',
                                  periods=[10], restart_weights=[1],
                                  eta_min=1e-7),
                   total_iter=10, warmup_iter=-1, dcn_lr_mul=1,
                   mixed_precision=None, tsa_iter=0,
                   pixel_opt=dict(type='CharbonnierLoss', loss_weight=1.0,
                                  reduction='sum')))
    gen = torch.Generator().manual_seed(8)
    batches = [dict(lq=torch.rand(2, 5, 3, 16, 16, generator=gen),
                    gt=torch.rand(2, 3, 64, 64, generator=gen))
               for _ in range(2)]
    models = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ('cpu', 'cuda'):
            o = parse_dict(json.loads(json.dumps(opt)), is_train=True,
                           root=tmp)
            o['device'] = dev
            models[dev] = create_model(o)
        with torch.no_grad():  # non-zero offsets, so the DCN samples move
            for name, p in models['cpu'].net_g.named_parameters():
                if 'conv_offset' in name:
                    p.normal_(0, 0.05, generator=gen)
        for it, batch in enumerate(batches, 1):
            # each step's gradients are taken at the same parameters
            models['cuda'].net_g.load_state_dict(
                models['cpu'].net_g.state_dict())
            grads = {}
            for dev, model in models.items():
                model.feed_data(batch)
                model.optimize_parameters(it)
                grads[dev] = {n: p.grad.detach().cpu() for n, p in
                              model.net_g.named_parameters()}
            # as chip_smoke.py's STEP_GRAD_TOL: fp32 through the whole
            # network with cuDNN's and the CPU's conv algorithms
            for name, g in grads['cpu'].items():
                assert _rel_err(grads['cuda'][name], g) <= 1e-3, name


# --- the packed DCN route: row gather and blend GEMM kernels -------------

@pytest.mark.parametrize('R,L,G', [
    (3600, 128, 4096),     # probe_mosaic_gather.py's smallest table
    (1000, 128, 8003),     # a ragged last block of rows
    (37, 126, 515),        # a row of 126 floats: the 4-byte path
    (5, 4, 1),
    (1000, 64, 8003),      # 64 words: two rows a warp, ragged
    (5000, 128, 100),      # G below one wave of the grid
    (700, 64, 37),
    (40, 8, 77),           # 8 words: 16 rows a warp
    (37, 132, 515),        # 33 pieces of 16 bytes: a warp per row
    (300, 36, 999),        # 9 pieces: a warp per row
    (3, 128, 3_000_000),   # a grid-stride loop of many steps
])
def test_row_gather_kernel_matches_index_select(cuda, R, L, G):
    from edvr_tpu_torch.ops import gather
    gen = torch.Generator().manual_seed(R + G)
    table = torch.randn(R, L, generator=gen).to(cuda)
    idx = torch.randint(0, R, (G,), generator=gen, dtype=torch.int32).to(
        cuda)
    before = dcn.LAUNCHES['row_gather']
    got = gather.row_gather_cuda(table, idx)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES['row_gather'] == before + 1
    assert torch.equal(got, table.index_select(0, idx))  # bitwise


def test_row_gather_kernel_bf16_table(cuda):
    """A bf16 table (the packed route's bf16 step) is gathered as the
    32-bit words holding its pairs of lanes: bitwise index_select, one
    launch; an odd row length refuses."""
    from edvr_tpu_torch.ops import gather
    gen = torch.Generator().manual_seed(5)
    table = torch.randn(1000, 128, generator=gen).to(cuda, torch.bfloat16)
    idx = torch.randint(0, 1000, (8003,), generator=gen,
                        dtype=torch.int32).to(cuda)
    before = dcn.LAUNCHES['row_gather']
    got = gather.row_gather_cuda(table, idx)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES['row_gather'] == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, table.index_select(0, idx))
    with pytest.raises(ValueError, match='even'):
        gather.row_gather_cuda(table[:, :127].contiguous(), idx)


@pytest.mark.parametrize('R,lanes,G', [
    (1000, 128, 8003),     # the packed route's bf16 tiles: 64 words
    (1000, 256, 8003),     # 128 words
    (5000, 128, 100),      # G below one wave of the grid
    (77, 128, 1),
    (300, 64, 999),        # 32 words
])
def test_row_gather_kernel_bf16_tables(cuda, R, lanes, G):
    """bf16 tables of 64 and 128 words a row, gathered bitwise as
    index_select, one launch each."""
    from edvr_tpu_torch.ops import gather
    gen = torch.Generator().manual_seed(R + G + lanes)
    table = torch.randn(R, lanes, generator=gen).to(cuda, torch.bfloat16)
    idx = torch.randint(0, R, (G,), generator=gen, dtype=torch.int32).to(
        cuda)
    before = dcn.LAUNCHES['row_gather']
    got = gather.row_gather_cuda(table, idx)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES['row_gather'] == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, table.index_select(0, idx))


# an out-of-range index fails the kernel with a device-side assertion, as
# index_select does; the context is then lost, so each case runs in a
# child process
_OUT_OF_RANGE = """
import sys
import torch
sys.path.insert(0, {root!r})
from edvr_tpu_torch.ops import gather
table = torch.randn(10, 128, device='cuda')
idx = torch.tensor([0, 3, {bad}, 9], dtype=torch.int32, device='cuda')
out = gather.row_gather_cuda(table, idx)
torch.cuda.synchronize()
print('no error', out.abs().sum().item())
"""


def test_row_gather_kernel_refuses(cuda):
    from edvr_tpu_torch.ops import gather
    import subprocess
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    for bad in (10, -1):
        child = subprocess.run(
            [sys.executable, '-c', _OUT_OF_RANGE.format(root=root, bad=bad)],
            capture_output=True, text=True, timeout=600)
        said = child.stdout + child.stderr
        assert child.returncode != 0 and 'no error' not in said, said
        assert 'device-side assert' in said, said[-2000:]
    table = torch.randn(10, 128, device=cuda)
    idx = torch.tensor([0, 3, 9, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        gather.row_gather_cuda(table, idx.long())
    with pytest.raises(ValueError, match='CUDA'):
        gather.row_gather_cuda(table, idx.cpu())
    with pytest.raises(ValueError, match='contiguous'):
        gather.row_gather_cuda(table.t(), idx[:2].clamp(0, 3))


def test_launch_takes_the_current_stream(cuda):
    """native.launch hands each kernel the caller's current stream: the
    raw handle it reads equals torch.cuda.current_stream's on the default
    stream and under a side stream, and a gather queued on the side stream
    is right once that stream is done."""
    from edvr_tpu_torch import native
    from edvr_tpu_torch.ops import gather
    index = torch.cuda.current_device()
    default = torch.cuda.current_stream(index).cuda_stream
    assert native.raw_stream(index) == default
    table = torch.randn(1000, 128, device=cuda)
    idx = torch.randint(0, 1000, (8003,), device=cuda, dtype=torch.int32)
    want = table.index_select(0, idx)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert native.raw_stream(index) == side.cuda_stream != default
        got = gather.row_gather_cuda(table, idx)
    side.synchronize()
    assert native.raw_stream(index) == default
    assert torch.equal(got, want)


def _blend_args(seed, NP, K, lanes, c_per, cout):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=gen).to('cuda') for s in (
        (NP, K * lanes), (NP, K * lanes // c_per), (K * lanes, cout),
        (NP, cout))]


@pytest.mark.parametrize('NP,K,lanes,c_per,cout', [
    (70, 3, 32, 4, 24),
    (1000 + 13, 9, 128, 8, 64),    # EDVR-M, ragged rows
    (300, 9, 128, 16, 70),         # ragged channels
    (129, 1, 128, 32, 64),         # K=1 (tap_shared's warp)
    (65, 9, 128, 1, 8),
    (65, 9, 128, 2, 8),
    # every c_per at K = 1 (a width the packed route never sends, which
    # the wrapper takes) and 9, 777 rows (a ragged last block of 128) and
    # one or two blocks of 64 output channels
    *[(777, K, 128, c_per, cout) for c_per in (1, 2, 4, 8, 16, 32)
      for K in (1, 9) for cout in (64, 128)],
])
def test_blend_kernel_matches_plain(cuda, NP, K, lanes, c_per, cout):
    from edvr_tpu_torch.ops import dcn_blend
    args = _blend_args(NP, NP, K, lanes, c_per, cout)
    before = dcn.LAUNCHES['blend_matmul']
    got = dcn_blend.blend_matmul_cuda(*args, c_per)
    want = dcn_blend.blend_matmul_group_plain(*args, c_per)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES['blend_matmul'] == before + 1
    # fp32 products against 3xTF32 ones (about 2^-22 of each product) summed
    # in another order: a few 1e-7 of max|out| over the 1152-deep sums;
    # one TF32 product alone (2^-11) would miss the bound
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_blend_wrapper_refuses(cuda):
    from edvr_tpu_torch.ops import dcn_blend
    args = _blend_args(0, 64, 3, 24, 3, 8)  # c_per 3: no instantiation
    with pytest.raises(ValueError, match='c_per'):
        dcn_blend.blend_matmul_cuda(*args, 3)
    args = _blend_args(0, 64, 3, 32, 4, 8)
    with pytest.raises(TypeError):
        dcn_blend.blend_matmul_cuda(args[0].double(), *args[1:], 4)
    with pytest.raises(ValueError, match='CUDA'):
        dcn_blend.blend_matmul_cuda(args[0], args[1].cpu(), *args[2:], 4)
    with pytest.raises(ValueError, match='shapes'):
        dcn_blend.blend_matmul_cuda(*args[:3], args[3][:-1], 4)


@pytest.mark.parametrize('geo', [
    dict(n=5, cin=64, cout=64, h=45, w=80, dg=8, far=0.05),   # EDVR-M L3
    dict(n=2, cin=32, cout=16, h=17, w=30, dg=2, far=0.3),    # c_per 16
    dict(n=2, cin=16, cout=16, h=9, w=10, dg=2, k=1, padding=0),  # 1x1
])
def test_packed_route_matches_direct_route(cuda, monkeypatch, geo):
    """EDVR_TPU_DCN_PALLAS=1 on CUDA tensors: the forward and the x,
    offset, mask, weight and bias gradients through the gather and blend
    kernels (one of each per deformable group, no dcn_fwd/dcn_bwd) against
    the direct route's dcn_fwd/dcn_bwd kernels."""
    args, kw = _case(9, **geo)
    results = {}
    for route in ('direct', 'packed'):
        if route == 'packed':
            monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
        leaves = [a.clone().requires_grad_() for a in args]
        before = dict(dcn.LAUNCHES)
        out = dcn.modulated_deform_conv(*leaves, **kw)
        (out * out.cos()).sum().backward()
        torch.cuda.synchronize()
        results[route] = (out.detach(), [a.grad for a in leaves],
                          {k: dcn.LAUNCHES[k] - before[k] for k in before})
    dg = geo['dg']
    assert results['direct'][2] == _launches(dcn_fwd=1, dcn_bwd=1)
    assert results['packed'][2] == _launches(row_gather=dg, blend_matmul=dg)
    torch.testing.assert_close(results['packed'][0], results['direct'][0],
                               atol=1e-4, rtol=0)
    for name, g, w in zip(('dx', 'd_offset', 'd_mask', 'd_weight', 'd_bias'),
                          results['packed'][1], results['direct'][1]):
        assert _rel_err(g, w) <= BWD_TOL, (name, _rel_err(g, w))


def test_packed_edvr_step_cuda_matches_cpu(cuda, monkeypatch):
    """One EDVR training step through the packed route on the card (8
    gathers and 8 blends forward, no dcn_fwd/dcn_bwd) against the same
    step on the CPU's packed route."""
    monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
    torch.manual_seed(0)
    net = define_network(dict(type='EDVR', num_feat=16, deformable_groups=2,
                              num_extract_block=1,
                              num_reconstruct_block=1))
    with torch.no_grad():  # non-zero offsets, so the DCN samples move
        for mod in net.modules():
            if hasattr(mod, 'conv_offset'):
                mod.conv_offset.weight.normal_(0, 0.05)
    gen = torch.Generator().manual_seed(1)
    lq = torch.rand(2, 5, 3, 16, 16, generator=gen)
    grads = {}
    for dev in ('cpu', 'cuda'):
        net.to(dev).zero_grad()
        before = dict(dcn.LAUNCHES)
        net(lq.to(dev)).square().sum().backward()
        # a copy: moving the net moves its gradients' storage too
        grads[dev] = {n: p.grad.detach().clone().cpu()
                      for n, p in net.named_parameters()}
        counts = {k: dcn.LAUNCHES[k] - before[k] for k in before}
    assert counts == _launches(row_gather=8, blend_matmul=8)
    for name, g in grads['cpu'].items():
        assert _rel_err(grads['cuda'][name], g) <= 1e-3, name


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_packed_route_makes_no_host_sync(cuda, monkeypatch, dtype):
    """The packed route's forward and backward (8 gathers and 8 blends at
    dg 8) run under torch.cuda.set_sync_debug_mode('error'), which raises
    on any host synchronisation: the gather no longer reads a flag back."""
    monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
    from edvr_tpu_torch.ops import dcn_blend
    args, kw = _case(4, n=4, cin=64, cout=64, h=24, w=40, dg=8, far=0.05)
    leaves = [a.to(dtype).requires_grad_() for a in args]
    dout = torch.randn(4, 64, 24, 40, device=cuda, dtype=dtype)
    torch.cuda.synchronize()
    before = dict(dcn.LAUNCHES)
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = dcn.modulated_deform_conv(*leaves, **kw)
        out.backward(dout)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert {k: dcn.LAUNCHES[k] - before[k] for k in before} == _launches(
        **{'row_gather': 8, dcn_blend.ENTRIES[dtype]: 8})
    assert all(torch.isfinite(a.grad.float()).all() for a in leaves)


def _pcd_concatenated(pcd, nbr, ref):
    """PCDAlignment's forward with each concatenated input built by
    torch.cat and passed to its convolution whole, the form before the
    split (BasicSR's)."""
    from edvr_tpu_torch.archs.arch_util import lrelu
    from edvr_tpu_torch.archs.edvr_arch import _up2
    up_off = up_feat = feat = None
    for i in range(3, 0, -1):
        lv = f'l{i}'
        off = lrelu(pcd.offset_conv1[lv](torch.cat([nbr[i - 1], ref[i - 1]],
                                                   1)))
        if i == 3:
            off = lrelu(pcd.offset_conv2[lv](off))
        else:
            off = lrelu(pcd.offset_conv2[lv](torch.cat([off, up_off], 1)))
            off = lrelu(pcd.offset_conv3[lv](off))
        feat = pcd.dcn_pack[lv](nbr[i - 1], off)
        if i < 3:
            feat = pcd.feat_conv[lv](torch.cat([feat, up_feat], 1))
        if i > 1:
            feat = lrelu(feat)
            up_off, up_feat = _up2(off) * 2, _up2(feat)
    off = lrelu(pcd.cas_offset_conv2(lrelu(pcd.cas_offset_conv1(
        torch.cat([feat, ref[0]], 1)))))
    return lrelu(pcd.cas_dcnpack(feat, off))


def test_edvr_l_split_pcd_matches_concatenated(cuda):
    """EDVR-L's PCD (128 features, dg 8) on the card, its concatenated-
    input convolutions split (the port's form), against the same module
    with each concatenation passed whole, at 3e-4."""
    from edvr_tpu_torch.archs.edvr_arch import PCDAlignment
    torch.manual_seed(0)
    pcd = PCDAlignment(num_feat=128, deformable_groups=8).to(cuda).eval()
    with torch.no_grad():
        for name, p in pcd.named_parameters():
            if 'conv_offset' in name:
                p.normal_(0, 0.01)
    gen = torch.Generator().manual_seed(1)
    nbr, ref = ([torch.rand(5, 128, 48 // s, 64 // s, generator=gen).to(cuda)
                 for s in (1, 2, 4)] for _ in range(2))
    with torch.no_grad():
        got = pcd(nbr, ref)
        want = _pcd_concatenated(pcd, nbr, ref)
    assert (got - want).abs().max().item() <= 3e-4


def test_test_cli_on_card_matches_cpu(cuda, tmp_path):
    """``python -m edvr_tpu_torch.test`` on the card in a fresh process
    leaves TF32 off, so the EDVR-M it restores with (the golden weights)
    gives the CPU path's output within 3e-4."""
    import subprocess
    pytest.importorskip('cv2')
    pytest.importorskip('yaml')
    from test_torch_cli import _make_clips, _write_opt
    data = np.load(GOLDEN)
    state = {k: torch.from_numpy(data[k]) for k in data.files
             if not k.startswith('__')}
    config = json.loads(bytes(data['__config__']).decode())
    ckpt = str(tmp_path / 'golden.pth')
    torch.save({'params': state}, ckpt)
    root = str(tmp_path / 'clips')
    _make_clips(root, clips=('000',), frames=5, lq_hw=32)
    yml = _write_opt(tmp_path, root, 'card_cli', save_img=False)
    import yaml
    with open(yml) as f:
        opt = yaml.safe_load(f)
    opt['network_g'] = dict(type='EDVR', **{k: v for k, v in config.items()
                                            if k != 'type'})
    opt['path']['pretrain_network_g'] = ckpt
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f)
    lq = torch.rand(1, 5, 3, 32, 32, generator=torch.Generator()
                    .manual_seed(2))
    np.save(tmp_path / 'lq.npy', lq.numpy())
    code = (
        'import sys, numpy as np, torch\n'
        'from edvr_tpu_torch.test import main\n'
        'model = main(["-opt", sys.argv[1]])\n'
        'assert model.device.type == "cuda", model.device\n'
        'lq = torch.from_numpy(np.load(sys.argv[2])).cuda()\n'
        'with torch.no_grad():\n'
        '    np.save(sys.argv[3], model.net_g(lq).cpu().numpy())\n'
        'print(torch.backends.cuda.matmul.allow_tf32, '
        'torch.backends.cudnn.allow_tf32)\n')
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.environ.get('PYTHONPATH', '')]))
    proc = subprocess.run([sys.executable, '-c', code, yml,
                           str(tmp_path / 'lq.npy'),
                           str(tmp_path / 'out.npy')], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-2:] == ['False', 'False']
    net = define_network(config)
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        want = net.eval()(lq).numpy()
    np.testing.assert_allclose(np.load(tmp_path / 'out.npy'), want,
                               atol=3e-4, rtol=0)


def _seeded_edvr(config, seed=0, offset_std=0.02):
    """An EDVR from a torch seed whose offset convs are drawn non-zero, so
    its DCNs sample off the grid."""
    torch.manual_seed(seed)
    net = define_network(dict(type='EDVR', **config)).eval()
    with torch.no_grad():
        for mod in net.modules():
            if hasattr(mod, 'conv_offset'):
                mod.conv_offset.weight.normal_(0, offset_std)
    return net


EDVR_L = dict(num_feat=128, num_frame=5, deformable_groups=8,
              num_extract_block=5, num_reconstruct_block=40)


def test_edvr_l_window_on_card_matches_cpu(cuda):
    """A full-width EDVR-L window (128 features, dg 8: c_per 16, cout 128
    in every DCN) on the card against the plain CPU path."""
    net = _seeded_edvr(EDVR_L)
    lq = torch.rand(1, 5, 3, 32, 48, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        want = net(lq)
        before = dcn.LAUNCHES['dcn_fwd']
        got = net.to(cuda)(lq.to(cuda)).cpu()
    assert dcn.LAUNCHES['dcn_fwd'] == before + 4
    torch.testing.assert_close(got, want, atol=3e-4, rtol=0)


@pytest.mark.parametrize('config', [
    dict(num_feat=32, deformable_groups=4, num_extract_block=2,
         num_reconstruct_block=2),
    dict(num_feat=32, deformable_groups=4, num_extract_block=2,
         num_reconstruct_block=2, with_predeblur=True, hr_in=True)])
def test_pyramid_matches_window_on_card(cuda, config):
    """Pyramid clip mode against window mode on the card (1e-5), both
    against the CPU's window mode (3e-4), at a window batch that does not
    divide T."""
    net = _seeded_edvr(config)
    hw = 64 if config.get('hr_in') else 24
    clip = torch.rand(7, 3, hw, hw, generator=torch.Generator()
                      .manual_seed(2))
    idx = clip_window_indices(7, 5)
    want = make_clip_restore_fn(net)(clip, idx)
    net = net.to(cuda)
    window = make_clip_restore_fn(net, win_batch=3)(clip.to(cuda), idx)
    pyramid = make_clip_restore_fn(net, win_batch=3, mode='pyramid')(
        clip.to(cuda), idx)
    torch.testing.assert_close(pyramid, window, atol=1e-5, rtol=0)
    torch.testing.assert_close(pyramid.cpu(), want, atol=3e-4, rtol=0)


def test_deblur_yaml_cli_on_card_matches_cpu(cuda, tmp_path):
    """``options/test/EDVR/test_EDVR_L_deblur_REDS.yml`` (EDVR-L, HR input,
    pre-deblur) through ``python -m edvr_tpu_torch.test`` on the card, from
    a seeded checkpoint, against ``--device cpu``: the PSNR tables agree
    and the card model's output on a window is the CPU path's within
    3e-4."""
    import subprocess
    pytest.importorskip('cv2')
    yaml = pytest.importorskip('yaml')
    from test_torch_cli import _make_clips
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    yml = osp.join(repo, 'options', 'test', 'EDVR',
                   'test_EDVR_L_deblur_REDS.yml')
    with open(yml) as f:
        config = yaml.safe_load(f)['network_g']
    net = _seeded_edvr({k: v for k, v in config.items() if k != 'type'})
    ckpt = str(tmp_path / 'net_g.pth')
    torch.save({'params': net.state_dict()}, ckpt)
    root = str(tmp_path / 'clips')
    _make_clips(root, clips=('000',), frames=5, lq_hw=64, scale=1)
    meta = str(tmp_path / 'meta.txt')
    with open(meta, 'w') as f:
        f.write('000 5 (64,64,3)\n')
    lq = torch.rand(1, 5, 3, 64, 64, generator=torch.Generator()
                    .manual_seed(3))
    np.save(tmp_path / 'lq.npy', lq.numpy())
    code = (
        'import sys, numpy as np, torch\n'
        'from edvr_tpu_torch.test import main\n'
        'model = main(["-opt", sys.argv[1], "--device", sys.argv[2], '
        '"--force_yml", *sys.argv[5:]])\n'
        'lq = torch.from_numpy(np.load(sys.argv[3])).to(model.device)\n'
        'with torch.no_grad():\n'
        '    np.save(sys.argv[4], model.net_g(lq).cpu().numpy())\n'
        'np.save(sys.argv[4] + ".psnr.npy", model.metric_results["000"])\n'
        'print(model.device)\n')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.environ.get('PYTHONPATH', '')]))
    outs = {}
    for device in ('cuda', 'cpu'):
        out = str(tmp_path / f'out_{device}.npy')
        proc = subprocess.run(
            [sys.executable, '-c', code, yml, device,
             str(tmp_path / 'lq.npy'), out,
             f'datasets:test_1:dataroot_gt={root}/gt',
             f'datasets:test_1:dataroot_lq={root}/lq',
             f'datasets:test_1:meta_info_file={meta}',
             f'path:pretrain_network_g={ckpt}', 'val:save_img=false'],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.split()[-1].startswith(device)
        outs[device] = (np.load(out), np.load(out + '.psnr.npy'))
    assert outs['cuda'][0].shape == (1, 3, 64, 64)
    np.testing.assert_allclose(outs['cuda'][0], outs['cpu'][0], atol=3e-4,
                               rtol=0)
    # uint8 rounding of outputs 3e-4 apart moves a PSNR by far less
    np.testing.assert_allclose(outs['cuda'][1], outs['cpu'][1], atol=0.05)


# bf16 kernel vs the bf16 plain version, relative to each result's
# largest entry. Forward: the same rounding points (coefficient and
# per-corner product in bf16), the float32 contraction summed in another
# order, which moves the bf16 output rounding by at most one ulp (2^-8).
# Backward: the kernel sums in float32 where autograd through the plain
# version rounds each op's gradient to bf16 (its dx scatter adds in bf16),
# the bound tests/test_mixed_precision.py holds the bf16 band path to.
BF16_FWD_TOL = 1e-2
BF16_BWD_TOL = 4e-2
BF16_GEOS = [
    dict(n=5, cin=64, cout=64, h=45, w=80, dg=8, far=0.05),   # EDVR-M L3
    dict(n=2, cin=64, cout=64, h=33, w=47, dg=8, far=0.5),    # c_per 8
    dict(n=1, cin=32, cout=130, h=12, w=300, dg=2, far=0.1),  # c_per 16
    dict(n=2, cin=16, cout=24, h=20, w=28, dg=4),             # c_per 4
    dict(n=1, cin=6, cout=70, h=13, w=17, dg=3),              # c_per 2
    dict(n=1, cin=4, cout=8, h=11, w=9, dg=4, bias=False),    # c_per 1
    dict(n=2, cin=32, cout=16, h=17, w=21, dg=1, stride=2),   # c_per 32
    dict(n=2, cin=16, cout=16, h=9, w=10, dg=2, k=1, padding=0),  # 1x1
    *FUSED_BWD_GEOS,
]


def _bf16_case(seed, **geo):
    args, kw = _case(seed, **geo)
    return [a if a is None else a.bfloat16() for a in args], kw


@pytest.mark.parametrize('geo', BF16_GEOS)
def test_bf16_kernel_matches_plain(cuda, geo):
    args, kw = _bf16_case(10, **geo)
    before = dict(dcn.LAUNCHES)
    with torch.no_grad():
        got = dcn.dcn_fwd_cuda(*args, **kw)
        want = dcn.modulated_deform_conv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert {k: dcn.LAUNCHES[k] - before[k] for k in before} == _launches(
        dcn_fwd_bf16=1)
    assert got.dtype == want.dtype == torch.bfloat16
    assert _rel_err(got, want) <= BF16_FWD_TOL, _rel_err(got, want)


@pytest.mark.parametrize('geo', BF16_GEOS)
def test_bf16_bwd_kernel_matches_plain(cuda, geo):
    args, kw = _bf16_case(11, **geo)
    with torch.no_grad():
        out = dcn.modulated_deform_conv_plain(*args, **kw)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        12)).to(cuda, torch.bfloat16)
    before = dict(dcn.LAUNCHES)
    got = dcn.dcn_bwd_cuda(dout, *args[:4], **kw)
    want = _plain_grads(args, kw, dout)
    torch.cuda.synchronize()
    assert {k: dcn.LAUNCHES[k] - before[k] for k in before} == _launches(
        dcn_bwd_bf16=1)
    for name, g, w in zip(('dx', 'd_offset', 'd_mask', 'd_weight'), got,
                          want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16, name
        assert torch.isfinite(g.float()).all(), name
        assert _rel_err(g, w) <= BF16_BWD_TOL, (name, _rel_err(g, w))


def test_bf16_autograd_function_on_cuda(cuda):
    """modulated_deform_conv on bf16 CUDA tensors runs the bf16 kernels
    forward and backward (no fp32 launch, no cast) and every gradient is
    bf16."""
    args, kw = _bf16_case(13, n=2, cin=32, cout=32, h=14, w=18, dg=4,
                          far=0.05)
    leaves = [a.clone().requires_grad_() for a in args]
    before = dict(dcn.LAUNCHES)
    out = dcn.modulated_deform_conv(*leaves, **kw)
    (out.float() * out.float().cos()).sum().backward()
    assert {k: dcn.LAUNCHES[k] - before[k] for k in before} == _launches(
        dcn_fwd_bf16=1, dcn_bwd_bf16=1)
    ref = [a.clone().requires_grad_() for a in args]
    out_p = dcn.modulated_deform_conv_plain(*ref, **kw)
    (out_p.float() * out_p.float().cos()).sum().backward()
    assert out.dtype == torch.bfloat16
    for a, b in zip(leaves, ref):
        assert a.grad.dtype == torch.bfloat16
        assert _rel_err(a.grad, b.grad) <= BF16_BWD_TOL


def test_bf16_refusals(cuda, monkeypatch):
    """Mixed dtypes and other dtypes raise; the packed route takes bf16
    (one gather and one bf16 blend per group, no DCN kernel)."""
    args, kw = _bf16_case(14, n=1, cin=16, cout=16, h=8, w=8, dg=2)
    x, off, mask, weight, bias = args
    with pytest.raises(TypeError, match='one dtype'):
        dcn.dcn_fwd_cuda(x, off, mask, weight.float(), bias, **kw)
    with pytest.raises(TypeError, match='one dtype'):
        dcn.dcn_fwd_cuda(x, off.float(), mask, weight, bias, **kw)
    with pytest.raises(TypeError, match='one dtype'):
        dcn.dcn_bwd_cuda(torch.zeros(1, 16, 8, 8, device=cuda), x, off,
                         mask, weight, **kw)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        dcn.dcn_fwd_cuda(x.half(), off.half(), mask.half(), weight.half(),
                         bias.half(), **kw)
    with pytest.raises(TypeError):
        dcn.modulated_deform_conv(x, off, mask, weight.float(), bias, **kw)
    monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
    before = dict(dcn.LAUNCHES)
    out = dcn.modulated_deform_conv(x, off, mask, weight, bias, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert {k: dcn.LAUNCHES[k] - before[k] for k in before} == _launches(
        row_gather=2, blend_matmul_bf16=2)


ABLATE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('mode', ['full', 'no_coef', 'int_coef', 'no_gather',
                                  'coords_only', 'io_only'])
def test_ablate_kernel_matches_plain(cuda, mode, dtype):
    """Each ablation variant of dcn_fwd.cu against its plain version, at a
    ragged shape with far offsets (float32: the same products in another
    order, 1e-5 of max|out|; bf16: one output ulp, 1e-2)."""
    from edvr_tpu_torch.ops import dcn_ablate
    args, kw = _case(15, n=2, cin=64, cout=40, h=21, w=37, dg=8, far=0.05)
    args = [a.to(dtype) for a in args]
    key = (f'dcn_fwd_ablate_{mode}_'
           f"{'f32' if dtype == torch.float32 else 'bf16'}")
    before = dcn.LAUNCHES[key]
    with torch.no_grad():
        got = dcn_ablate.ablate_cuda(mode, *args, **kw)
        want = dcn_ablate.ablate_plain(mode, *args, **kw)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES[key] == before + 1
    assert got.dtype == want.dtype == dtype
    assert _rel_err(got, want) <= ABLATE_TOL[dtype], _rel_err(got, want)


# the first bf16 step's gradient against the float32 gradient of the same
# loss: |g - g32| / |g32| in L2 norms over all parameters (MP_GRAD_TOL),
# and the cosine of g and g32 for each parameter tensor (MP_LEAF_COS_MIN);
# tests/test_torch_bf16.py holds the port's CPU path to them too. Sound
# readings (check_mp_grads prints them): tests/test_torch_bf16.py's small
# seeded EDVR 4.1e-3 and 4.9e-3, cosines >= 0.99; the random-init EDVR of
# mp_runs 2.4e-2, least cosine 0.87 (a bias holding 4e-5 of the gradient;
# most of it is conv_last.bias, the mean residual, which the bf16 output
# resolves to 2^-9). Wrong gradients read: 1.5 x the gradient 0.5; negated
# 2 and cosine -1; a tensor's dropped cosine 0; the JAX engine's bf16
# gradient on the CPU, where XLA sums the bias gradients in bf16, 0.11-0.13
MP_GRAD_TOL = 5e-2
MP_LEAF_COS_MIN = 0.5


def grad_gaps(got, want):
    """|got - want| / |want| (L2 norms) over every parameter tensor
    together, and the cosine of got and want for each one (0 where got is
    0)."""
    num = den = 0.0
    cosines = {}
    for n, w in want.items():
        g, w = got[n].double().ravel(), w.double().ravel()
        assert w.norm() > 0, n
        num += (g - w).square().sum().item()
        den += w.square().sum().item()
        cosines[n] = (g @ w / (g.norm() * w.norm()).clamp_min(1e-300)
                      ).item()
    return (num / den) ** 0.5, cosines


def check_mp_grads(got, want):
    """The bf16 step's gradient ``got`` against the float32 ``want``, and
    that the bounds see a scaled, negated or dropped gradient."""
    total, cosines = grad_gaps(got, want)
    worst = min(cosines, key=cosines.get)
    print(f'mp gradient gap {total}, least cosine {worst} {cosines[worst]}')
    assert total <= MP_GRAD_TOL, total
    assert cosines[worst] >= MP_LEAF_COS_MIN, (worst, cosines[worst])
    assert grad_gaps({n: 1.5 * g for n, g in got.items()},
                     want)[0] > MP_GRAD_TOL
    assert grad_gaps({n: -g for n, g in got.items()}, want)[0] > MP_GRAD_TOL
    dropped = dict(got, **{worst: torch.zeros_like(got[worst])})
    assert grad_gaps(dropped, want)[1][worst] < MP_LEAF_COS_MIN


def mp_runs(device, tmp_path):
    """Two steps of a small random-init EDVR (its conv_offset weights drawn,
    so the samples move) on one batch, in float32 and under
    ``mixed_precision: bf16``, from the same parameters, on ``device``.
    Returns {None | 'bf16': (model, losses, the last step's launches, the
    first step's gradients)}."""
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.utils.options import parse_dict
    net = dict(type='EDVR', num_in_ch=3, num_out_ch=3, num_feat=16,
               num_frame=5, deformable_groups=2, num_extract_block=1,
               num_reconstruct_block=1, center_frame_idx=None, hr_in=False,
               with_predeblur=False, with_tsa=True)
    gen = torch.Generator().manual_seed(16)
    batch = {'lq': torch.rand(2, 5, 3, 16, 16, generator=gen),
             'gt': torch.rand(2, 3, 64, 64, generator=gen)}
    runs = {}
    for mp in (None, 'bf16'):
        opt = parse_dict(dict(
            name=f'mp_{mp}', model_type='EDVRModel', scale=4, num_gpu=1,
            manual_seed=0, network_g=net,
            path=dict(pretrain_network_g=None, strict_load_g=True),
            train=dict(optim_g=dict(type='Adam', lr=4e-4, betas=[0.9, 0.99]),
                       scheduler=dict(type='CosineAnnealingRestartLR',
                                      periods=[4], restart_weights=[1],
                                      eta_min=1e-7),
                       total_iter=4, warmup_iter=-1, mixed_precision=mp,
                       pixel_opt=dict(type='CharbonnierLoss',
                                      loss_weight=1.0, reduction='mean'))),
            is_train=True, root=str(tmp_path))
        opt['device'] = device
        model = create_model(opt)
        with torch.no_grad():  # moving samples: non-zero offsets
            for n, p in model.net_g.named_parameters():
                if 'conv_offset.weight' in n:
                    p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                        .manual_seed(17)) * 0.05)
        losses = []
        for it in (1, 2):
            before = dict(dcn.LAUNCHES)
            model.feed_data(batch)
            model.optimize_parameters(it)
            if device == 'cuda':
                torch.cuda.synchronize()
            counts = {k: dcn.LAUNCHES[k] - before[k] for k in before}
            losses.append(model.get_current_log()['l_pix'])
            if it == 1:
                grads = {n: p.grad.clone()
                         for n, p in model.net_g.named_parameters()}
        runs[mp] = (model, losses, counts, grads)
    return runs


def test_mp_train_steps_on_card(cuda, tmp_path):
    """Two mixed-precision EDVR steps on the card: 4 bf16 forward and 4 bf16
    backward DCN launches a step and no fp32 one, f32 master parameters,
    the first step's gradients within MP_GRAD_TOL (all parameters) and
    MP_LEAF_COS_MIN (each tensor) of the card's fp32 step's, and the loss
    and parameters within the bounds of tests/test_mixed_precision.py
    (loss per element 5e-3, parameters 4 x lr), which an Adam step's
    normalization keeps from seeing the gradient."""
    runs = mp_runs('cuda', tmp_path)
    model, losses, counts, grads = runs['bf16']
    assert counts == _launches(dcn_fwd_bf16=4, dcn_bwd_bf16=4)
    assert runs[None][2] == _launches(dcn_fwd=4, dcn_bwd=4)
    check_mp_grads(grads, runs[None][3])
    for a, b in zip(losses, runs[None][1]):
        assert np.isfinite(a) and abs(a - b) <= 5e-3
    want = dict(runs[None][0].net_g.named_parameters())
    for n, p in model.net_g.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert model.optimizer_g.state[p]['exp_avg'].dtype == torch.float32
        assert (p - want[n]).abs().max().item() <= 4 * 4e-4, n


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bwd_weight_gradient_is_deterministic(cuda, dtype):
    """dW (each block's partial, then the wrapper's sum over partials), and
    d_offset and d_mask, are bitwise the same in two runs; only dx is
    summed by atomics."""
    args, kw = _case(40, n=8, cin=64, cout=64, h=32, w=32, dg=8, far=0.05)
    args = [a.to(dtype) for a in args]
    dout = torch.randn(8, 64, 32, 32, generator=torch.Generator()
                       .manual_seed(41)).to(cuda, dtype)
    first = dcn.dcn_bwd_cuda(dout, *args[:4], **kw)
    second = dcn.dcn_bwd_cuda(dout, *args[:4], **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(('d_offset', 'd_mask', 'd_weight'), first[1:],
                          second[1:]):
        assert torch.equal(a, b), name
