"""The port's packed DCN route in bfloat16, and the offset quantization
knob, against the JAX package on the CPU.

``EDVR_TPU_DCN_PALLAS=1`` sends both packages' DCN through the packed
route; with bf16 inputs JAX's ``etype`` is bf16 and its blend kernel,
``dcn_pallas.blend_matmul_group``, runs in Pallas interpret mode
(``EDVR_TPU_DCN_PALLAS_INTERPRET=1``); every test that compares with it
asserts that the kernel traced. The port runs the plain versions of its
two kernels (``ops/gather.py``, ``ops/dcn_blend.py``); the kernels are held
against those on the card (tests/test_torch_cuda.py, chip_smoke.py).
Inputs are drawn with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edvr_tpu.ops import dcn as jdcn
from edvr_tpu.ops import dcn_pallas
from edvr_tpu_torch.ops import dcn, dcn_blend
from test_torch_packed import _dcn_case, _nchw, _oihw
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the bf16 blend, plain version against the interpreted kernel: the same
# bf16 products, exact in float32, summed in another order
BLEND_TOL = 1e-4
# the bf16 packed DCN against JAX's, as tests/test_torch_bf16.py holds the
# bf16 DCN: the output to 1e-2 of max|out| (the same rounding points,
# float32 sums in another order move a bf16 output by an ulp), each
# gradient to 4e-2 of its largest entry
FWD_TOL = 1e-2
GRAD_TOL = 4e-2
QUANT_TOL = 1e-4  # float32 both sides, as tests/test_torch_dcn.py


@pytest.fixture
def packed(monkeypatch):
    """Both packages on the packed route, JAX's blend kernel interpreted
    and not yet traced."""
    monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
    monkeypatch.setenv('EDVR_TPU_DCN_PALLAS_INTERPRET', '1')
    dcn_pallas.blend_matmul_group.clear_cache()


def _bf16_blend_case(seed, NP, K, lanes, c_per, cout):
    """bf16 g_cat, cs_cat (coefficients in [0, 1]) and wexp_g, float32
    out_prev, as float32 numpy arrays holding bf16 values."""
    rng = np.random.RandomState(seed)
    slots = lanes // c_per
    g, cs, w = (rng.randn(NP, K * lanes), rng.rand(NP, K * slots),
                rng.randn(K * lanes, cout) * 0.1)
    to_bf16 = lambda a: np.array(jnp.asarray(a, jnp.float32).astype(
        jnp.bfloat16).astype(jnp.float32))
    return [to_bf16(g), to_bf16(cs), to_bf16(w),
            rng.randn(NP, cout).astype(np.float32)]


def _jax_blend_args(arrays):
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:3]] + [
        jnp.asarray(arrays[3])]


def _torch_blend_args(arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3]] + [
        torch.from_numpy(arrays[3])]


BLEND_CASES = [dict(NP=70, K=9, lanes=128, c_per=8, cout=16),   # EDVR-M
               dict(NP=70, K=9, lanes=128, c_per=16, cout=24),  # EDVR-L
               dict(NP=45, K=3, lanes=32, c_per=1, cout=8)]


@pytest.mark.parametrize('case', BLEND_CASES)
def test_bf16_blend_plain_matches_jax_kernel(packed, case):
    """blend_matmul_group_plain on bf16 operands against the Pallas kernel
    (interpret mode, blocks of 32 rows: a ragged last block): float32
    out, within 1e-4 of max|out|; a bf16 @ bf16 contraction, whose result
    PyTorch rounds to bf16, misses that."""
    arrays = _bf16_blend_case(0, **case)
    before = dcn_pallas.TRACE_COUNTS['blend']
    want = np.asarray(dcn_pallas.blend_matmul_group(
        *_jax_blend_args(arrays), c_per=case['c_per'], block_rows=32))
    assert dcn_pallas.TRACE_COUNTS['blend'] > before
    args = _torch_blend_args(arrays)
    got = dcn_blend.blend_matmul_group_plain(*args, case['c_per'])
    assert got.dtype == torch.float32 and want.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=BLEND_TOL * scale,
                               rtol=0)
    g, cs, w, prev = args
    rounded = prev + ((g * cs.repeat_interleave(case['c_per'], 1)) @ w
                      ).float()
    assert np.abs(rounded.numpy() - want).max() > BLEND_TOL * scale


@pytest.mark.parametrize('case', BLEND_CASES[:2])
def test_bf16_blend_function_vjp_matches_jax(packed, case):
    """BlendMatmulGroupFunction on bf16 operands: its forward and four
    cotangents (d_g, d_cs, d_w in bf16, the float32 out_prev's) against
    jax.vjp of blend_matmul_group_ad."""
    arrays = _bf16_blend_case(1, **case)
    dout = np.random.RandomState(2).randn(
        case['NP'], case['cout']).astype(np.float32)
    c_per = case['c_per']
    out, vjp = jax.vjp(
        lambda *a: dcn_pallas.blend_matmul_group_ad(*a, c_per),
        *_jax_blend_args(arrays))
    want = vjp(jnp.asarray(dout))

    leaves = [t.requires_grad_() for t in _torch_blend_args(arrays)]
    got = dcn_blend.blend_matmul_group(*leaves, c_per)
    got.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=BLEND_TOL * np.abs(out).max(), rtol=0)
    for name, leaf, w in zip(('g_cat', 'cs_cat', 'wexp_g', 'out_prev'),
                             leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        w = np.asarray(w.astype(jnp.float32))
        # bf16 cotangents: one rounding of a float32 value each, which the
        # two sum orders may put on either side (one bf16 ulp, 2^-8)
        tol = BLEND_TOL if leaf.dtype == torch.float32 else 2 ** -8
        np.testing.assert_allclose(leaf.grad.float().numpy(), w,
                                   atol=tol * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_blend_refuses_mixed_dtypes():
    """The blend takes g_cat, cs_cat and wexp_g in one dtype and a float32
    out_prev, on either device; it never casts."""
    args = _torch_blend_args(_bf16_blend_case(3, 8, 1, 16, 8, 4))
    for i in range(3):
        mixed = list(args)
        mixed[i] = mixed[i].float()
        with pytest.raises(TypeError, match='one dtype|float32 or bf'):
            dcn_blend.blend_matmul_group(*mixed, 8)
    with pytest.raises(TypeError, match='out_prev'):
        dcn_blend.blend_matmul_group(*args[:3], args[3].bfloat16(), 8)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        dcn_blend.blend_matmul_group(*[a.double() for a in args], 8)


def _bf16_dcn_case(seed, **geo):
    """_dcn_case rounded to bf16 values (float32 numpy)."""
    return [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32)) for a in _dcn_case(seed, **geo)]


@pytest.mark.parametrize('geo', [
    # EDVR-L's c_per 16 (one group: JAX traces a group's nine taps
    # unrolled, ~13 s a group); c_per 8 is held at the blend above
    dict(n=2, h=8, w=19, cin=16, cout=6, dg=1, far=0.3, outside=True),
])
def test_bf16_packed_route_matches_jax(packed, geo):
    """The port's packed route on bf16 inputs against JAX's (bf16 etype,
    the blend kernel interpreted): the bf16 output to 1e-2 of max|out|,
    the x, offset, mask and weight gradients to 4e-2 of each largest
    entry, with far offsets and taps wholly outside."""
    arrays = _bf16_dcn_case(4, **geo)
    dg = geo['dg']
    kw = dict(stride=1, padding=1, dilation=1, groups=1,
              deformable_groups=dg)

    def jloss(*a):
        out = jdcn.modulated_deform_conv(*a, **kw)
        o = out.astype(jnp.float32)
        return jnp.sum(o * jnp.cos(o)), out

    before = dcn_pallas.TRACE_COUNTS['blend']
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(*jargs)
    assert dcn_pallas.TRACE_COUNTS['blend'] > before, 'blend did not trace'
    assert jout.dtype == jnp.bfloat16

    bf16 = torch.bfloat16
    x, off, mask = (_nchw(a).to(bf16).requires_grad_() for a in arrays[:3])
    weight = _oihw(arrays[3]).to(bf16).requires_grad_()
    launches = dict(dcn.LAUNCHES)
    out = dcn.modulated_deform_conv(x, off, mask, weight,
                                    torch.from_numpy(arrays[4]).to(bf16),
                                    **kw)
    o = out.float()
    torch.sum(o * torch.cos(o)).backward()
    assert dcn.LAUNCHES == launches  # CPU: the plain versions, no kernel
    assert out.dtype == bf16
    jout = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(o.detach().permute(0, 2, 3, 1).numpy(), jout,
                               atol=FWD_TOL * np.abs(jout).max(), rtol=0)
    got = [t.grad.float().permute(0, 2, 3, 1).numpy() for t in (x, off,
                                                                mask)]
    got.append(weight.grad.float().permute(2, 3, 1, 0).numpy())
    for name, t, g, w in zip(('dx', 'd_offset', 'd_mask', 'd_weight'),
                             (x, off, mask, weight), got, jgrads):
        assert t.grad.dtype == bf16, name
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * np.abs(w).max(),
                                   rtol=0, err_msg=name)


def test_packed_route_fp32_unchanged_by_bf16_points():
    """The float32 packed route's output and gradients are those of its
    float32 formula: the bf16 rounding points are no-ops there (the plain
    DCN at 1e-5, as tests/test_torch_packed.py holds the route)."""
    arrays = _dcn_case(8, n=1, h=7, w=13, cin=16, cout=8, dg=2, far=0.2)
    args = [_nchw(a) for a in arrays[:3]] + [_oihw(arrays[3]),
                                              torch.from_numpy(arrays[4])]
    geo = (1, 1, 1, 1, 2)
    got = dcn._mdcn_packed(*args, *geo)
    want = dcn.modulated_deform_conv_plain(*args, *geo)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize('quant', ['int', 'half', 'quarter'])
def test_dcn_quant_matches_jax(monkeypatch, quant):
    """EDVR_TPU_DCN_QUANT rounds the offsets to a 1, 1/2 or 1/4 px grid
    before the DCN (half to even at ties, as jnp.round): the port's DCN
    against the JAX op under the same knob, and its offset gradient zero
    as JAX's."""
    monkeypatch.setenv('EDVR_TPU_DCN_QUANT', quant)
    x, off, mask, weight, bias = _dcn_case(9, n=1, h=6, w=9, cin=16,
                                           cout=8, dg=2, far=0.1)
    denom = dcn.DCN_QUANT[quant]
    # ties on the grid: k + 1/2 steps round to the even step
    off[0, :2, :3, :4] = (np.arange(12).reshape(2, 3, 2) + 0.5).repeat(
        2, -1) / denom - 3
    arrays = [x, off, mask, weight, bias]
    kw = dict(stride=1, padding=1, dilation=1, groups=1,
              deformable_groups=2)
    jout, jgrad = jax.value_and_grad(
        lambda o: jnp.sum(jdcn.modulated_deform_conv(
            jnp.asarray(x), o, *map(jnp.asarray, arrays[2:]), **kw)))(
        jnp.asarray(off))
    jout = np.asarray(jdcn.modulated_deform_conv(
        *map(jnp.asarray, arrays), **kw))
    toff = _nchw(off).requires_grad_()
    out = dcn.modulated_deform_conv(_nchw(x), toff, _nchw(mask),
                                    _oihw(weight), torch.from_numpy(bias),
                                    **kw)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               jout, atol=QUANT_TOL, rtol=0)
    assert not np.asarray(jgrad).any() and not toff.grad.any()
    # the knob changed the result: the unrounded DCN differs
    monkeypatch.delenv('EDVR_TPU_DCN_QUANT')
    free = dcn.modulated_deform_conv(_nchw(x), _nchw(off), _nchw(mask),
                                     _oihw(weight), torch.from_numpy(bias),
                                     **kw)
    assert (free - out.detach()).abs().max() > 10 * QUANT_TOL


def test_dcn_quant_refuses_unknown_value(monkeypatch):
    monkeypatch.setenv('EDVR_TPU_DCN_QUANT', 'eighth')
    x, off, mask, weight, _ = _dcn_case(10, n=1, h=4, w=4, cin=16, cout=4,
                                        dg=2)
    with pytest.raises(KeyError):
        dcn.modulated_deform_conv(_nchw(x), _nchw(off), _nchw(mask),
                                  _oihw(weight), None, 1, 1, 1, 1, 2)
