"""The split of EDVR's concatenated-input convolutions, on the CPU.

``edvr_tpu_torch.archs.edvr_arch.conv_cat(conv, a, b)`` computes
``conv(torch.cat([a, b], 1))``: in float32 as two convolutions over the
halves of ``conv``'s weight, the bias in the second, with no concatenation;
in bf16 (the bf16 step's ``torch.func.functional_call`` on bf16 copies of
float32 parameters) as the concatenated convolution itself. Each form is
held against the concatenated convolution, forward and every gradient (the
two inputs, the weight through its two slices, the bias), and a tiny EDVR
(PCD and TSA) built with it against the JAX module, weights carried over by
``jax_params_to_state_dict`` with its keys unchanged and loaded strictly:
in float32 at 3e-4 as tests/test_torch_edvr.py, in bf16 against the JAX
module's bf16 forward at tests/test_torch_bf16.py's forward tolerance.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.overrides import TorchFunctionMode

from edvr_tpu.archs import edvr_arch as jarch
from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.archs.edvr_arch import conv_cat
from edvr_tpu_torch.convert import jax_params_to_state_dict

ATOL = 3e-4  # as tests/test_torch_edvr.py
# fp32: the two halves' sums are added once more, in another order than
# the concatenated convolution's; about 1e-7 of values of order one
FP32_TOL = 1e-5
# bf16 against the JAX module's bf16 forward: a few bf16 roundings of the
# output's largest values (2^-8 each), as tests/test_torch_bf16.py FWD_TOL
BF16_OUT_TOL = 1e-2
TINY = dict(num_feat=8, num_frame=5, deformable_groups=2,
            num_extract_block=1, num_reconstruct_block=1)


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors, as
    tests/test_torch_edvr_l_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Pair(nn.Module):
    """One 2c -> cout convolution, applied split or concatenated."""

    def __init__(self, c, cout, stride, padding, dilation):
        super().__init__()
        self.conv = nn.Conv2d(2 * c, cout, 3, stride, padding, dilation)

    def forward(self, a, b, split=True):
        if split:
            return conv_cat(self.conv, a, b)
        return self.conv(torch.cat([a, b], dim=1))


def _run(pair, a, b, split, dtype):
    """Output and gradients (a, b, weight, bias) of (out * out.cos()).sum()
    through the split or concatenated form; in bf16 through
    functional_call on bf16 copies, the gradients reaching the float32
    parameters."""
    pair.zero_grad()
    leaves = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    if dtype == torch.float32:
        out = pair(*leaves, split=split)
    else:
        params = {n: p.to(dtype) for n, p in pair.named_parameters()}
        out = torch.func.functional_call(
            pair, params, (leaves[0].to(dtype), leaves[1].to(dtype)),
            {'split': split}).float()
    (out * out.cos()).sum().backward()
    return out.detach(), [leaves[0].grad, leaves[1].grad,
                          pair.conv.weight.grad.clone(),
                          pair.conv.bias.grad.clone()]


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize('c,cout,stride,padding,dilation,hw', [
    (8, 8, 1, 1, 1, (9, 11)),    # PCD's 2nf -> nf, 3x3
    (16, 8, 1, 1, 1, (6, 6)),
    (4, 6, 2, 1, 1, (9, 10)),    # strided, ragged
    (4, 4, 1, 2, 2, (8, 7)),     # dilated
])
def test_conv_cat_matches_concatenated_conv(c, cout, stride, padding,
                                            dilation, hw):
    torch.manual_seed(0)
    pair = _Pair(c, cout, stride, padding, dilation)
    rng = np.random.RandomState(c + cout + stride)
    a, b = (torch.from_numpy(rng.randn(2, c, *hw).astype(np.float32))
            for _ in range(2))
    out, grads = _run(pair, a, b, True, torch.float32)
    want, want_grads = _run(pair, a, b, False, torch.float32)
    torch.testing.assert_close(out, want, atol=FP32_TOL, rtol=FP32_TOL)
    for name, g, w in zip(('a', 'b', 'weight', 'bias'), grads, want_grads):
        torch.testing.assert_close(g, w, atol=FP32_TOL, rtol=FP32_TOL,
                                   msg=name)


def test_conv_cat_bf16_step_form():
    """Under the bf16 step's functional_call conv_cat is the concatenated
    convolution on the bf16 copies (one rounding of each output, as the
    JAX step's): its output and the float32 gradients equal the
    concatenated form's bitwise."""
    torch.manual_seed(1)
    pair = _Pair(16, 16, 1, 1, 1)
    rng = np.random.RandomState(2)
    a, b = (torch.from_numpy(rng.randn(2, 16, 12, 12).astype(np.float32))
            for _ in range(2))
    out, grads = _run(pair, a, b, True, torch.bfloat16)
    want, want_grads = _run(pair, a, b, False, torch.bfloat16)
    assert torch.equal(out, want)
    for name, g, w in zip(('a', 'b', 'weight', 'bias'), grads, want_grads):
        assert g.dtype == torch.float32, name
        assert torch.equal(g, w), name


class _ConvInputs(TorchFunctionMode):
    """The input channels of each F.conv2d call."""

    def __init__(self):
        super().__init__()
        self.channels = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.nn.functional.conv2d:
            self.channels.append(args[0].shape[1])
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope='module')
def tiny_edvr():
    """A tiny JAX EDVR with seeded parameters, the port's EDVR with them
    loaded strictly under the keys they always had, and one LQ batch
    (NHWC numpy)."""
    jnet = jarch.EDVR(**TINY)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 5, 16, 16, 3)))['params']
    rng = np.random.RandomState(0)

    def draw(path, s):
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        if 'conv_offset' in name:  # the DCN samples move
            return (rng.randn(*s.shape) * 0.05).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 16
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    lq = np.random.RandomState(1).rand(2, 5, 16, 16, 3).astype(np.float32)
    net = define_network(dict(type='EDVR', **TINY)).eval()
    state = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params))
    assert sorted(state) == sorted(net.state_dict())
    net.load_state_dict(state, strict=True)
    return jnet, params, net, lq


def _pcd_conv_inputs(net, dtype):
    """The input channels of each convolution of one PCD forward in
    ``dtype`` (through functional_call on copies of the parameters)."""
    pcd = net.pcd_align
    params = {n: p.detach().to(dtype) for n, p in pcd.named_parameters()}
    feats = [f.unsqueeze(1).repeat(1, 5, 1, 1, 1).flatten(0, 1).to(dtype)
             for f in (torch.rand(2, 8, 16, 16), torch.rand(2, 8, 8, 8),
                       torch.rand(2, 8, 4, 4))]
    counter = _ConvInputs()
    with torch.no_grad(), counter:
        torch.func.functional_call(pcd, params, (feats, feats))
    return counter.channels


def test_split_edvr_matches_jax(tiny_edvr):
    """A tiny EDVR (PCD and TSA) with the split convolutions: the JAX
    module's parameters load strictly under the keys they always had, the
    output matches the JAX module's at 3e-4, and no convolution of PCD
    takes a concatenated input: each of its 16 convolutions reads nf
    channels, the eight of a concatenated input as two halves each."""
    jnet, params, net, lq = tiny_edvr
    want = np.asarray(jax.jit(jnet.apply)({'params': params},
                                          jnp.asarray(lq)))
    x = torch.from_numpy(lq).permute(0, 1, 4, 2, 3)
    with torch.no_grad():
        got = net(x)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL, rtol=0)
    nf = TINY['num_feat']
    # L3: offset_conv1 (2), offset_conv2, conv_offset; L2 and L1:
    # offset_conv1 (2), offset_conv2 (2), offset_conv3, conv_offset,
    # feat_conv (2); cascade: cas_offset_conv1 (2), cas_offset_conv2,
    # conv_offset
    assert _pcd_conv_inputs(net, torch.float32) == [nf] * (4 + 2 * 8 + 4)


def test_bf16_edvr_concatenated_form_matches_jax(tiny_edvr):
    """The same EDVR in the bf16 step's form (functional_call on bf16
    copies of the parameters, a bf16 input) against the JAX module's
    forward on bf16 parameters and input, within BF16_OUT_TOL of max|out|;
    its PCD passes each concatenated input whole: the eight such
    convolutions read 2 nf channels."""
    jnet, params, net, lq = tiny_edvr
    to_bf16 = partial(jax.tree_util.tree_map, lambda p: p.astype(jnp.bfloat16))
    want = np.asarray(jax.jit(jnet.apply)(
        {'params': to_bf16(params)}, to_bf16(jnp.asarray(lq))).astype(
            jnp.float32))
    x = torch.from_numpy(lq).permute(0, 1, 4, 2, 3).bfloat16()
    bf16 = {n: p.detach().bfloat16() for n, p in net.named_parameters()}
    with torch.no_grad():
        got = torch.func.functional_call(net, bf16, (x,))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().permute(0, 2, 3, 1).numpy() - want).max()
    assert err <= BF16_OUT_TOL * np.abs(want).max(), err
    nf = TINY['num_feat']
    whole, c2 = [nf], [2 * nf]
    assert _pcd_conv_inputs(net, torch.bfloat16) == (
        c2 + whole * 2 + (c2 * 2 + whole * 2 + c2) * 2 + c2 + whole * 2)
