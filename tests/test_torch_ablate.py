"""The ablation variants of the DCNv2 forward kernel (``ops/dcn_ablate.py``,
the port of ``scripts/dev/ablate_band.py``), on the CPU.

Each variant's plain version is tied to the full plain version
(``modulated_deform_conv_plain``) by an identity on a chosen input, so a
variant that drifts from its stated function shows up:

* ``full`` is ``modulated_deform_conv_plain``;
* ``int_coef`` equals ``full`` when every offset is an integer;
* ``no_gather`` equals ``full`` on x == 1;
* ``no_coef`` equals ``full`` on the 2x2 clamped box sum of x, mask 1,
  when every sample coordinate is an in-image integer;
* ``coords_only`` equals ``full`` on the ramp 2 + y + x with weights
  1/c_per and mask 1, at in-image integer coordinates;
* ``io_only`` equals ``full`` on the ramp y + x with weights 1/c_per and
  mask 1, less the taps' base positions, at in-image coordinates (the
  bilinear sample of a linear ramp is exact).

The kernel against each plain version is a card test
(``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from edvr_tpu_torch.ops import dcn, dcn_ablate
from edvr_tpu_torch.tools import ablate_dcn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, CIN, COUT, H, W, DG = 2, 16, 8, 11, 19, 4
# the same products summed in another order: float32 to 1e-5 of the
# largest output; in bf16 that order moves the output's bf16 rounding by
# at most one ulp (2^-8 of a value), plus the bias add's rounding
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(seed, dtype, offset='uniform', bias=True):
    """x, offset, mask, weight, bias of the test shape (3x3 taps, padding
    1). ``offset``: 'uniform' U(-3, 3); 'integer' integers in [-4, 4];
    'in_image' integer offsets that put every sample on an in-image pixel;
    'in_image_frac' fractional ones that keep every sample's four corners
    in the image."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, CIN, H, W, generator=g)
    shape = (N, DG, 9, H, W)
    base_y = (torch.arange(H).view(1, 1, 1, H, 1) - 1
              + (torch.arange(9) // 3).view(1, 1, 9, 1, 1)).float()
    base_x = (torch.arange(W).view(1, 1, 1, 1, W) - 1
              + (torch.arange(9) % 3).view(1, 1, 9, 1, 1)).float()
    if offset == 'uniform':
        dy, dx = (torch.rand(shape, generator=g) * 6 - 3 for _ in range(2))
    elif offset == 'integer':
        dy, dx = (torch.randint(-4, 5, shape, generator=g).float()
                  for _ in range(2))
    elif offset == 'in_image':
        dy = torch.randint(0, H, shape, generator=g).float() - base_y
        dx = torch.randint(0, W, shape, generator=g).float() - base_x
    else:  # in_image_frac: 0 <= cy < h - 1, 0 <= cx < w - 1
        dy = torch.rand(shape, generator=g) * (H - 1) * 0.999 - base_y
        dx = torch.rand(shape, generator=g) * (W - 1) * 0.999 - base_x
    off = torch.stack([dy, dx], dim=3).reshape(N, DG * 18, H, W)
    mask = torch.rand(N, DG * 9, H, W, generator=g)
    weight = torch.randn(COUT, CIN, 3, 3, generator=g) * 0.2
    b = torch.randn(COUT, generator=g) if bias else None
    return [t if t is None else t.to(dtype) for t in (x, off, mask, weight, b)]


def _plain(mode, args):
    return dcn_ablate.ablate_plain(mode, *args, 1, 1, 1, DG)


def _full(args):
    return dcn.modulated_deform_conv_plain(*args, 1, 1, 1, 1, DG)


def _close(got, want, dtype):
    assert got.dtype == want.dtype == dtype
    got, want = got.double(), want.double()
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= TOL[dtype], err


def _ramp(dtype, const):
    y = torch.arange(H).view(H, 1).float()
    x = torch.arange(W).view(1, W).float()
    return (const + y + x).expand(N, CIN, H, W).contiguous().to(dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_full_is_the_plain_dcn(dtype):
    args = _inputs(0, dtype)
    assert torch.equal(_plain('full', args), _full(args))


@pytest.mark.parametrize('dtype', DTYPES)
def test_int_coef_is_full_at_integer_offsets(dtype):
    """Integer offsets, in and out of the image: the bilinear blend keeps
    its floor corner alone, with validity and mask."""
    args = _inputs(1, dtype, 'integer')
    _close(_plain('int_coef', args), _full(args), dtype)
    # and it is not full where the offsets are fractional
    frac = _inputs(1, dtype)
    assert not torch.allclose(_plain('int_coef', frac).float(),
                              _full(frac).float(), atol=0.1)


@pytest.mark.parametrize('dtype', DTYPES)
def test_no_gather_is_full_on_ones(dtype):
    args = _inputs(2, dtype)
    ones = [torch.ones_like(args[0])] + args[1:]
    _close(_plain('no_gather', args), _full(ones), dtype)


def _box2(x):
    """x[y, x] + x[y, x+1] + x[y+1, x] + x[y+1, x+1], indices clamped into
    the image, summed in that order."""
    n, c, h, w = x.shape
    ys = [torch.arange(h), torch.arange(1, h + 1).clamp(max=h - 1)]
    xs = [torch.arange(w), torch.arange(1, w + 1).clamp(max=w - 1)]
    out = torch.zeros_like(x)
    for yi in ys:
        for xi in xs:
            out = out + x[:, :, yi][:, :, :, xi]
    return out


def test_no_coef_is_full_on_the_box_sum():
    """At in-image integer coordinates full samples one pixel; no_coef sums
    the four clamped corners and ignores the mask."""
    args = _inputs(3, torch.float32, 'in_image')
    want = _full([_box2(args[0]), args[1], torch.ones_like(args[2]),
                  *args[3:]])
    _close(_plain('no_coef', args), want, torch.float32)


@pytest.mark.parametrize('dtype', DTYPES)
def test_coords_only_is_full_on_a_ramp(dtype):
    """At in-image integer coordinates with mask 1, wy0 + wy1 + wx0 + wx1 is
    2, so coords_only is the sum of 2 + y0 + x0: full's sample of the ramp
    2 + y + x, contracted with weights 1/c_per."""
    args = _inputs(4, dtype, 'in_image')
    ones = torch.ones_like(args[2])
    flat = torch.full_like(args[3], DG / CIN)
    want = _full([_ramp(dtype, 2), args[1], ones, flat, args[4]])
    _close(_plain('coords_only', [args[0], args[1], ones, *args[3:]]), want,
           dtype)


def test_io_only_is_full_on_a_ramp():
    """With every corner in the image, full's sample of the ramp y + x is
    cy + cx = (tap base) + dy + dx, so with mask 1 the sum over groups and
    taps of dy + dx + 1 is full less the taps' base positions plus dg*K."""
    args = _inputs(5, torch.float32, 'in_image_frac')
    ones = torch.ones_like(args[2])
    flat = torch.full_like(args[3], DG / CIN)
    full = _full([_ramp(torch.float32, 0), args[1], ones, flat, args[4]])
    oy = torch.arange(H).view(H, 1).float()
    ox = torch.arange(W).view(1, W).float()
    base = DG * sum((oy - 1 + i) + (ox - 1 + j) for i in range(3)
                    for j in range(3))
    _close(_plain('io_only', [args[0], args[1], ones, *args[3:]]),
           full - base + DG * 9, torch.float32)


@pytest.mark.parametrize('mode', ['no_coef', 'io_only'])
def test_bf16_variants_round_their_f32_function(mode):
    """no_coef and io_only in bf16 are their float32 functions of the same
    bf16 values, the output rounded to bf16."""
    args = _inputs(6, torch.bfloat16)
    want = _plain(mode, [a.float() for a in args])
    got = _plain(mode, args)
    assert got.dtype == torch.bfloat16
    err = ((got.float() - want).abs().max() / want.abs().max()).item()
    assert err <= TOL[torch.bfloat16], err


def test_variants_differ_from_each_other():
    """On general inputs no two variants compute the same function."""
    args = _inputs(7, torch.float32)
    outs = {m: _plain(m, args) for m in dcn_ablate.MODES}
    for a in outs:
        for b in outs:
            if a < b:
                assert not torch.allclose(outs[a], outs[b], atol=1e-3), (a, b)


def test_cuda_wrapper_refuses_cpu_tensors_and_unknown_modes():
    """The kernel's wrapper never falls back to a plain version."""
    args = _inputs(8, torch.float32)
    launches = dict(dcn.LAUNCHES)
    with pytest.raises(ValueError, match='CUDA'):
        dcn_ablate.ablate_cuda('full', *args, 1, 1, 1, DG)
    with pytest.raises(ValueError, match='unknown ablation variant'):
        dcn_ablate.ablate_cuda('no_inw', *args, 1, 1, 1, DG)
    with pytest.raises(ValueError, match='unknown ablation variant'):
        dcn_ablate.ablate_plain('rows_only', *args, 1, 1, 1, DG)
    assert dcn.LAUNCHES == launches


def test_tool_bounds_count_each_input_once():
    """The tool's bound of each variant at EDVR-M L1 in bf16: bytes of the
    inputs that variant reads, each once, and of its output, over 3.35
    TB/s; operations over the bf16 peak."""
    n, c, h, w = 5, 64, 180, 320
    meta = lambda *s: torch.empty(s, device='meta', dtype=torch.bfloat16)
    args = (meta(n, c, h, w), meta(n, 8 * 18, h, w), meta(n, 8 * 9, h, w),
            meta(c, c, 3, 3))
    x, fields, wt = n * c * h * w, n * 8 * 27 * h * w, c * c * 9
    out = n * c * h * w
    rows = {m: ablate_dcn.bound(m, *args) for m in dcn_ablate.MODES}
    assert rows['full'][3] == 2 * (x + fields + wt + out)
    assert rows['no_gather'][3] == 2 * (fields + wt + out)
    assert rows['io_only'][3] == 2 * (fields + out)
    assert rows['full'][2] == (2 * n * h * w * 9 * c * c
                               + 8 * n * h * w * 9 * c)
    for m, (ms, by, ops, nbytes) in rows.items():
        assert by == 'bytes', m  # against the tensor cores' bf16 rate
        assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    assert ablate_dcn.main(['--dtype', 'bf16']) == 1
    with pytest.raises(RuntimeError, match='CUDA'):
        ablate_dcn.run('bf16', 'l3')
