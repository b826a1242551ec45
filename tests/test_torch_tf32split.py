"""The arithmetic of the port's tensor-core kernels, emulated in plain
torch on the CPU: 3xTF32 products (``csrc/blend_matmul.cu``, the fp32
``csrc/dcn_bwd.cu`` and ``csrc/dcn_fwd.cu``) and the bf16 hi/lo split of
a float32 column (the bf16 ``dcn_bwd.cu``'s weight gradient and the bf16
``dcn_fwd.cu``'s contraction), each held against a float64
reference at the kernels' tolerances. A TF32 value is a float32 rounded
to nearest, ties away from zero, on its 13 low mantissa bits
(``cvt.rna.tf32.f32``); a product of two is exact in float32, so a
float32 matmul of TF32 values sums exact products in float32, as the
tensor cores do. Needs neither a card nor JAX.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BLEND_TOL = 1e-5  # of max|out|: chip_smoke.py's blend gate
BWD_TOL = 1e-4    # of max|dW|: chip_smoke.py's fp32 backward gate
BLEND_DEPTH = 9 * 128       # EDVR-M's g_cat width at c_per 8
DW_DEPTH = 20 * 64 * 64     # training L1: n = 20 frames of 64 x 64 pixels


def tf32(a):
    """float32 -> TF32 (still float32), round to nearest, ties away."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernels take it: lo_a*hi_b + hi_a*lo_b + hi_a*hi_b,
    every product in one float32 sum."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return torch.cat([a_lo, a_hi, a_hi], 1) @ torch.cat([b_hi, b_lo, b_hi])


def split_bf16(a):
    """float32 -> (bf16 hi, bf16 lo) as float32: hi + lo ~ a."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def rel_to_max(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def blend_case(seed, rows=512, cout=64, c_per=8):
    """g_cat, its expanded coefficients, wexp_g and out_prev of the blend
    at EDVR-M's width, as float32."""
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(rows, BLEND_DEPTH).astype(np.float32))
    cs = torch.from_numpy(rng.rand(rows, BLEND_DEPTH // c_per)
                          .astype(np.float32))
    w = torch.from_numpy((rng.randn(BLEND_DEPTH, cout) / 30)
                         .astype(np.float32))
    prev = torch.from_numpy(rng.randn(rows, cout).astype(np.float32))
    return g * cs.repeat_interleave(c_per, 1), w, prev


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    cases = {one + 2.0 ** -11: one + 2.0 ** -10,   # a tie: away from zero
             one + 2.0 ** -12: one,
             one + 3 * 2.0 ** -12: one + 2.0 ** -10,
             -(one + 2.0 ** -11): -(one + 2.0 ** -10),
             2.0 ** -20 * (one + 2.0 ** -13): 2.0 ** -20}
    got = tf32(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == list(cases.values())
    # a TF32 value keeps 10 stored mantissa bits; the split is exact
    a = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    hi, lo = split_tf32(a)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert (hi.double() + lo.double() - a.double()).abs().max() <= (
        2.0 ** -21 * a.double().abs()).max()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_3xtf32_blend_within_tol(seed):
    """out_prev + blended @ wexp_g at the blend's 1152-deep sum, in
    3xTF32, within BLEND_TOL of max|out| of float64 (a few 1e-7)."""
    blended, w, prev = blend_case(seed)
    want = prev.double() + blended.double() @ w.double()
    got = prev + mm_3xtf32(blended, w)
    assert rel_to_max(got, want) <= BLEND_TOL / 10


def test_single_tf32_misses_blend_tol():
    """One TF32 product per fp32 product keeps ~2^-11: the blend's gate
    refuses it, so the gate can tell 3xTF32 from plain TF32."""
    blended, w, prev = blend_case(3)
    want = prev.double() + blended.double() @ w.double()
    got = prev + tf32(blended) @ tf32(w)
    assert rel_to_max(got, want) > BLEND_TOL


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_dw_depth_within_tol(dtype):
    """dW^T = dout . column^T over training L1's 81,920 pixels: fp32 as
    3xTF32 within BWD_TOL of max|dW| of float64; bf16 (dout in bf16, the
    float32 column split into a bf16 hi and lo, two exact products per
    pixel) within BWD_TOL as well, far inside its 4e-2 gate."""
    rng = np.random.RandomState(5)
    col = torch.from_numpy(rng.randn(72, DW_DEPTH).astype(np.float32))
    dout = torch.from_numpy(rng.randn(64, DW_DEPTH).astype(np.float32))
    if dtype == 'bf16':
        dout = dout.to(torch.bfloat16).float()
        hi, lo = split_bf16(col)
        got = torch.cat([dout, dout], 1) @ torch.cat([lo, hi], 1).t()
    else:
        got = mm_3xtf32(dout, col.t().contiguous())
    want = dout.double() @ col.double().t()
    assert rel_to_max(got, want) <= BWD_TOL / 10


@pytest.mark.parametrize('seed', [0, 1])
def test_bf16_hi_lo_reproduces_the_column(seed):
    """A float32 column split into bf16 hi + lo is the column to 2^-16
    relative: the bf16 weight gradient adds no rounding point."""
    rng = np.random.RandomState(seed)
    col = torch.from_numpy((rng.randn(100000) * np.exp(rng.randn(100000)))
                           .astype(np.float32))
    hi, lo = split_bf16(col)
    gap = (hi.double() + lo.double() - col.double()).abs()
    assert (gap <= 2.0 ** -16 * col.double().abs()).all()
    # while bf16 alone keeps only 2^-9
    assert ((hi.double() - col.double()).abs()
            > 2.0 ** -16 * col.double().abs()).any()


def rz32(x):
    """float64 -> float32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma_3xtf32_rz(a, b, chunk):
    """a @ b as the tensor cores take it in 3xTF32: each m16n8k8 product
    adds 8 exact products to its float32 accumulator and rounds the sum
    toward zero. With ``chunk``, the sum restarts every ``chunk`` columns
    and each chunk's sum joins the running sum by one float32 add (round to
    nearest), as csrc/blend_matmul.cu does; without, all 3 x W/8 products
    go into the running sum."""
    a_hi, a_lo = (x.numpy() for x in split_tf32(torch.from_numpy(a)))
    b_hi, b_lo = (x.numpy() for x in split_tf32(torch.from_numpy(b)))
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    part = np.zeros_like(acc)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            part = rz32(part.astype(np.float64)
                        + x[:, k].astype(np.float64) @ y[k].astype(np.float64))
        if chunk and (k0 + 8) % chunk == 0:
            acc, part = acc + part, np.zeros_like(part)
    return acc + part


def rz_blend_case(seed, c_per, rows=777, cout=128):
    """The card test's blend inputs (every operand N(0, 1))."""
    rng = np.random.RandomState(seed)
    g = rng.randn(rows, BLEND_DEPTH).astype(np.float32)
    cs = rng.randn(rows, BLEND_DEPTH // c_per).astype(np.float32)
    w = rng.randn(BLEND_DEPTH, cout).astype(np.float32)
    prev = rng.randn(rows, cout).astype(np.float32)
    blended = g * np.repeat(cs, c_per, 1)
    want = prev.astype(np.float64) + (blended.astype(np.float64)
                                      @ w.astype(np.float64))
    return blended, w, prev, want


def test_rz_running_sum_misses_blend_tol():
    """Three products a step truncated into the running sum drift by
    ~1e-5 of max|out| over the 1152-deep blend (1.17e-5 on the card before
    the kernel summed per chunk): the truncation, not 3xTF32, fails the
    gate."""
    blended, w, prev, want = rz_blend_case(0, 32)
    got = prev + mma_3xtf32_rz(blended, w, chunk=0)
    assert np.abs(got - want).max() / np.abs(want).max() > BLEND_TOL


@pytest.mark.parametrize('seed,c_per', [(0, 32), (1, 8), (2, 32)])
def test_rz_chunk_sums_hold_blend_tol(seed, c_per):
    """Per-chunk sums (32 columns, 12 truncations each, then one float32
    add) keep the truncation at the chunk's magnitude: a few 1e-7."""
    blended, w, prev, want = rz_blend_case(seed, c_per)
    got = prev + mma_3xtf32_rz(blended, w, chunk=32)
    assert np.abs(got - want).max() / np.abs(want).max() <= BLEND_TOL / 10


# ---- the DCNv2 forward (csrc/dcn_fwd.cu): the column, built by the plain
# version, contracted in 64-row slabs (DEPTH), each slab's products
# truncated into fresh accumulators and joined by one float32 add

DCN_TOL = 1e-4   # absolute: chip_smoke.py's fp32 forward gate
SLAB = 64        # dcn_fwd.cu's DEPTH


def dcn_column(seed, cin, dg, n=8, h=8, w=8, k=3, n01_weights=False,
               cout=64):
    """The float32 masked bilinear column (n*h*w pixels, dg*K*c_per rows
    in the kernel's weight order) of inputs drawn as chip_smoke.py's
    dcn_inputs draws them (offsets U(-2, 2), 5% of them 10-25 px away,
    sigmoid masks), built by the port's plain DCN with one-hot weights;
    and weights of that depth: U(-b, b), b = 1/sqrt(cin*K), or N(0, 1)."""
    from edvr_tpu_torch.ops.dcn import modulated_deform_conv_plain
    rng = np.random.RandomState(seed)
    K, c_per = k * k, cin // dg
    x = rng.randn(n, cin, h, w)
    off = rng.rand(n, dg * 2 * K, h, w) * 4 - 2
    far = rng.rand(*off.shape) < 0.05
    off = np.where(far, (rng.rand(*off.shape) * 15 + 10)
                   * np.sign(rng.rand(*off.shape) - 0.5), off)
    mask = 1 / (1 + np.exp(-rng.randn(n, dg * K, h, w)))
    rows = dg * K * c_per
    sel = np.zeros((rows, cin, k, k))
    for g in range(dg):
        for t in range(K):
            for c in range(c_per):
                sel[(g * K + t) * c_per + c, g * c_per + c, t // k,
                    t % k] = 1
    col = modulated_deform_conv_plain(
        *(torch.from_numpy(a.astype(np.float32)) for a in
          (x, off, mask, sel)), None, 1, 1, 1, 1, dg)
    col = col.permute(0, 2, 3, 1).reshape(-1, rows).numpy()
    if n01_weights:
        wt = rng.randn(rows, cout)
    else:
        wt = (rng.rand(rows, cout) * 2 - 1) / np.sqrt(rows)
    return col, wt.astype(np.float32)


def mma_bf16_hilo_rz(a, b, chunk):
    """a @ b as the bf16 forward takes it: a (the float32 column) split
    into bf16 hi + lo, b bf16; each m16n8k16 product adds 16 exact
    products to its float32 accumulator and rounds toward zero (lo first,
    then hi); every ``chunk`` rows the sum joins the running sum by one
    float32 add."""
    hi, lo = (x.numpy() for x in split_bf16(torch.from_numpy(a)))
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    part = np.zeros_like(acc)
    for k0 in range(0, a.shape[1], 16):
        k = slice(k0, k0 + 16)
        for x in (lo, hi):
            part = rz32(part.astype(np.float64)
                        + x[:, k].astype(np.float64) @ b[k].astype(np.float64))
        if chunk and (k0 + 16) % chunk == 0:
            acc, part = acc + part, np.zeros_like(part)
    return acc + part


@pytest.mark.parametrize('name,cin,dg,cout', [
    ('edvr_m', 64, 8, 64),     # 8 groups x 72 rows
    ('edvr_l', 128, 8, 128),   # 8 groups x 144 rows
])
def test_rz_forward_slabs_hold_dcn_tol(name, cin, dg, cout):
    """fp32 at EDVR-M's and EDVR-L's depth on chip_smoke-like values:
    64-row slab sums in 3xTF32 (truncating accumulators) hold DCN_TOL
    against float64 a hundredfold (~5e-7 of outputs ~1). At these depths
    and values a plain running sum holds it too (~5e-6 and ~8e-6): the
    slabs are for deeper, larger sums (the next test)."""
    col, wt = dcn_column(0, cin, dg, cout=cout)
    want = col.astype(np.float64) @ wt.astype(np.float64)
    slabs = mma_3xtf32_rz(col, wt, chunk=SLAB)
    running = mma_3xtf32_rz(col, wt, chunk=0)
    assert np.abs(slabs - want).max() <= DCN_TOL / 100
    assert np.abs(running - want).max() <= DCN_TOL


@pytest.mark.parametrize('seed', [0, 1])
def test_rz_forward_deep_n01(seed):
    """The card test's deep case (c_per 32, cin 128, cout 128, N(0, 1)
    weights; outputs up to ~50): a running sum of truncated products
    misses DCN_TOL (~5e-4), 64-row slab sums hold it (~3e-5)."""
    col, wt = dcn_column(seed, 128, 4, n=5, cout=128, n01_weights=True)
    want = col.astype(np.float64) @ wt.astype(np.float64)
    assert np.abs(mma_3xtf32_rz(col, wt, chunk=0) - want).max() > DCN_TOL
    assert np.abs(mma_3xtf32_rz(col, wt, chunk=SLAB)
                  - want).max() <= DCN_TOL / 2


@pytest.mark.parametrize('cin,dg', [(64, 8), (128, 8)])
def test_bf16_hi_lo_column_product(cin, dg):
    """bf16: the float32 column split into bf16 hi + lo, each product with
    the bf16 weights exact, slab sums truncated: the float32 column's
    product to ~3e-6 of max|out|, far inside BF16_FWD_TOL (1e-2 of
    max|out|, one output ulp); the column rounded once to bf16 instead
    moves it by ~2e-3, a rounding point band_forward does not have."""
    col, wt = dcn_column(1, cin, dg, cout=cin)
    wt = torch.from_numpy(wt).to(torch.bfloat16).float().numpy()
    want = col.astype(np.float64) @ wt.astype(np.float64)
    scale = np.abs(want).max()
    got = mma_bf16_hilo_rz(col, wt, chunk=SLAB)
    assert np.abs(got - want).max() / scale <= 1e-5
    one = torch.from_numpy(col).to(torch.bfloat16).double().numpy() @ wt
    assert np.abs(one - want).max() / scale > 1e-4
