"""The bounds that ``chip_smoke.py``, ``tools/ab_kernels.py`` and
``tools/ablate_dcn.py`` print for the tensor-core kernels, and the A/B
tool's refusals, on the CPU.

A 3xTF32 kernel takes three TF32 products per fp32 product at the TF32
rate (495 TFLOP/s); the fp32-pipe figure (67 TFLOP/s) is printed beside it.
Shapes come as meta tensors: a bound reads shapes and dtypes only.
"""

import os.path as osp
import sys

import pytest
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import chip_smoke  # noqa: E402
from edvr_tpu_torch.tools import ab_kernels  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device='meta', dtype=dtype)


def test_blend_bound_is_bytes_on_the_tensor_cores():
    """EDVR-M inference L1, one group: 1.64 GB over 3.35 TB/s (0.49 ms)
    outweighs 3 x 42.5 GFLOP of TF32 (0.257 ms); on the fp32 pipe the
    operations (0.634 ms) bound it."""
    NP, width, cout = 5 * 180 * 320, 9 * 128, 64
    ms, by, flops, nbytes, fp32_pipe_ms = chip_smoke.blend_bound(
        meta(NP, width), meta(NP, width // 8), meta(width, cout),
        meta(NP, cout))
    assert flops == 2 * NP * width * cout
    assert nbytes == 4 * (NP * width + NP * width // 8 + width * cout
                          + 2 * NP * cout)
    assert by == 'bytes'
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert 3 * flops / 495e12 * 1e3 == pytest.approx(0.2574, abs=1e-4)
    assert fp32_pipe_ms == pytest.approx(flops / 67e12 * 1e3)
    assert fp32_pipe_ms == pytest.approx(0.6338, abs=1e-4)


@pytest.mark.parametrize('dtype,want_ms,want_by', [
    (torch.float32, 0.0732, 'operations'),   # 3 x 12.1 GFLOP of TF32
    (torch.bfloat16, 0.0306, 'bytes'),
])
def test_bwd_bound_at_training_l1(dtype, want_ms, want_by):
    n, c, h, w, dg, K = 20, 64, 64, 64, 8, 9
    args = [meta(n, c, h, w, dtype=dtype),
            meta(n, dg * 2 * K, h, w, dtype=dtype),
            meta(n, dg * K, h, w, dtype=dtype),
            meta(c, c, 3, 3, dtype=dtype)]
    ms, by, flops, nbytes, fp32_pipe_ms = chip_smoke.dcn_bwd_bound(*args)
    assert flops == 2 * 2 * n * h * w * c * c * K
    assert (ms, by) == (pytest.approx(want_ms, abs=1e-4), want_by)
    # the SIMT kernels' bound before the tensor cores, for comparison
    assert fp32_pipe_ms == pytest.approx(0.1803, abs=1e-4)


@pytest.mark.parametrize('bound', ['dcn_bound', 'dcn_bwd_bound'])
def test_bound_counts_the_output_size(bound):
    """1x3 taps without padding (the taps check's case): the output is
    64x62, not the input's 64x64, and the operations and the bytes of the
    output (forward) or dout (backward) are counted at 64x62."""
    n, c, h, w, dg, K = 20, 64, 64, 64, 8, 3
    oh, ow = 64, 62
    args = [meta(n, c, h, w), meta(n, dg * 2 * K, oh, ow),
            meta(n, dg * K, oh, ow), meta(c, c, 1, 3)]
    inputs = sum(a.numel() for a in args)
    if bound == 'dcn_bound':
        args.append(meta(c))
        passes, elems = 1, inputs + c + n * c * oh * ow
    else:
        passes, elems = 2, 2 * inputs + n * c * oh * ow
    _, _, flops, nbytes, _ = getattr(chip_smoke, bound)(*args)
    assert flops == passes * 2 * n * oh * ow * c * c * K
    assert nbytes == 4 * elems


@pytest.mark.parametrize('dtype,want_ms,want_by', [
    (torch.float32, 0.1287, 'operations'),   # 3 x 21.2 GFLOP of TF32
    (torch.bfloat16, 0.0592, 'bytes'),       # 2 x 21.2 GFLOP: 0.043 ms
])
def test_fwd_bound_at_inference_l1(dtype, want_ms, want_by):
    """The forward at EDVR-M inference L1: fp32 in 3xTF32 (0.129 ms of
    operations against 396 MB, 0.118 ms), bf16 as two exact products per
    column entry (0.043 ms) against 198 MB (0.059 ms); the fp32-pipe
    bound, where a contraction in fp32 FMAs would run, 0.317 ms."""
    n, c, h, w, dg, K = 5, 64, 180, 320, 8, 9
    args = [meta(n, c, h, w, dtype=dtype),
            meta(n, dg * 2 * K, h, w, dtype=dtype),
            meta(n, dg * K, h, w, dtype=dtype),
            meta(c, c, 3, 3, dtype=dtype), meta(c, dtype=dtype)]
    ms, by, flops, nbytes, fp32_pipe_ms = chip_smoke.dcn_bound(*args)
    assert flops == 2 * n * h * w * c * c * K
    assert nbytes == args[0].element_size() * (
        2 * n * c * h * w + n * dg * 3 * K * h * w + c * c * K + c)
    assert (ms, by) == (pytest.approx(want_ms, abs=1e-4), want_by)
    assert fp32_pipe_ms == pytest.approx(0.3169, abs=1e-4)


def test_ablate_tool_bound_follows_the_kernel():
    """The ablation tool's fp32 bounds at inference L1: the contracting
    variants by 3xTF32 operations (0.129 ms), the others by bytes."""
    from edvr_tpu_torch.ops import dcn_ablate
    from edvr_tpu_torch.tools import ablate_dcn
    n, c, h, w = 5, 64, 180, 320
    args = (meta(n, c, h, w), meta(n, 8 * 18, h, w), meta(n, 8 * 9, h, w),
            meta(c, c, 3, 3))
    for mode in dcn_ablate.MODES:
        ms, by, ops, nbytes = ablate_dcn.bound(mode, *args)
        if mode in ('coords_only', 'io_only'):
            assert by == 'bytes', mode
        else:
            assert (ms, by) == (pytest.approx(0.1287, abs=1e-4),
                                'operations'), mode


def test_ab_tool_refuses_unknown_sources():
    with pytest.raises(SystemExit):
        ab_kernels.main(['OLD_SCATTER=csrc/row_gather.cu'])
    with pytest.raises(SystemExit):
        ab_kernels.main(['OLD_BLEND='])
    with pytest.raises(SystemExit):
        ab_kernels.main(['OLD_FWD='])
    with pytest.raises(SystemExit):
        ab_kernels.main(['--ablate', 'no_such_group'])
    assert set(ab_kernels.OLD_SOURCES) == {'OLD_FWD', 'OLD_BLEND',
                                           'OLD_BWD', 'OLD_GATHER'}
    assert ab_kernels.OLD_SOURCES['OLD_FWD'] == ('dcn_fwd', (
        'dcn_fwd', 'dcn_fwd_bf16'))
    assert ab_kernels.OLD_SOURCES['OLD_BLEND'] == ('blend_matmul', (
        'blend_matmul', 'blend_matmul_bf16'))
    assert ab_kernels.OLD_SOURCES['OLD_GATHER'] == ('row_gather',
                                                    ('row_gather',))


def test_ab_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert ab_kernels.main(['OLD_BWD=old/dcn_bwd.cu', '--ablate']) == 1
