"""The bounds that ``chip_smoke.py`` and ``tools/ab_kernels.py`` print for
the tensor-core kernels, and the A/B tool's refusals, on the CPU.

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


def test_ab_tool_refuses_unknown_sources():
    with pytest.raises(SystemExit):
        ab_kernels.main(['OLD_FWD=csrc/dcn_fwd.cu'])
    with pytest.raises(SystemExit):
        ab_kernels.main(['OLD_BLEND='])


def test_ab_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert ab_kernels.main(['OLD_BWD=old/dcn_bwd.cu', '--ablate']) == 1
