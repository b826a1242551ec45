"""upfirdn2d: upsample (zero insertion), pad or crop, 2-D FIR filter,
downsample; the counterpart of ``edvr_tpu/ops/upfirdn2d.py`` (reference:
basicsr/models/ops/upfirdn2d/upfirdn2d.py:84-117, whose output size is
``(in*up + pad0 + pad1 - k)//down + 1``).

The TPU version is one XLA convolution, not a Pallas kernel; here it is
one depthwise convolution with the channels folded into the batch
(``ops/conv_grad.py``'s ``conv2d``, ``F.conv2d`` whose gradients are
convolutions again), on plain tensor ops only, so that autograd's double
backward (the R1 and path-length regularisers) goes through it. Zero
insertion leaves ``up - 1`` zeros after every sample, the last row and
column included, as the reference's does; a negative pad crops. The FIR
kernel is flipped because a convolution here is a correlation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from edvr_tpu_torch.ops import conv_grad


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """Apply upfirdn to an NCHW batch.

    Args:
        x: (n, c, h, w).
        kernel: (kh, kw) FIR filter.
        up, down: integer resampling factors, the same on both axes.
        pad: (pad0, pad1) on both axes, or (x0, x1, y0, y1); negative
            entries crop.

    Returns:
        (n, c, out_h, out_w), out = (in*up + pad0 + pad1 - k)//down + 1.
    """
    if len(pad) == 2:
        px0, px1, py0, py1 = pad[0], pad[1], pad[0], pad[1]
    else:
        px0, px1, py0, py1 = pad
    n, c, h, w = x.shape
    v = x.reshape(n * c, 1, h, w)
    if up > 1:
        # each sample followed by up - 1 zeros on both axes
        v = F.pad(v.reshape(n * c, h, 1, w, 1), (0, up - 1, 0, 0, 0, up - 1))
        v = v.reshape(n * c, 1, h * up, w * up)
    v = F.pad(v, (max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)))
    hp, wp = v.shape[2], v.shape[3]
    v = v[:, :, max(-py0, 0):hp - max(-py1, 0),
          max(-px0, 0):wp - max(-px1, 0)]
    k = torch.flip(kernel, (0, 1)).to(v.dtype)[None, None]
    v = conv_grad.conv2d(v, k, stride=down)
    return v.reshape(n, c, v.shape[2], v.shape[3])


def make_resample_kernel(k) -> torch.Tensor:
    """Normalised 2-D resampling kernel from a 1-D tap list (its outer
    product) or a 2-D one (reference: stylegan2_arch.py:16-33)."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()
