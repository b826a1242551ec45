"""Flow warping and flow resizing (NCHW images, BasicSR's flow layouts),
the counterparts of ``edvr_tpu/ops/sampling.py:88-146`` (reference:
basicsr/models/archs/arch_util.py:121-209), on ``F.grid_sample`` and
``F.interpolate``.

Pixel coordinates are normalised to [-1, 1] with the ``align_corners=True``
convention whatever ``align_corners`` says, and the flag goes to
``grid_sample``, which unnormalises by it: with ``align_corners=False`` the
sample therefore lands at ``((g + 1) * size - 1) / 2``, as in the JAX
package's (and the reference's) ``align_corners=False`` branch.
``grid_sample``'s ``zeros`` padding zeroes each bilinear tap outside the
image, ``border`` clamps the coordinates, and ``nearest`` rounds half to
even (``nearbyint``), as ``jnp.rint`` does.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def flow_warp(x, flow, interp_mode='bilinear', padding_mode='zeros',
              align_corners=True):
    """Warp ``x`` (n, c, h, w) by ``flow`` (n, h, w, 2), a displacement in
    pixels with channels (dx, dy): output pixel (i, j) samples ``x`` at
    (i + dy, j + dx)."""
    n, _, h, w = x.shape
    if flow.shape[1:3] != (h, w):
        raise ValueError(f'flow of shape {tuple(flow.shape)} does not '
                         f'match the image {h}x{w}')
    grid_y, grid_x = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing='ij')
    gx = 2.0 * (grid_x + flow[..., 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (grid_y + flow[..., 1]) / max(h - 1, 1) - 1.0
    return F.grid_sample(x, torch.stack((gx, gy), dim=3).to(x.dtype),
                         mode=interp_mode, padding_mode=padding_mode,
                         align_corners=align_corners)


def resize_flow(flow, size_type, sizes, interp_mode='bilinear',
                align_corners=False):
    """Resize ``flow`` (n, 2, h, w; channels dx, dy in pixels) by a
    ``'ratio'`` [ratio_h, ratio_w] or to a ``'shape'`` [out_h, out_w],
    scaling its vectors by the same factors."""
    _, _, h, w = flow.shape
    if size_type == 'ratio':
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == 'shape':
        out_h, out_w = int(sizes[0]), int(sizes[1])
    else:
        raise ValueError(
            f'Size type should be ratio or shape, but got type {size_type}.')
    scale = torch.tensor([out_w / w, out_h / h], dtype=flow.dtype,
                         device=flow.device).view(1, 2, 1, 1)
    # 'nearest' takes no corner alignment
    return F.interpolate(flow * scale, size=(out_h, out_w), mode=interp_mode,
                         align_corners=(None if interp_mode == 'nearest'
                                        else align_corners))
