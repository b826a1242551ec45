"""Bias + leaky ReLU + scale, the counterpart of
``edvr_tpu/ops/fused_act.py`` (reference:
basicsr/models/ops/fused_act/fused_act.py:66-81): ``leaky_relu(x + b,
0.2) * sqrt(2)`` with a per-channel bias. The TPU version is an XLA
elementwise, not a Pallas kernel; this one is plain tensor ops, so
autograd's double backward goes through it.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = math.sqrt(2)) -> torch.Tensor:
    """x: (n, c, ...) or (n, c); bias: (c,) or None."""
    if bias is not None:
        x = x + bias.view(1, -1, *([1] * (x.ndim - 2)))
    return F.leaky_relu(x, negative_slope) * scale


class FusedLeakyReLU(nn.Module):
    """:func:`fused_leaky_relu` with its bias as the parameter ``bias``."""

    def __init__(self, channels, negative_slope=0.2, scale=math.sqrt(2)):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.negative_slope = negative_slope
        self.scale = scale

    def forward(self, x):
        return fused_leaky_relu(x, self.bias, self.negative_slope,
                                self.scale)
