"""TOFlow and its BatchNorm SPyNet (NCHW), the counterpart of
``edvr_tpu/archs/tof_arch.py`` (reference:
basicsr/models/archs/tof_arch.py): the seven pre-upsampled frames
normalised by ImageNet's mean and std, each neighbour's flow to the
reference frame from a 4-level SPyNet with BatchNorm, the neighbours
warped, the seven frames stacked frame-major into 21 channels, and a
4-conv reconstruction added to the reference frame.

The BatchNorm layers update their running statistics as flax does
(``arch_util.BatchNorm2d``, flax momentum 0.9)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.archs.arch_util import BatchNorm2d
from edvr_tpu_torch.archs.spynet_arch import ImageNetNorm, upsample_flow
from edvr_tpu_torch.ops.sampling import flow_warp
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY


class BasicModule(nn.Module):
    """Four 7x7 conv + BatchNorm + ReLU stages (8 -> 32 -> 64 -> 32 -> 16)
    and a 7x7 conv to the flow's 2 channels; ``basic_module`` children
    0, 3, 6, 9, 12 are the convs, 1, 4, 7, 10 the BatchNorms."""

    def __init__(self):
        super().__init__()
        chans = [8, 32, 64, 32, 16]
        layers = []
        for i in range(4):
            layers += [nn.Conv2d(chans[i], chans[i + 1], 7, 1, 3),
                       BatchNorm2d(chans[i + 1]), nn.ReLU(inplace=True)]
        layers.append(nn.Conv2d(16, 2, 7, 1, 3))
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        return self.basic_module(x)


class SPyNetTOF(nn.Module):
    """``forward(ref, supp)``: normalised (n, 3, h, w) frames, h and w
    multiples of 16 -> the flow (n, 2, h, w) that warps ``supp`` onto
    ``ref``, from a 4-level average-pooled pyramid."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList([BasicModule() for _ in range(4)])

    def forward(self, ref, supp):
        n, _, h, w = ref.shape
        refs, supps = [ref], [supp]
        for _ in range(3):
            refs.insert(0, F.avg_pool2d(refs[0], 2, 2))
            supps.insert(0, F.avg_pool2d(supps[0], 2, 2))
        flow = ref.new_zeros(n, 2, h // 16, w // 16)
        for level, module in enumerate(self.basic_module):
            up = upsample_flow(flow)
            warped = flow_warp(supps[level], up.permute(0, 2, 3, 1))
            flow = up + module(torch.cat([refs[level], warped, up], 1))
        return flow


@ARCH_REGISTRY.register()
class TOFlow(ImageNetNorm):
    """``forward(lrs)``: (b, 7, 3, h, w) frames upsampled to the output
    size -> (b, 3, h, w). The reference frame is frame 3; with
    ``adapt_official_weights`` the frames are reordered [3, 0, 1, 2, 4, 5,
    6] first and the reference is frame 0, the official model's order."""

    def __init__(self, adapt_official_weights=False):
        super().__init__()
        self.adapt_official_weights = adapt_official_weights
        self.ref_idx = 0 if adapt_official_weights else 3
        self.spynet = SPyNetTOF()
        self.conv_1 = nn.Conv2d(3 * 7, 64, 9, 1, 4)
        self.conv_2 = nn.Conv2d(64, 64, 9, 1, 4)
        self.conv_3 = nn.Conv2d(64, 64, 1)
        self.conv_4 = nn.Conv2d(64, 3, 1)

    def forward(self, lrs):
        if self.adapt_official_weights:
            lrs = lrs[:, [3, 0, 1, 2, 4, 5, 6]]
        b, t, c, h, w = lrs.shape
        lrs = (lrs - self.mean.unsqueeze(1)) / self.std.unsqueeze(1)
        lr_ref = lrs[:, self.ref_idx]
        # the six neighbours' flows in one SPyNet call, batch b * 6
        supp_idx = [i for i in range(t) if i != self.ref_idx]
        supp = lrs[:, supp_idx].reshape(b * (t - 1), c, h, w)
        ref = lr_ref.unsqueeze(1).expand(b, t - 1, c, h, w).reshape(
            b * (t - 1), c, h, w)
        warped = flow_warp(supp, self.spynet(ref, supp).permute(0, 2, 3, 1))
        warped = warped.view(b, t - 1, c, h, w)
        aligned = torch.cat([warped[:, :self.ref_idx], lr_ref.unsqueeze(1),
                             warped[:, self.ref_idx:]], 1)
        hr = aligned.reshape(b, t * c, h, w)  # frame-major channels
        hr = F.relu(self.conv_1(hr))
        hr = F.relu(self.conv_2(hr))
        hr = F.relu(self.conv_3(hr))
        hr = self.conv_4(hr) + lr_ref
        return hr * self.std + self.mean
