"""SpyNet optical flow (NCHW), the counterpart of
``edvr_tpu/archs/spynet_arch.py`` (reference:
basicsr/models/archs/spynet_arch.py): both frames resized to multiples of
32, normalised by ImageNet's mean and std, a 6-level average-pooled
pyramid refined coarse to fine by one ``BasicModule`` a level, the flow
resized back and its vectors rescaled. The flow is (n, 2, h, w), channels
(dx, dy)."""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.ops.sampling import flow_warp
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ImageNetNorm(nn.Module):
    """A network that normalises its frames by ImageNet's ``mean`` / ``std``:
    (1, 3, 1, 1) buffers, kept in its state dict as BasicSR keeps them. A
    state dict without them (a converted flax tree: the flax modules hold
    them as constants) loads with the constants filled in."""

    def __init__(self):
        super().__init__()
        self.register_buffer('mean',
                             torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1))
        self.register_buffer('std',
                             torch.tensor(IMAGENET_STD).view(1, 3, 1, 1))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name, value in (('mean', IMAGENET_MEAN), ('std', IMAGENET_STD)):
            state_dict.setdefault(prefix + name,
                                  torch.tensor(value).view(1, 3, 1, 1))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def upsample_flow(flow):
    """The coarser level's flow at twice its size and twice its vectors
    (bilinear, corners aligned)."""
    return F.interpolate(flow, scale_factor=2, mode='bilinear',
                         align_corners=True) * 2.0


class BasicModule(nn.Module):
    """Five 7x7 convs (8 -> 32 -> 64 -> 32 -> 16 -> 2) with ReLUs between,
    children 0, 2, 4, 6, 8 of ``basic_module``."""

    def __init__(self):
        super().__init__()
        chans = [8, 32, 64, 32, 16, 2]
        layers = []
        for i in range(5):
            layers.append(nn.Conv2d(chans[i], chans[i + 1], 7, 1, 3))
            if i < 4:
                layers.append(nn.ReLU(inplace=True))
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        return self.basic_module(x)


@ARCH_REGISTRY.register()
class SpyNet(ImageNetNorm):
    """``forward(ref, supp)``: (n, 3, h, w) RGB frames in [0, 1] -> the flow
    (n, 2, h, w) that warps ``supp`` onto ``ref``."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList([BasicModule() for _ in range(6)])

    def process(self, ref, supp):
        refs = [(ref - self.mean) / self.std]
        supps = [(supp - self.mean) / self.std]
        for _ in range(5):
            refs.insert(0, F.avg_pool2d(refs[0], 2, 2))
            supps.insert(0, F.avg_pool2d(supps[0], 2, 2))
        n, _, h0, w0 = refs[0].shape
        flow = refs[0].new_zeros(n, 2, h0 // 2, w0 // 2)
        for level, module in enumerate(self.basic_module):
            up = upsample_flow(flow)
            # an odd level: one more row / column, its edge repeated
            if up.shape[2] != refs[level].shape[2]:
                up = F.pad(up, (0, 0, 0, 1), mode='replicate')
            if up.shape[3] != refs[level].shape[3]:
                up = F.pad(up, (0, 1, 0, 0), mode='replicate')
            warped = flow_warp(supps[level], up.permute(0, 2, 3, 1),
                               padding_mode='border')
            flow = module(torch.cat([refs[level], warped, up], 1)) + up
        return flow

    def forward(self, ref, supp):
        if ref.shape != supp.shape:
            raise ValueError(f'frames of shapes {tuple(ref.shape)} and '
                             f'{tuple(supp.shape)}')
        h, w = ref.shape[2:]
        h_floor = math.floor(math.ceil(h / 32.0) * 32.0)
        w_floor = math.floor(math.ceil(w / 32.0) * 32.0)
        ref = F.interpolate(ref, size=(h_floor, w_floor), mode='bilinear',
                            align_corners=False)
        supp = F.interpolate(supp, size=(h_floor, w_floor), mode='bilinear',
                             align_corners=False)
        flow = F.interpolate(self.process(ref, supp), size=(h, w),
                             mode='bilinear', align_corners=False)
        scale = torch.tensor([w / w_floor, h / h_floor], dtype=flow.dtype,
                             device=flow.device)
        return flow * scale.view(1, 2, 1, 1)
