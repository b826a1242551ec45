"""DFDNet, the deep face dictionary network (NCHW), the counterpart of
``edvr_tpu/archs/dfdnet_arch.py`` (reference:
basicsr/models/archs/dfdnet_arch.py).

Inference only, batch 1 and eager, as in both: each facial part's VGG
features are cropped at concrete locations, matched against the part
dictionary (AdaIN toward the part, a full dot product with each entry, the
softmax's argmax), the chosen entry is resized back, weighted by an
attention block and written over a copy of the features, which then steer
the SFT decoder. The module names and ``nn.Sequential`` indices are
BasicSR's, so a folded BasicSR state dict loads strictly
(``vgg_extractor.mean`` / ``.std`` included, as buffers);
:func:`state_dict_from_jax` carries a JAX parameter tree across."""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from edvr_tpu_torch.archs.dfdnet_util import (AttentionBlock,
                                              MSDilationBlock, UpResBlock,
                                              adaptive_instance_normalization,
                                              blur)
from edvr_tpu_torch.archs.vgg_arch import _MEAN, _STD, VGGFeatureExtractor
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY


class Blur(nn.Module):
    """:func:`dfdnet_util.blur` as a module (no state)."""

    def forward(self, x):
        return blur(x)


class Upsample2x(nn.Module):
    """x2 bilinear, ``align_corners=False``."""

    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode='bilinear',
                             align_corners=False)


class SFTUpBlock(nn.Module):
    """Blur, conv and LeakyReLU 0.04 (the official code stacks two of slope
    0.2), a spatial feature transform by ``updated_feat`` (scale, and a
    sigmoid shift), then x2 bilinear, conv, LeakyReLU 0.2 (reference:
    dfdnet_arch.py:13-54)."""

    def __init__(self, in_channel, out_channel, kernel_size=3, padding=1):
        super().__init__()
        self.conv1 = nn.Sequential(
            Blur(), nn.Conv2d(in_channel, out_channel, kernel_size, 1,
                              padding), nn.LeakyReLU(0.04))
        self.convup = nn.Sequential(
            Upsample2x(), nn.Conv2d(out_channel, out_channel, kernel_size, 1,
                                    padding), nn.LeakyReLU(0.2))
        self.scale_block = nn.Sequential(
            nn.Conv2d(in_channel, out_channel, 3, 1, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(out_channel, out_channel, 3, 1, 1))
        self.shift_block = nn.Sequential(
            nn.Conv2d(in_channel, out_channel, 3, 1, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(out_channel, out_channel, 3, 1, 1), nn.Sigmoid())

    def forward(self, x, updated_feat):
        out = self.conv1(x)
        out = out * self.scale_block(updated_feat) + self.shift_block(
            updated_feat)
        return self.convup(out)


def nearest_indices(out_size, in_size):
    """The source rows of a 'nearest' resize from ``in_size`` to
    ``out_size``, floor(i * in / out) in float64, as the JAX package
    computes them (``edvr_tpu/ops/resize.py::_nearest_src``); torch's
    'nearest' computes the scale in float32."""
    idx = np.floor(np.arange(out_size) * (in_size / out_size))
    return torch.from_numpy(np.minimum(idx.astype(np.int64), in_size - 1))


def nearest_resize(x, size):
    """(n, c, h, w) -> (n, c, *size) by :func:`nearest_indices`."""
    iy = nearest_indices(size[0], x.shape[2]).to(x.device)
    ix = nearest_indices(size[1], x.shape[3]).to(x.device)
    return x.index_select(2, iy).index_select(3, ix)


@ARCH_REGISTRY.register()
class DFDNet(nn.Module):
    """(reference: dfdnet_arch.py:57-180). ``forward(x, part_locations,
    dict_feat)``: ``x`` (1, 3, 512, 512) in [-1, 1]; ``part_locations``
    four integer arrays of (x0, y0, x1, y1) in the 512 px face, one row per
    image (left eye, right eye, nose, mouth); ``dict_feat`` the part
    dictionary as ``torch.load`` gives the official one,
    ``{size: {part: (k, c, h, w)}}`` (size '256', '128', '64', '32')."""

    def __init__(self, num_feat,
                 parts=('left_eye', 'right_eye', 'nose', 'mouth'),
                 feature_sizes=(256, 128, 64, 32),
                 channel_sizes=(128, 256, 512, 512),
                 vgg_layers=('relu2_2', 'relu3_4', 'relu4_4', 'conv5_4')):
        super().__init__()
        self.parts = tuple(parts)
        self.feature_sizes = tuple(feature_sizes)
        self.vgg_layers = tuple(vgg_layers)
        self.vgg_extractor = VGGFeatureExtractor(
            layer_name_list=self.vgg_layers, vgg_type='vgg19',
            use_input_norm=True, range_norm=True)
        # BasicSR keeps the extractor's normalisation in its state dict
        for name, value in (('mean', _MEAN), ('std', _STD)):
            self.vgg_extractor.register_buffer(
                name, torch.tensor(value).view(1, 3, 1, 1))
        self.attn_blocks = nn.ModuleDict(
            (f'{part}_{f_size}', AttentionBlock(channel_sizes[idx]))
            for idx, f_size in enumerate(self.feature_sizes)
            for part in self.parts)
        self.multi_scale_dilation = MSDilationBlock(num_feat * 8,
                                                    dilation=(4, 3, 2, 1))
        self.upsample0 = SFTUpBlock(num_feat * 8, num_feat * 8)
        self.upsample1 = SFTUpBlock(num_feat * 8, num_feat * 4)
        self.upsample2 = SFTUpBlock(num_feat * 4, num_feat * 2)
        self.upsample3 = SFTUpBlock(num_feat * 2, num_feat)
        self.upsample4 = nn.Sequential(
            nn.Conv2d(num_feat, num_feat, 3, 1, 1), nn.LeakyReLU(0.2),
            UpResBlock(num_feat), UpResBlock(num_feat),
            nn.Conv2d(num_feat, 3, 3, 1, 1), nn.Tanh())
        # (part, size) -> the last call's softmax over the dictionary
        # entries and the entry it chose
        self.similarity, self.selected = {}, {}

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a converted JAX tree has no normalisation (constants there)
        for name, value in (('mean', _MEAN), ('std', _STD)):
            state_dict.setdefault(f'{prefix}vgg_extractor.{name}',
                                  torch.tensor(value).view(1, 3, 1, 1))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def swap_feat(self, vgg_feat, updated_feat, dict_feat, location,
                  part_name, f_size):
        """The dictionary swap of one part at ``location`` (x0, y0, x1, y1,
        concrete ints in this layer's pixels): writes into
        ``updated_feat`` in place and returns the chosen entry (reference:
        dfdnet_arch.py:104-131)."""
        x0, y0, x1, y1 = (int(v) for v in location)
        part_feat = vgg_feat[:, :, y0:y1, x0:x1]
        part_resize_feat = F.interpolate(part_feat, size=dict_feat.shape[2:],
                                         mode='bilinear', align_corners=False)
        dict_feat = adaptive_instance_normalization(dict_feat,
                                                    part_resize_feat)
        # each entry's correlation with the part at its own size: a full
        # dot product
        sim = torch.einsum('nchw,kchw->nk', part_resize_feat, dict_feat)
        sim = torch.softmax(sim.reshape(-1), 0)
        select_idx = int(torch.argmax(sim))
        self.similarity[(part_name, f_size)] = sim.detach()
        swap = nearest_resize(dict_feat[select_idx:select_idx + 1],
                              part_feat.shape[2:])
        attn = self.attn_blocks[f'{part_name}_{f_size}'](swap - part_feat)
        updated_feat[:, :, y0:y1, x0:x1] = attn * swap + part_feat
        return select_idx

    def forward(self, x, part_locations, dict_feat):
        vgg_features = self.vgg_extractor(x)
        updated_vgg_features = []
        batch = 0  # batch 1, as in the reference
        self.similarity, self.selected = {}, {}
        for vgg_layer, f_size in zip(self.vgg_layers, self.feature_sizes):
            dict_features = dict_feat[str(f_size)] if str(
                f_size) in dict_feat else dict_feat[f_size]
            vgg_feat = vgg_features[vgg_layer]
            updated_feat = vgg_feat.clone()
            for part_idx, part_name in enumerate(self.parts):
                location = np.asarray(
                    part_locations[part_idx][batch]) // (512 // f_size)
                self.selected[(part_name, f_size)] = self.swap_feat(
                    vgg_feat, updated_feat, dict_features[part_name],
                    location, part_name, f_size)
            updated_vgg_features.append(updated_feat)

        feat = self.multi_scale_dilation(vgg_features['conv5_4'])
        feat = self.upsample0(feat, updated_vgg_features[3])
        feat = self.upsample1(feat, updated_vgg_features[2])
        feat = self.upsample2(feat, updated_vgg_features[1])
        feat = self.upsample3(feat, updated_vgg_features[0])
        return self.upsample4(feat)


# the JAX tree's DFDNet scopes, as jax_params_to_state_dict names them ->
# BasicSR's keys
_JAX_RULES = [
    (re.compile(r'^attn_blocks_(\w+?_\d+)\.'), r'attn_blocks.\1.'),
    (re.compile(r'^multi_scale_dilation\.conv_blocks_(\d+)\.'),
     r'multi_scale_dilation.conv_blocks.\1.'),
    (re.compile(r'^(upsample[0-3])\.(conv1|convup|scale_block|shift_block)_'
                r'(\d+)\.'), r'\1.\2.\3.'),
    (re.compile(r'^upsample4_(\d+)\.body_(\d+)\.'), r'upsample4.\1.body.\2.'),
    (re.compile(r'^upsample4_(\d+)\.'), r'upsample4.\1.'),
]


def state_dict_from_jax(params):
    """A JAX DFDNet parameter tree (nested dicts of arrays) -> this module's
    state dict (without the normalisation buffers, which loading fills):
    the generic conversion (VGG ``features_<index>`` by vgg19's names),
    then DFDNet's own scopes to BasicSR's keys."""
    from edvr_tpu_torch.convert import jax_params_to_state_dict
    out = {}
    for key, value in jax_params_to_state_dict(params,
                                               vgg_type='vgg19').items():
        for pattern, repl in _JAX_RULES:
            key = pattern.sub(repl, key)
        out[key] = value
    return out
