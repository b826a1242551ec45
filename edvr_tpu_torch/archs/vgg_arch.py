"""VGG feature extractor of the perceptual loss (NCHW), the counterpart of
``edvr_tpu/archs/vgg_arch.py`` (reference:
basicsr/models/archs/vgg_arch.py): a VGG truncated after the deepest
requested layer, its layers named as in BasicSR (``vgg_net.conv1_1``, ...),
returning a dict of the requested features. ``load_torchvision_vgg`` reads
torchvision's ``vgg*.pth`` (``features.<index>`` keys) into it; nothing is
downloaded."""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from edvr_tpu_torch.utils.registry import ARCH_REGISTRY

VGG_PRETRAIN_PATH = 'experiments/pretrained_models/vgg19-dcbb9e9d.pth'

_BLOCKS = {'vgg11': (1, 1, 2, 2, 2), 'vgg13': (2, 2, 2, 2, 2),
           'vgg16': (2, 2, 3, 3, 3), 'vgg19': (2, 2, 4, 4, 4)}
_STAGE_CH = (64, 128, 256, 512, 512)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _names(blocks):
    names = []
    for stage, n in enumerate(blocks, start=1):
        for i in range(1, n + 1):
            names += [f'conv{stage}_{i}', f'relu{stage}_{i}']
        names.append(f'pool{stage}')
    return names


# torchvision's layer order: NAMES[vgg_type][index] names features.<index>
NAMES = {k: _names(v) for k, v in _BLOCKS.items()}


def insert_bn(names):
    """A bn layer name after each conv (reference: vgg_arch.py:41-57)."""
    out = []
    for name in names:
        out.append(name)
        if 'conv' in name:
            out.append('bn' + name.replace('conv', ''))
    return out


def layer_names(vgg_type):
    """The layer names of ``vgg_type`` (``vgg19``, ``vgg19_bn``, ...) in
    torchvision's order."""
    names = NAMES[vgg_type.replace('_bn', '')]
    return insert_bn(names) if 'bn' in vgg_type else names


@ARCH_REGISTRY.register()
class VGGFeatureExtractor(nn.Module):
    """Frozen features are the caller's choice (``requires_grad_``);
    batch-norm variants run on their running statistics, as the JAX module
    always does."""

    def __init__(self, layer_name_list, vgg_type='vgg19', use_input_norm=True,
                 range_norm=False, remove_pooling=False, pooling_stride=2):
        super().__init__()
        self.layer_name_list = list(layer_name_list)
        self.vgg_type = vgg_type
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        names = layer_names(vgg_type)
        max_idx = max(names.index(v) for v in self.layer_name_list)
        layers = OrderedDict()
        cin = 3
        for name in names[:max_idx + 1]:
            if name.startswith('conv'):
                ch = _STAGE_CH[int(name[4]) - 1]
                layers[name] = nn.Conv2d(cin, ch, 3, 1, 1)
                cin = ch
            elif name.startswith('bn'):
                layers[name] = nn.BatchNorm2d(cin, eps=1e-5)
            elif name.startswith('relu'):
                layers[name] = nn.ReLU()
            elif not remove_pooling:
                layers[name] = nn.MaxPool2d(2, stride=pooling_stride)
        self.vgg_net = nn.Sequential(layers)
        # constants, as in the JAX module (kept out of the state dict)
        self.register_buffer('mean', torch.tensor(_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer('std', torch.tensor(_STD).view(1, 3, 1, 1),
                             persistent=False)

    def train(self, mode=True):
        """The bn variants' layers stay on their running statistics."""
        super().train(mode)
        for m in self.vgg_net:
            if isinstance(m, nn.BatchNorm2d):
                m.eval()
        return self

    def forward(self, x):
        if self.range_norm:
            x = (x + 1) / 2
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        out = {}
        for name, layer in self.vgg_net.named_children():
            x = layer(x)
            if name in self.layer_name_list:
                out[name] = x
        return out


def load_torchvision_vgg(net: VGGFeatureExtractor, path: str):
    """Load torchvision's ``vgg*.pth`` (``features.<index>.*`` keys; the
    classifier is ignored) into ``net``, strictly for its layers."""
    names = layer_names(net.vgg_type)
    state = torch.load(path, map_location='cpu', weights_only=True)
    own = net.state_dict()
    mapped = {}
    for key, value in state.items():
        parts = key.split('.')
        if parts[0] != 'features':
            continue
        name = f'vgg_net.{names[int(parts[1])]}.{".".join(parts[2:])}'
        if name in own:
            mapped[name] = value
    net.load_state_dict(mapped, strict=True)
    return net
