"""Architectures, resolved by YAML ``type`` names
(reference: basicsr/models/archs/__init__.py:10-46)."""

from copy import deepcopy

# importing the modules registers the classes
from edvr_tpu_torch.archs import (dfdnet_arch,  # noqa: F401
                                  discriminator_arch, duf_arch,
                                  edsr_arch, rcan_arch, rrdbnet_arch,
                                  spynet_arch, srresnet_arch, stylegan2_arch,
                                  tof_arch, vgg_arch)
from edvr_tpu_torch.archs.dfdnet_arch import DFDNet
from edvr_tpu_torch.archs.discriminator_arch import VGGStyleDiscriminator128
from edvr_tpu_torch.archs.duf_arch import DUF
from edvr_tpu_torch.archs.edsr_arch import EDSR
from edvr_tpu_torch.archs.edvr_arch import EDVR, PCDAlignment, TSAFusion
from edvr_tpu_torch.archs.rcan_arch import RCAN
from edvr_tpu_torch.archs.rrdbnet_arch import RRDBNet
from edvr_tpu_torch.archs.spynet_arch import SpyNet
from edvr_tpu_torch.archs.srresnet_arch import MSRResNet
from edvr_tpu_torch.archs.stylegan2_arch import (StyleGAN2Discriminator,
                                                 StyleGAN2Generator)
from edvr_tpu_torch.archs.tof_arch import TOFlow
from edvr_tpu_torch.archs.vgg_arch import VGGFeatureExtractor
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY

__all__ = ['define_network', 'ARCH_REGISTRY', 'EDVR', 'PCDAlignment',
           'TSAFusion', 'EDSR', 'RCAN', 'RRDBNet', 'MSRResNet',
           'VGGStyleDiscriminator128', 'VGGFeatureExtractor',
           'StyleGAN2Generator', 'StyleGAN2Discriminator', 'SpyNet',
           'TOFlow', 'DUF', 'DFDNet']


def define_network(opt: dict):
    """Instantiate an architecture from its YAML option dict."""
    opt = deepcopy(opt)
    network_type = opt.pop('type')
    return ARCH_REGISTRY.get(network_type)(**opt)
