"""Architectures, resolved by YAML ``type`` names
(reference: basicsr/models/archs/__init__.py:10-46)."""

from copy import deepcopy

from edvr_tpu_torch.archs.edvr_arch import EDVR, PCDAlignment, TSAFusion
from edvr_tpu_torch.utils.registry import ARCH_REGISTRY

__all__ = ['define_network', 'ARCH_REGISTRY', 'EDVR', 'PCDAlignment',
           'TSAFusion']


def define_network(opt: dict):
    """Instantiate an architecture from its YAML option dict."""
    opt = deepcopy(opt)
    network_type = opt.pop('type')
    return ARCH_REGISTRY.get(network_type)(**opt)
