"""Engines, resolved by YAML ``model_type``
(reference: basicsr/models/__init__.py)."""

from __future__ import annotations

from copy import deepcopy

from edvr_tpu_torch.models import (edvr_model, esrgan_model,  # noqa: F401
                                   sr_model, srgan_model, stylegan2_model,
                                   video_base_model, video_gan_model)
from edvr_tpu_torch.utils import get_root_logger
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY

__all__ = ['create_model']


def create_model(opt: dict):
    """Create an engine from the option dict's ``model_type``."""
    opt = deepcopy(opt)
    model = MODEL_REGISTRY.get(opt['model_type'])(opt)
    get_root_logger().info(f'Model [{model.__class__.__name__}] is created.')
    return model
