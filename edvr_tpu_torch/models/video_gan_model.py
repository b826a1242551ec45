"""Video GAN engine (reference: basicsr/models/video_gan_model.py:5-15), the
counterpart of ``edvr_tpu/models/video_gan_model.py``: SRGAN's training
step and VideoBaseModel's validation, composed through the MRO."""

from __future__ import annotations

from edvr_tpu_torch.models.srgan_model import SRGANModel
from edvr_tpu_torch.models.video_base_model import VideoBaseModel
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class VideoGANModel(SRGANModel, VideoBaseModel):
    """EDVR-M's GAN fine-tuning (``train_EDVRM_VideoGAN_REDS.yml``)."""
