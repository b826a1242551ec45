"""EDVR engine (reference: basicsr/models/edvr_model.py). Its additions
over the video engine (the DCN learning-rate multiplier and the TSA
warm-up) are training-only, which is not ported yet; evaluation is the
video engine's."""

from __future__ import annotations

from edvr_tpu_torch.models.video_base_model import VideoBaseModel
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class EDVRModel(VideoBaseModel):
    pass
