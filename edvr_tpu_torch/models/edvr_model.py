"""EDVR engine (reference: basicsr/models/edvr_model.py), the counterpart
of ``edvr_tpu/models/edvr_model.py``: the DCN learning-rate multiplier
(``train.dcn_lr_mul``, a param group of the parameters named ``*dcn*``)
and the TSA warm-up (``train.tsa_iter``: strictly before it only
``fusion.*`` learns). Evaluation is the video engine's.

During the warm-up the other parameters' gradients are multiplied by 0
after the full backward, as the JAX step masks them: they keep
``requires_grad`` and a zero gradient, so ``torch.optim.Adam`` still
counts a step for them and its bias correction after the unfreeze uses
the global count, as optax's shared count does.
"""

from __future__ import annotations

from edvr_tpu_torch.models.video_base_model import VideoBaseModel
from edvr_tpu_torch.utils import get_root_logger
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class EDVRModel(VideoBaseModel):

    def _param_groups(self):
        dcn_lr_mul = self.opt['train'].get('dcn_lr_mul', 1)
        get_root_logger().info(
            f'Multiple the learning rate for dcn with {dcn_lr_mul}.')
        if dcn_lr_mul == 1:
            return super()._param_groups()
        normal, dcn = [], []
        for name, param in self.net_g.named_parameters():
            (dcn if 'dcn' in name else normal).append(param)
        return [dict(params=normal, lr_mul=1.0),
                dict(params=dcn, lr_mul=dcn_lr_mul)]

    def init_training_settings(self):
        tsa_iter = self.opt['train'].get('tsa_iter')
        if tsa_iter:
            get_root_logger().info(
                f'Only train TSA module for the first {tsa_iter} iters.')
        super().init_training_settings()

    def _mask_gradients(self, current_iter):
        tsa_iter = self.opt['train'].get('tsa_iter')
        if not tsa_iter:
            return
        if current_iter == tsa_iter:
            get_root_logger().warning('Train all the parameters.')
        if current_iter < tsa_iter:
            for name, param in self.net_g.named_parameters():
                if 'fusion' not in name and param.grad is not None:
                    param.grad.zero_()
