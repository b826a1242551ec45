"""ESRGAN engine: the relativistic average GAN (reference:
basicsr/models/esrgan_model.py:40-88), the counterpart of
``edvr_tpu/models/esrgan_model.py``. The G step reads D on gt (detached,
its BatchNorm update thrown away); each D term detaches the opposing
mean. The opposing means are the global batch's in a multi-process run
(``parallel.data_parallel.global_mean``), as the JAX step's over the
sharded batch."""

from __future__ import annotations

from edvr_tpu_torch.models.srgan_model import SRGANModel
from edvr_tpu_torch.parallel.data_parallel import global_mean
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class ESRGANModel(SRGANModel):

    g_gan_needs_real = True

    def g_gan_loss(self, d_fake, d_real):
        l_g_real = self.cri_gan(d_real - global_mean(d_fake), False,
                                is_disc=False)
        l_g_fake = self.cri_gan(d_fake - global_mean(d_real), True,
                                is_disc=False)
        return (l_g_real + l_g_fake) / 2

    def d_losses(self, d_real, d_fake):
        l_d_real = self.cri_gan(d_real - global_mean(d_fake.detach()), True,
                                is_disc=True) * 0.5
        l_d_fake = self.cri_gan(d_fake - global_mean(d_real.detach()), False,
                                is_disc=True) * 0.5
        return l_d_real, l_d_fake
