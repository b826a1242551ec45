"""ESRGAN engine: the relativistic average GAN (reference:
basicsr/models/esrgan_model.py:40-88), the counterpart of
``edvr_tpu/models/esrgan_model.py``. The G step reads D on gt (detached,
its BatchNorm update thrown away); each D term detaches the opposing
mean."""

from __future__ import annotations

from edvr_tpu_torch.models.srgan_model import SRGANModel
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class ESRGANModel(SRGANModel):

    g_gan_needs_real = True

    def g_gan_loss(self, d_fake, d_real):
        l_g_real = self.cri_gan(d_real - d_fake.mean(), False, is_disc=False)
        l_g_fake = self.cri_gan(d_fake - d_real.mean(), True, is_disc=False)
        return (l_g_real + l_g_fake) / 2

    def d_losses(self, d_real, d_fake):
        l_d_real = self.cri_gan(d_real - d_fake.detach().mean(), True,
                                is_disc=True) * 0.5
        l_d_fake = self.cri_gan(d_fake - d_real.detach().mean(), False,
                                is_disc=True) * 0.5
        return l_d_real, l_d_fake
