"""SRGAN engine (reference: basicsr/models/srgan_model.py), the counterpart
of ``edvr_tpu/models/srgan_model.py``, whose step it keeps where it differs
from BasicSR's:

* G steps only when ``current_iter % net_d_iters == 0 and current_iter >
  net_d_init_iters``; otherwise G's parameters and its Adam state stay as
  they were, and the G losses are still computed for the log (without
  autograd) from the same forward;
* D always trains, on gt and on the G forward's (pre-update) output,
  detached;
* D's BatchNorm statistics advance in the order G-step fake, D real, D
  fake; the G-step forward's update counts only when G stepped
  (``archs/discriminator_arch.py::frozen_running_stats``), flax's update
  rule (``BatchNorm2d``).

The discriminator trains its BatchNorm layers in training mode, as
BasicSR's does and the JAX engine's docstring describes. The JAX engine
as shipped builds ``VGGStyleDiscriminator128`` with its ``train`` field
False, so its BatchNorm normalises by the running statistics and never
moves them; the CPU tests hold this engine against the JAX engine built
with ``network_d.train: true``.

Two ``torch.optim.Adam`` (``optim_g``, ``optim_d``; weight decay as the
SR engine maps it) with a schedule each. ``train.mixed_precision`` is
refused, as the JAX engine refuses it.

In a multi-process run G's and D's gradients are each averaged over the
ranks before their Adam step, and D's BatchNorm layers take their batch
moments over the global batch (``arch_util.FlaxBatchNorm``), as the JAX
step over the sharded batch does; their running statistics then agree on
every rank.
"""

from __future__ import annotations

import contextlib

import torch

from edvr_tpu_torch.archs.discriminator_arch import frozen_running_stats
from edvr_tpu_torch.models.losses import build_loss
from edvr_tpu_torch.models.sr_model import SRModel
from edvr_tpu_torch.parallel import average_gradients
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY


def make_adam(params, optim_opt):
    """``torch.optim.Adam`` from an ``optim_*`` block (``type: Adam``)."""
    optim_opt = dict(optim_opt)
    optim_type = optim_opt.pop('type')
    if optim_type != 'Adam':
        raise NotImplementedError(
            f'optimizer {optim_type} is not supported yet.')
    return torch.optim.Adam(
        params, lr=optim_opt.pop('lr'),
        betas=tuple(optim_opt.pop('betas', (0.9, 0.999))),
        eps=optim_opt.pop('eps', 1e-8),
        weight_decay=optim_opt.pop('weight_decay', 0))


@MODEL_REGISTRY.register()
class SRGANModel(SRModel):

    # ESRGAN's G loss reads D on gt too
    g_gan_needs_real = False

    def init_training_settings(self):
        train_opt = self.opt['train']
        if train_opt.get('mixed_precision'):
            raise NotImplementedError(
                'mixed_precision is only supported by the SRModel-step '
                'family (SRModel/VideoBaseModel/EDVRModel).')
        self.net_d = self.build_network(
            'd', (self.opt.get('manual_seed') or 0) + 1).train()
        self.build_losses()
        self.cri_gan = build_loss(train_opt['gan_opt']) if train_opt.get(
            'gan_opt') else None
        self.net_d_iters = train_opt.get('net_d_iters', 1)
        self.net_d_init_iters = train_opt.get('net_d_init_iters', 0)
        self.setup_optimizers()
        self.setup_schedulers()

    def setup_optimizers(self):
        train_opt = self.opt['train']
        self.optimizer_g = self.optimizers['optimizer_g'] = make_adam(
            [dict(params=list(self.net_g.parameters()), lr_mul=1.0)],
            train_opt['optim_g'])
        self.optimizer_d = self.optimizers['optimizer_d'] = make_adam(
            [dict(params=list(self.net_d.parameters()), lr_mul=1.0)],
            train_opt['optim_d'])

    # the GAN formulation (ESRGAN overrides both) ------------------------ #
    def g_gan_loss(self, d_fake, d_real):
        """(reference: srgan_model.py:108-111)"""
        return self.cri_gan(d_fake, True, is_disc=False)

    def d_losses(self, d_real, d_fake):
        """(reference: srgan_model.py:122-133)"""
        return (self.cri_gan(d_real, True, is_disc=True),
                self.cri_gan(d_fake, False, is_disc=True))

    def optimize_parameters(self, current_iter):
        do_g = (current_iter % self.net_d_iters == 0
                and current_iter > self.net_d_init_iters)
        self.update_learning_rate(current_iter)

        # ---- generator (D frozen) ----
        self.net_d.requires_grad_(False)
        self.optimizer_g.zero_grad()
        with contextlib.ExitStack() as stack:
            if not do_g:  # the log's G losses only
                stack.enter_context(torch.no_grad())
                stack.enter_context(frozen_running_stats(self.net_d))
            self.output = self.net_g(self.lq)
            losses = self.content_losses(self.output, 'g_')
            d_real = None
            if self.g_gan_needs_real:
                # D on gt: its BatchNorm update is thrown away
                with torch.no_grad(), frozen_running_stats(self.net_d):
                    d_real = self.net_d(self.gt)
            d_fake = self.net_d(self.output)
            losses['l_g_gan'] = self.g_gan_loss(d_fake, d_real)
        if do_g:
            sum(losses.values()).backward()
            average_gradients(self.net_g.parameters())
            self.optimizer_g.step()

        # ---- discriminator ----
        self.net_d.requires_grad_(True)
        self.optimizer_d.zero_grad()
        d_real = self.net_d(self.gt)
        d_fake = self.net_d(self.output.detach())
        l_d_real, l_d_fake = self.d_losses(d_real, d_fake)
        (l_d_real + l_d_fake).backward()
        average_gradients(self.net_d.parameters())
        self.optimizer_d.step()

        losses.update(l_d_real=l_d_real, l_d_fake=l_d_fake,
                      out_d_real=d_real.mean(), out_d_fake=d_fake.mean())
        self.log_dict = {k: v.detach() for k, v in losses.items()}

    def save(self, epoch, current_iter):
        self.save_network(self.net_g, 'net_g', current_iter)
        self.save_network(self.net_d, 'net_d', current_iter)
        self.save_training_state(epoch, current_iter)
