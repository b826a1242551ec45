"""StyleGAN2 engine (reference: basicsr/models/stylegan2_model.py), the
counterpart of ``edvr_tpu/models/stylegan2_model.py``, whose step it keeps:

* each iteration: the D step (the GAN loss on G's detached output and on
  the real batch), then R1 on the real batch when ``iter %
  net_d_reg_every == 0``, then the G step with D frozen, then path-length
  regularisation at ``batch // path_batch_shrink`` when ``iter %
  net_g_reg_every == 0``; then the EMA of G's parameters (decay ``0.5 **
  (32 / 10000)``; the buffers, zero stored noises, are not averaged);
* R1 weighs ``r1_reg_weight / 2 * net_d_reg_every``, the path loss
  ``path_reg_weight * net_g_reg_every``; the mean path length moves by
  ``0.01 * (mean - old)`` and is detached;
* lazy-regularisation Adam, one param group a network: lr ``x
  reg_every / (reg_every + 1)``, betas ``(0 ** ratio, 0.99 ** ratio)``, eps
  1e-8, under the YAML's schedule;
* the latents, the mixing decision, ``inject_index`` and the path noise are
  drawn from ``np.random.RandomState(manual_seed + 7)`` in the JAX engine's
  order (the validation samples first), so the two engines draw the same;
  the mixed latent is ``where(mix & pos >= inject, lat2, lat1)``. The
  generator's injected noise comes from its own ``torch.Generator``
  (``noise_seed`` ``manual_seed + 11``), which JAX's keys cannot reproduce.

Validation writes one grid of ``num_val_samples`` fixed samples from the
EMA generator. ``net_g_<iter>.pth`` holds ``params`` and ``params_ema``.
``train.mixed_precision`` is refused, as the JAX engine refuses it.

In a multi-process run every rank draws the global batch's codes and path
noise from the same generator and takes its own rows
(``parallel.shard_batch``), the injected noise comes from a generator
seeded apart for each rank, every Adam step (D, R1, G, path length) reads
gradients averaged over the ranks, and the path length's mean is the
global batch's (``losses.g_path_regularize``). Rank 0 samples the
validation grid, logs it to TensorBoard and writes the checkpoints
(``edvr_tpu/models/stylegan2_model.py:321-345``).
"""

from __future__ import annotations

import os
from copy import deepcopy
from os import path as osp

import numpy as np
import torch

from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.models.base_model import BaseModel
from edvr_tpu_torch.models.losses import (build_loss, g_path_regularize,
                                          r1_penalty)
from edvr_tpu_torch.parallel import (average_gradients, get_dist_info,
                                     master_only, shard_batch)
from edvr_tpu_torch.utils import get_root_logger, imwrite, tensor2img
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY

EMA_DECAY = 0.5**(32 / (10 * 1000))


@MODEL_REGISTRY.register()
class StyleGAN2Model(BaseModel):

    def __init__(self, opt):
        super().__init__(opt)
        seed = opt.get('manual_seed') or 0
        rank, self.world_size = get_dist_info()
        # each rank draws its own samples' injected noise
        self.net_g = self.build_network('g', seed,
                                        noise_seed=seed + 11 + 1000 * rank)
        self.rng = np.random.RandomState(seed + 7)
        self.num_style_feat = opt['network_g']['num_style_feat']
        num_val_samples = (opt.get('val') or {}).get('num_val_samples', 16)
        self.fixed_sample = torch.from_numpy(self.rng.randn(
            num_val_samples, self.num_style_feat).astype(np.float32)).to(
                self.device)
        if self.is_train:
            self.init_training_settings()
        self.replicate_networks()

    def build_network(self, suffix, seed, **extra):
        """``network_<suffix>`` on the engine's device, its parameters drawn
        from ``seed`` on the CPU without touching the caller's global
        generator, then ``pretrain_network_<suffix>`` loaded if set."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = define_network({**self.opt[f'network_{suffix}'], **extra})
        n = sum(p.numel() for p in net.parameters())
        get_root_logger().info(
            f'Network: {net.__class__.__name__}, with parameters: {n:,d}')
        path_opt = self.opt['path']
        load_path = path_opt.get(f'pretrain_network_{suffix}')
        if load_path is not None:
            self.load_network(net, load_path,
                              path_opt.get(f'strict_load_{suffix}', True),
                              path_opt.get(f'param_key_{suffix}', 'params'))
        return net.to(self.device)

    def init_training_settings(self):
        opt = self.opt
        train_opt = opt['train']
        if train_opt.get('mixed_precision'):
            raise NotImplementedError(
                'mixed_precision is only supported by the SRModel-step '
                'family (SRModel/VideoBaseModel/EDVRModel).')
        self.net_g.train()
        self.net_d = self.build_network(
            'd', (opt.get('manual_seed') or 0) + 1).train()
        # the EMA copy (reference: stylegan2_model.py:60-72)
        self.net_g_ema = deepcopy(self.net_g).eval()
        self.net_g_ema.requires_grad_(False)
        load_path = opt['path'].get('pretrain_network_g')
        if load_path is not None:
            self.load_network(self.net_g_ema, load_path,
                              opt['path'].get('strict_load_g', True),
                              'params_ema')

        self.cri_gan = build_loss(train_opt['gan_opt'])
        self.r1_reg_weight = train_opt['r1_reg_weight']
        self.path_reg_weight = train_opt['path_reg_weight']
        self.net_g_reg_every = train_opt['net_g_reg_every']
        self.net_d_reg_every = train_opt['net_d_reg_every']
        self.mixing_prob = train_opt['mixing_prob']
        self.path_batch_shrink = train_opt.get('path_batch_shrink', 2)
        self.mean_path_length = torch.zeros((), device=self.device)
        self.setup_optimizers()
        self.setup_schedulers()

    def setup_optimizers(self):
        """Lazy-regularisation Adam (reference: stylegan2_model.py:96-185;
        ``edvr_tpu/models/stylegan2_model.py:111-123``)."""
        train_opt = self.opt['train']
        for name, net, every in (('g', self.net_g, self.net_g_reg_every),
                                 ('d', self.net_d, self.net_d_reg_every)):
            optim_opt = train_opt[f'optim_{name}']
            if optim_opt['type'] != 'Adam':
                raise NotImplementedError(
                    f"optimizer {optim_opt['type']} is not supported yet.")
            ratio = every / (every + 1)
            self.optimizers[f'optimizer_{name}'] = torch.optim.Adam(
                [dict(params=list(net.parameters()), lr_mul=1.0)],
                lr=optim_opt['lr'] * ratio,
                betas=(0**ratio, 0.99**ratio), eps=1e-8)
        self.optimizer_g = self.optimizers['optimizer_g']
        self.optimizer_d = self.optimizers['optimizer_d']

    def feed_data(self, data):
        self.real_img = data['gt'].to(self.device, torch.float32)

    def mixing_args(self, batch):
        """Two code batches of ``batch`` rows, whether to mix them and where
        (the JAX engine's draws, in its order, for the global batch of
        ``batch`` x the world size; this rank's rows)."""
        rows = batch * self.world_size
        n1 = self.rng.randn(rows, self.num_style_feat).astype(np.float32)
        n2 = self.rng.randn(rows, self.num_style_feat).astype(np.float32)
        mix = bool(self.rng.rand() < self.mixing_prob)
        num_latent = self.net_g.num_latent
        inject = self.rng.randint(1, num_latent - 1) if mix else num_latent
        return (shard_batch(torch.from_numpy(n1)).to(self.device),
                shard_batch(torch.from_numpy(n2)).to(self.device), mix,
                inject)

    def g_forward(self, n1, n2, mix, inject, return_latents=False):
        """G's output on the codes, mixed at ``inject`` when ``mix``: the
        latent is ``where(mix & pos >= inject, lat2, lat1)``
        (``edvr_tpu/models/stylegan2_model.py:142-158``); the injected
        noise is drawn."""
        num_latent = self.net_g.num_latent
        s1 = self.net_g.style_mlp(n1)
        latent = s1[:, None].repeat(1, num_latent, 1)
        if mix:
            s2 = self.net_g.style_mlp(n2)
            pos = torch.arange(num_latent, device=self.device)[None, :, None]
            latent = torch.where(pos >= inject, s2[:, None], latent)
        img, _ = self.net_g([latent], input_is_latent=True)
        return (img, latent) if return_latents else img

    def optimize_parameters(self, current_iter):
        self.update_learning_rate(current_iter)
        batch = self.real_img.shape[0]
        losses = {}

        # ---- D ----
        with torch.no_grad():
            fake_img = self.g_forward(*self.mixing_args(batch))
        self.optimizer_d.zero_grad(set_to_none=True)
        fake_pred = self.net_d(fake_img)
        real_pred = self.net_d(self.real_img)
        l_d = (self.cri_gan(real_pred, True, is_disc=True)
               + self.cri_gan(fake_pred, False, is_disc=True))
        l_d.backward()
        self.step(self.optimizer_d)
        losses.update(l_d=l_d, real_score=real_pred.mean(),
                      fake_score=fake_pred.mean())

        if current_iter % self.net_d_reg_every == 0:
            self.optimizer_d.zero_grad(set_to_none=True)
            real_img = self.real_img.detach().requires_grad_(True)
            l_d_r1 = (self.r1_reg_weight / 2 * r1_penalty(
                self.net_d(real_img), real_img) * self.net_d_reg_every)
            l_d_r1.backward()
            self.step(self.optimizer_d)
            losses['l_d_r1'] = l_d_r1

        # ---- G (D frozen) ----
        self.net_d.requires_grad_(False)
        self.optimizer_g.zero_grad(set_to_none=True)
        fake_img = self.g_forward(*self.mixing_args(batch))
        l_g = self.cri_gan(self.net_d(fake_img), True, is_disc=False)
        l_g.backward()
        self.step(self.optimizer_g)
        losses['l_g'] = l_g

        if current_iter % self.net_g_reg_every == 0:
            path_batch = max(1, batch // self.path_batch_shrink)
            args = self.mixing_args(path_batch)
            size = self.opt['network_g']['out_size']
            # drawn NHWC as the JAX engine draws it, over sqrt(h * w)
            noise = self.rng.randn(path_batch * self.world_size, size, size,
                                   3).astype(np.float32) / np.float32(size)
            noise = shard_batch(torch.from_numpy(
                noise.transpose(0, 3, 1, 2).copy())).to(self.device)
            self.optimizer_g.zero_grad(set_to_none=True)
            fake_img, latents = self.g_forward(*args, return_latents=True)
            l_path, path_length, self.mean_path_length = g_path_regularize(
                fake_img, latents, noise, self.mean_path_length)
            l_g_path = self.path_reg_weight * self.net_g_reg_every * l_path
            l_g_path.backward()
            self.step(self.optimizer_g)
            losses.update(l_g_path=l_g_path, path_length=path_length)
        self.net_d.requires_grad_(True)

        self.log_dict = {k: v.detach() for k, v in losses.items()}
        self.model_ema(EMA_DECAY)

    @staticmethod
    def step(optimizer):
        """An Adam step of every parameter on its gradient averaged over
        the ranks: one the loss does not reach (R1 and the path length miss
        the last biases) steps with a zero gradient, as in the JAX engine,
        so its moments decay and its step count stays the optimizer's."""
        params = [p for group in optimizer.param_groups
                  for p in group['params']]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        average_gradients(params)
        optimizer.step()

    @torch.no_grad()
    def model_ema(self, decay):
        """ema = ema * decay + g * (1 - decay), parameters only."""
        for p_ema, p in zip(self.net_g_ema.parameters(),
                            self.net_g.parameters()):
            p_ema.mul_(decay).add_(p, alpha=1 - decay)

    # ------------------------------------------------------------------ #
    def test(self):
        with torch.no_grad():
            net = getattr(self, 'net_g_ema', self.net_g)
            self.output, _ = net([self.fixed_sample])

    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img):
        """Rank 0's grid (``edvr_tpu/models/stylegan2_model.py:321-325``)."""
        if get_dist_info()[0] == 0:
            self.nondist_validation(dataloader, current_iter, tb_logger,
                                    save_img)

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """One grid PNG of the fixed samples, and TensorBoard's
        ``samples`` image (reference: stylegan2_model.py:313-335)."""
        assert dataloader is None, 'Validation dataloader should be None.'
        self.test()
        result = tensor2img(self.output, min_max=(-1, 1))
        if self.opt['is_train']:
            save_img_path = osp.join(self.opt['path']['visualization'],
                                     'train', f'train_{current_iter}.png')
        else:
            save_img_path = osp.join(self.opt['path']['visualization'],
                                     'test', f'test_{self.opt["name"]}.png')
        imwrite(result, save_img_path)
        if tb_logger is not None:
            rgb = np.ascontiguousarray(result[..., ::-1] / 255.,
                                       dtype=np.float32)
            tb_logger.add_image('samples', rgb, global_step=current_iter,
                                dataformats='HWC')

    @master_only
    def save(self, epoch, current_iter):
        """``net_g_<iter>.pth`` with ``params`` and ``params_ema``, then
        ``net_d`` and the training state, on rank 0."""
        label = 'latest' if current_iter == -1 else current_iter
        path = osp.join(self.opt['path']['models'], f'net_g_{label}.pth')
        os.makedirs(osp.dirname(path), exist_ok=True)
        cpu = lambda net: {k: v.detach().cpu()  # noqa: E731
                           for k, v in net.state_dict().items()}
        torch.save({'params': cpu(self.net_g),
                    'params_ema': cpu(self.net_g_ema)}, path)
        self.save_network(self.net_d, 'net_d', current_iter)
        self.save_training_state(epoch, current_iter)
