"""SR engine (reference: basicsr/models/sr_model.py), the counterpart of
``edvr_tpu/models/sr_model.py``: builds the network from ``network_g`` on
the engine's device, loads its pretrained weights, scores images from the
test CLI or at ``val_freq`` (PSNR/SSIM tables, result images) and, when
training, takes Adam steps on a pixel and/or perceptual loss.

Parity with the JAX step: optax's ``add_decayed_weights`` then
``scale_by_adam`` then ``p - lr * u`` is ``torch.optim.Adam`` with
``weight_decay`` (L2 added to the gradient); a per-parameter lr multiplier
is a param group's ``lr_mul``; a frozen parameter's gradient is multiplied
by 0, not dropped, so Adam's step count stays shared by every parameter.

``train.mixed_precision: bf16`` is the JAX step's policy
(``edvr_tpu/models/sr_model.py:148-170``), not ``torch.autocast``: one
``torch.func.functional_call`` of ``net_g`` with bf16 copies of every
parameter (``p.to(torch.bfloat16)``, so the gradients flow back through
the cast into the f32 parameters) on a bf16 input; the output cast to f32
and the loss taken in f32; f32 master parameters, ``.grad`` and Adam
state, with no loss scaling (bf16 keeps f32's exponent range). Validation
runs ``net_g`` itself, in f32.

In a multi-process run (``--launcher pytorch``) every rank starts from
rank 0's networks (``parallel.replicate_tree``), and a step's gradients
are averaged over the ranks after ``backward``, before the frozen ones are
masked and Adam reads them (``parallel.average_gradients``), as the JAX
step's gradient over the sharded global batch. Image-SR validation runs
whole on every rank, as the JAX engine's does; rank 0 logs it.
"""

from __future__ import annotations

from copy import deepcopy
from os import path as osp

import torch

from edvr_tpu_torch.archs import define_network
from edvr_tpu_torch.metrics import calculate_metric
from edvr_tpu_torch.models.base_model import BaseModel
from edvr_tpu_torch.models.losses import build_loss
from edvr_tpu_torch.parallel import average_gradients
from edvr_tpu_torch.utils import get_root_logger, imwrite, tensor2img
from edvr_tpu_torch.utils.registry import MODEL_REGISTRY

# train.mixed_precision values and the dtype each computes the network in
MIXED_PRECISION = {None: None, 'bf16': torch.bfloat16}


@MODEL_REGISTRY.register()
class SRModel(BaseModel):

    def __init__(self, opt):
        super().__init__(opt)
        # checked for any config that carries a train block, as the JAX
        # engine does (edvr_tpu/models/sr_model.py:34-40)
        mp = (opt.get('train') or {}).get('mixed_precision')
        if mp not in MIXED_PRECISION:
            raise NotImplementedError(
                f'mixed_precision {mp!r} is not supported (bf16 only).')
        self.compute_dtype = MIXED_PRECISION[mp]
        self.net_g = self.build_network('g', opt.get('manual_seed') or 0)
        if self.is_train:
            self.net_g.train()
            self.init_training_settings()
        else:
            self.net_g.eval()
        self.replicate_networks()

    def build_network(self, suffix, seed):
        """``network_<suffix>`` on the engine's device, its parameters
        drawn from ``seed`` on the CPU without touching the caller's global
        generator, then ``pretrain_network_<suffix>`` loaded if set."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = define_network(deepcopy(self.opt[f'network_{suffix}']))
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

    def build_losses(self):
        """The pixel and perceptual losses of the ``train`` block, each None
        where it is not set."""
        train_opt = self.opt['train']
        self.cri_pix = build_loss(train_opt['pixel_opt']) if train_opt.get(
            'pixel_opt') else None
        self.cri_perceptual = None
        if train_opt.get('perceptual_opt'):
            self.cri_perceptual = build_loss(
                train_opt['perceptual_opt']).to(self.device)

    def init_training_settings(self):
        self.build_losses()
        if self.cri_pix is None and self.cri_perceptual is None:
            raise ValueError('Both pixel and perceptual losses are None.')
        self.setup_optimizers()
        self.setup_schedulers()

    def _param_groups(self):
        """The optimizer's param groups, each with an lr multiplier."""
        return [dict(params=list(self.net_g.parameters()), lr_mul=1.0)]

    def setup_optimizers(self):
        optim_opt = dict(self.opt['train']['optim_g'])
        optim_type = optim_opt.pop('type')
        if optim_type != 'Adam':
            raise NotImplementedError(
                f'optimizer {optim_type} is not supported yet.')
        self.optimizer_g = self.optimizers['optimizer_g'] = torch.optim.Adam(
            self._param_groups(), lr=optim_opt.pop('lr'),
            betas=tuple(optim_opt.pop('betas', (0.9, 0.999))),
            eps=optim_opt.pop('eps', 1e-8),
            weight_decay=optim_opt.pop('weight_decay', 0))

    def _mask_gradients(self, current_iter):
        """Multiply frozen parameters' gradients by 0 (none here)."""

    def feed_data(self, data):
        self.lq = data['lq'].to(self.device, torch.float32)
        if 'gt' in data:
            self.gt = data['gt'].to(self.device, torch.float32)

    def train_forward(self, lq):
        """``net_g`` on ``lq`` under the mixed-precision policy: in fp32, or
        in ``compute_dtype`` through bf16 copies of the parameters, the
        output cast back to f32."""
        if self.compute_dtype is None:
            return self.net_g(lq)
        dt = self.compute_dtype
        params = {n: p.to(dt) for n, p in self.net_g.named_parameters()}
        buffers = {n: b.to(dt) if b.is_floating_point() else b
                   for n, b in self.net_g.named_buffers()}
        out = torch.func.functional_call(self.net_g, (params, buffers),
                                         (lq.to(dt),))
        return out.float()

    def content_losses(self, output, tag=''):
        """The pixel, perceptual and style losses of ``output`` against
        ``gt`` (those configured), as ``{f'l_{tag}pix': ..., ...}``."""
        losses = {}
        if self.cri_pix is not None:
            losses[f'l_{tag}pix'] = self.cri_pix(output, self.gt)
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(output, self.gt)
            if l_percep is not None:
                losses[f'l_{tag}percep'] = l_percep
            if l_style is not None:
                losses[f'l_{tag}style'] = l_style
        return losses

    def optimize_parameters(self, current_iter):
        """One step; the losses are taken on the f32 output, under bf16 too
        (``edvr_tpu/models/sr_model.py:171-185``)."""
        self.optimizer_g.zero_grad()
        self.output = self.train_forward(self.lq)
        losses = self.content_losses(self.output)
        sum(losses.values()).backward()
        self.log_dict = {k: v.detach() for k, v in losses.items()}
        self.step_optimizers(current_iter)

    def step_optimizers(self, current_iter):
        """Apply the gradients held in ``.grad`` at ``current_iter``: their
        mean over the ranks, the scheduled lr, frozen gradients multiplied
        by 0, one Adam step."""
        self.update_learning_rate(current_iter)
        average_gradients(self.net_g.parameters())
        self._mask_gradients(current_iter)
        self.optimizer_g.step()

    def test(self):
        """``net_g`` on ``lq`` in eval mode without autograd (reference:
        sr_model.py:112-117; ``edvr_tpu/models/sr_model.py:222-224``)."""
        self.net_g.eval()
        with torch.no_grad():
            self.output = self.net_g(self.lq)
        if self.is_train:
            self.net_g.train()

    def get_current_visuals(self):
        """lq, result and (when fed) gt, on the CPU (reference:
        sr_model.py:186-192)."""
        out = {'lq': self.lq.detach().cpu(),
               'result': self.output.detach().cpu()}
        if hasattr(self, 'gt'):
            out['gt'] = self.gt.detach().cpu()
        return out

    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img):
        get_root_logger().info('Only support single process validation.')
        self.nondist_validation(dataloader, current_iter, tb_logger,
                                save_img)

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """Score each image of the (batch-1) loader and write its result
        (reference: sr_model.py:125-184;
        ``edvr_tpu/models/sr_model.py:236-305``)."""
        dataset_name = dataloader.dataset.opt['name']
        metrics = self.opt['val'].get('metrics')
        if metrics is not None:
            self.metric_results = {name: 0 for name in metrics}
        cnt = 0
        for val_data in dataloader:
            img_name = osp.splitext(osp.basename(val_data['lq_path'][0]))[0]
            self.feed_data(val_data)
            self.test()
            visuals = self.get_current_visuals()
            metric_data = {'img1': tensor2img([visuals['result']])}
            if 'gt' in visuals:
                metric_data['img2'] = tensor2img([visuals['gt']])
                del self.gt
            del self.lq, self.output

            if save_img:
                vis = self.opt['path']['visualization']
                if self.opt['is_train']:
                    save_path = osp.join(vis, img_name,
                                         f'{img_name}_{current_iter}.png')
                else:
                    suffix = self.opt['val'].get('suffix') or \
                        self.opt['name']
                    save_path = osp.join(vis, dataset_name,
                                         f'{img_name}_{suffix}.png')
                imwrite(metric_data['img1'], save_path)
            if metrics is not None:
                for name, opt_ in deepcopy(metrics).items():
                    self.metric_results[name] += calculate_metric(
                        metric_data, opt_)
            cnt += 1
        if metrics is not None:
            for name in self.metric_results:
                self.metric_results[name] /= cnt
            self._log_validation_metric_values(current_iter, dataset_name,
                                               tb_logger)

    def _log_validation_metric_values(self, current_iter, dataset_name,
                                      tb_logger=None):
        # current_iter is an int while training, a label under the test CLI
        log_str = f'Validation {dataset_name} (iter {current_iter})\n'
        for metric, value in self.metric_results.items():
            log_str += f'\t # {metric}: {value:.4f}\n'
        get_root_logger().info(log_str)
        if tb_logger is not None:
            for metric, value in self.metric_results.items():
                tb_logger.add_scalar(f'metrics/{metric}', value,
                                     current_iter)

    def save(self, epoch, current_iter):
        self.save_network(self.net_g, 'net_g', current_iter)
        self.save_training_state(epoch, current_iter)
