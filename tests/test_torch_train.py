"""The port's training slice against the JAX package, on the CPU:
losses, learning-rate schedules, the optimizer (Adam, ``dcn_lr_mul`` and
the TSA warm-up), the engine's refusals and checkpoints, and
``python -m edvr_tpu_torch.train --device cpu`` end to end on a synthetic
REDS tree, with a resume. The step's gradients are held against JAX in
tests/test_torch_grad.py.
"""

import glob
import os
import os.path as osp
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from edvr_tpu.models import losses as jlosses
from edvr_tpu.models import lr_scheduler as jsched
from edvr_tpu.models.edvr_model import EDVRModel as JaxEDVRModel
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.models import create_model, losses, lr_scheduler
from edvr_tpu_torch.utils.options import parse_dict
from test_torch_grad import seeded_jax_params, train_opt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.mark.parametrize('name', ['L1Loss', 'MSELoss', 'CharbonnierLoss'])
@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
def test_losses_match_jax(name, reduction):
    rng = np.random.RandomState(0)
    pred, target, weight = (rng.rand(2, 3, 8, 8).astype(np.float32)
                            for _ in range(3))
    opt = dict(type=name, loss_weight=0.7, reduction=reduction)
    ours, ref = losses.build_loss(opt), jlosses.build_loss(opt)
    for w in (None, weight):
        got = ours(torch.from_numpy(pred), torch.from_numpy(target),
                   None if w is None else torch.from_numpy(w))
        want = ref(jnp.asarray(pred), jnp.asarray(target),
                   None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.build_loss(dict(type=name, reduction='median'))


@pytest.mark.parametrize('train', [
    dict(scheduler=dict(type='MultiStepRestartLR', milestones=[3, 6, 12],
                        gamma=0.5, restarts=[0, 8],
                        restart_weights=[1, 0.5])),
    dict(scheduler=dict(type='MultiStepLR', milestones=[2, 5], gamma=0.1)),
    dict(scheduler=dict(type='CosineAnnealingRestartLR', periods=[5, 4, 6],
                        restart_weights=[1, 0.5, 0.25], eta_min=1e-7)),
    dict(scheduler=dict(type='CosineAnnealingRestartLR', periods=[10],
                        restart_weights=[1], eta_min=1e-7), warmup_iter=4),
    dict(scheduler=None, warmup_iter=3),
])
def test_schedules_match_jax(train):
    ours = lr_scheduler.build_schedule(train, 4e-4)
    ref = jsched.build_schedule(train, 4e-4)
    for it in range(0, 20):
        assert ours(it) == pytest.approx(ref(it), rel=1e-12, abs=0), it


def test_optimizer_matches_jax_engine():
    """The same gradients into both engines' optimizers over steps that
    span ``tsa_iter``, with ``dcn_lr_mul`` != 1, weight decay, warm-up and
    a restart: the parameters agree within 1e-6 at every step. The JAX
    side is the JAX engine's own optimizer, schedule, multipliers and
    mask, combined as its train step combines them
    (edvr_tpu/models/sr_model.py:182-209). Dropping the frozen gradients
    instead of zeroing them (Adam's per-parameter step count then lags)
    breaks the agreement."""
    _, params = seeded_jax_params(2)
    train = dict(optim_g=dict(type='Adam', lr=4e-4, weight_decay=1e-3,
                              betas=[0.9, 0.99]),
                 scheduler=dict(type='CosineAnnealingRestartLR',
                                periods=[3, 4], restart_weights=[1, 0.5],
                                eta_min=1e-7),
                 warmup_iter=2, dcn_lr_mul=0.25, tsa_iter=3)
    shell = object.__new__(JaxEDVRModel)
    shell.opt = train_opt(**train)
    shell.params_g, shell.schedulers = params, {}
    shell.replicate = lambda tree: tree
    shell.setup_optimizers()
    shell.setup_schedulers()
    mult = shell._update_multipliers()
    mask, until = shell._freeze_mask()
    assert mult is not None and until == 3

    def port_model():
        opt = parse_dict(train_opt(**train), is_train=True, root='.')
        opt['device'] = 'cpu'
        model = create_model(opt)
        model.net_g.load_state_dict(jax_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, params)))
        return model

    model, dropped = port_model(), port_model()
    assert [g['lr_mul'] for g in model.optimizer_g.param_groups] == [1.0,
                                                                     0.25]
    @jax.jit
    def jax_step(p_jax, state, grads, lr, warm):
        """The JAX train step after its gradient."""
        g = jax.tree_util.tree_map(lambda g, m: g * (warm * m + 1 - warm),
                                   grads, mask)
        updates, state = shell.tx_g.update(g, state, p_jax)
        updates = jax.tree_util.tree_map(lambda u, m: u * m, updates, mult)
        return jax.tree_util.tree_map(lambda p, u: p - lr * u, p_jax,
                                      updates), state

    state, p_jax = shell.opt_state_g, params
    rng = np.random.RandomState(3)
    for it in range(1, 7):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * 1e-2).astype(np.float32), p_jax)
        lr = jnp.float32(shell.schedulers['optimizer_g'](it))
        p_jax, state = jax_step(p_jax, state, grads, lr,
                                jnp.float32(it < until))
        # the port's engine, given the same gradients
        grad_sd = jax_params_to_state_dict(grads)
        for m in (model, dropped):
            for name, p in m.net_g.named_parameters():
                p.grad = grad_sd[name].clone()
                if m is dropped and it < until and 'fusion' not in name:
                    p.grad = None
            m.step_optimizers(it)
        want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                               p_jax))
        for name, p in model.net_g.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=1e-6, rtol=0, err_msg=(it, name))
        assert model.get_current_learning_rate(it) == pytest.approx(
            [float(lr)])
    err = max((p.detach() - want[n]).abs().max().item()
              for n, p in dropped.net_g.named_parameters())
    assert err > 1e-5


def test_engine_refusals(tmp_path):
    def opt_with(**train):
        opt = parse_dict(train_opt(**train), is_train=True,
                         root=str(tmp_path))
        opt['device'] = 'cpu'
        return opt

    # bf16 is the JAX engine's policy and trains (tests/test_torch_bf16.py);
    # any other value raises, as tests/test_mixed_precision.py holds JAX
    with pytest.raises(NotImplementedError, match='mixed_precision'):
        create_model(opt_with(mixed_precision='fp16'))
    with pytest.raises(NotImplementedError, match='optimizer'):
        create_model(opt_with(optim_g=dict(type='SGD', lr=1e-3)))
    # the perceptual loss is ported: alone it is a valid loss (no refusal)
    model = create_model(opt_with(pixel_opt=None, perceptual_opt=dict(
        type='PerceptualLoss', layer_weights={'conv1_1': 1.0},
        vgg_pretrain_path=str(tmp_path / 'none.pth'))))
    assert model.cri_pix is None and model.cri_perceptual is not None
    with pytest.raises(ValueError, match='losses are None'):
        create_model(opt_with(pixel_opt=None))
    opt = opt_with()
    opt['device'] = None  # the engines default to cuda
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            create_model(opt)


def test_save_and_load_network(tmp_path):
    opt = parse_dict(train_opt(), is_train=True, root=str(tmp_path))
    opt['device'] = 'cpu'
    model = create_model(opt)
    model.save(0, 7)
    path = osp.join(opt['path']['models'], 'net_g_7.pth')
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {'params'}
    opt2 = parse_dict(train_opt(), is_train=False, root=str(tmp_path))
    opt2['device'] = 'cpu'
    opt2['manual_seed'] = 1  # other init: the load must replace it
    opt2['path']['pretrain_network_g'] = path
    loaded = create_model(opt2)
    for (n, a), b in zip(model.net_g.state_dict().items(),
                         loaded.net_g.state_dict().values()):
        assert torch.equal(a, b), n
    state = torch.load(osp.join(opt['path']['training_states'], '7.state'),
                       weights_only=True)
    assert state['epoch'] == 0 and state['iter'] == 7
    assert set(state['optimizers']) == {'optimizer_g'}


def _reds_tree(root):
    """One 100-frame REDS training clip (32x32 GT, 8x8 LQ) and a 6-frame
    validation clip."""
    rng = np.random.RandomState(2)
    for clip in ('001',):
        for sub, size in (('gt', 32), ('lq', 8)):
            os.makedirs(osp.join(root, 'train', sub, clip))
        for i in range(100):
            gt = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
            cv2.imwrite(osp.join(root, 'train', 'gt', clip, f'{i:08d}.png'),
                        gt)
            cv2.imwrite(osp.join(root, 'train', 'lq', clip, f'{i:08d}.png'),
                        cv2.resize(gt, (8, 8), interpolation=cv2.INTER_AREA))
    with open(osp.join(root, 'meta_info.txt'), 'w') as f:
        f.write('001 100 (32,32,3)\n')
    for sub, size in (('gt', 32), ('lq', 8)):
        os.makedirs(osp.join(root, 'val', sub, '000'))
        for i in range(6):
            cv2.imwrite(osp.join(root, 'val', sub, '000', f'{i:08d}.png'),
                        (rng.rand(size, size, 3) * 255).astype(np.uint8))


def _write_train_yml(tmp_path, name='torch_train', **train):
    root = str(tmp_path / 'reds')
    if not osp.exists(root):
        _reds_tree(root)
    opt = train_opt(total_iter=4, tsa_iter=2, mixed_precision='bf16',
                    **train)
    opt['name'] = name
    opt['datasets'] = dict(
        train=dict(name='REDS', type='REDSDataset',
                   dataroot_gt=f'{root}/train/gt',
                   dataroot_lq=f'{root}/train/lq', dataroot_flow=None,
                   meta_info_file=f'{root}/meta_info.txt',
                   val_partition='REDS4', io_backend=dict(type='disk'),
                   num_frame=5, gt_size=32, interval_list=[1],
                   random_reverse=False, use_flip=True, use_rot=True,
                   use_shuffle=True, num_worker_per_gpu=0,
                   batch_size_per_gpu=2, dataset_enlarge_ratio=1,
                   prefetch_mode=None),
        val=dict(name='REDS4', type='VideoTestDataset',
                 dataroot_gt=f'{root}/val/gt', dataroot_lq=f'{root}/val/lq',
                 meta_info_file=None, io_backend=dict(type='disk'),
                 cache_data=False, num_frame=5, padding='reflection_circle'))
    opt['val'] = dict(val_freq=2, save_img=False, metrics=dict(
        psnr=dict(type='calculate_psnr', crop_border=0,
                  test_y_channel=False)))
    opt['logger'] = dict(print_freq=1, save_checkpoint_freq=2,
                         use_tb_logger=False)
    yml = str(tmp_path / f'{name}.yml')
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    return yml


def test_train_main_checkpoints_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from edvr_tpu_torch.train import main
    yml = _write_train_yml(tmp_path)
    fp32 = ['--device', 'cpu', '--force_yml', 'train:mixed_precision=~']
    model = main(['-opt', yml, *fp32])
    exp = tmp_path / 'experiments' / 'torch_train'
    assert sorted(os.listdir(exp / 'models')) == [
        'net_g_2.pth', 'net_g_4.pth', 'net_g_latest.pth']
    assert sorted(os.listdir(exp / 'training_states')) == ['2.state',
                                                           '4.state']
    assert np.isfinite(model.get_current_log()['l_pix'])
    table = model.metric_results['000']
    assert table.shape == (6, 1) and np.isfinite(table).all()
    log = open(glob.glob(str(exp / 'train_torch_train_*.log'))[0]).read()
    assert 'Validation REDS4 (iter 2)' in log and 'l_pix:' in log

    # resume from iteration 2: the run's own net_g_2.pth is loaded, the
    # optimizer's state restored, and iterations 3 and 4 follow
    resumed = main(['-opt', yml, *fp32, 'path:resume_state=' + str(
        exp / 'training_states' / '2.state')])
    assert resumed.opt['path']['pretrain_network_g'].endswith('net_g_2.pth')
    steps = {int(s['step']) for s in
             resumed.optimizer_g.state_dict()['state'].values()}
    assert steps == {4}


def _run_cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get('PYTHONPATH', '')]))
    return subprocess.run([sys.executable, '-m', 'edvr_tpu_torch.train',
                           *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)


def test_train_cli(tmp_path):
    """The CLI on the CPU with the YAML's bf16 overridden to fp32; an
    unknown precision (fp16) refuses; the default device is cuda."""
    yml = _write_train_yml(tmp_path, name='cli')
    proc = _run_cli(tmp_path, '-opt', yml, '--device', 'cpu', '--force_yml',
                    'train:mixed_precision=~', 'train:total_iter=2')
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'End of training' in proc.stderr
    assert osp.exists(tmp_path / 'experiments' / 'cli' / 'models' /
                      'net_g_latest.pth')
    proc = _run_cli(tmp_path, '-opt', yml, '--device', 'cpu', '--force_yml',
                    'train:mixed_precision=fp16')
    assert proc.returncode != 0
    assert "NotImplementedError: mixed_precision 'fp16'" in proc.stderr
    if not torch.cuda.is_available():
        proc = _run_cli(tmp_path, '-opt', yml, '--force_yml',
                        'train:mixed_precision=~')
        assert proc.returncode != 0
        assert 'CUDA is not available' in proc.stderr
