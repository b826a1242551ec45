"""The port's bfloat16 path against the JAX package, on the CPU:

* the plain DCNv2 in bf16 against ``band_forward``/``band_backward`` (the
  TPU kernels, run in Pallas interpret mode on the cases of
  tests/test_dcn_band.py cast to bf16), with and without offsets of
  10-25 px, and at w >= 256, where bf16 coordinates would lose the
  fraction;
* the float32 path untouched by the bf16 branch;
* a bf16 EDVR forward that stays bf16 outside the DCN (no op promotes);
* the mixed-precision training step (``train.mixed_precision: bf16``):
  its gradient, before Adam normalizes it away, against the float32
  gradient of the same loss (the port's, and ``jax.grad``'s beside the
  JAX engine's own bf16 gradient); two steps against the JAX engine's,
  from the same seeded parameters, that cross the TSA warm-up with a DCN
  lr multiplier; f32 master parameters and Adam state; other policies
  refused;
* ``python -m edvr_tpu_torch.train`` on the shipped EDVR-M YAML with its
  ``mixed_precision: bf16`` kept, cut in size only.
"""

import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from edvr_tpu.models.edvr_model import EDVRModel as JaxEDVRModel
from edvr_tpu.models.losses import build_loss as jax_build_loss
from edvr_tpu.ops import dcn as jdcn
from edvr_tpu.ops import dcn_band
from edvr_tpu_torch.archs import arch_util, define_network
from edvr_tpu_torch.convert import jax_params_to_state_dict
from edvr_tpu_torch.models import create_model
from edvr_tpu_torch.ops import dcn
from edvr_tpu_torch.utils.options import parse, parse_dict
from test_dcn_band import _case, _run
from test_torch_cuda import (MP_GRAD_TOL, check_mp_grads, grad_gaps,
                             mp_runs)
from test_torch_grad import seeded_jax_params, train_opt
from test_torch_train import _reds_tree
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SHIPPED_YML = osp.join(REPO, 'options', 'train', 'EDVR',
                       'train_EDVR_M_x4_SR_REDS.yml')
# bf16 plain DCN vs the band kernels, relative to each result's largest
# entry: the forward rounds at the same points on both sides and differs
# by the float32 sum order before the bf16 output rounding (one bf16 ulp
# is 2^-8 of a value); the gradients are those
# tests/test_mixed_precision.py:87-119 holds the bf16 band path to
FWD_TOL = 1e-2
GRAD_TOL = 4e-2
# two mixed-precision steps, port vs JAX engine: the loss per element as
# tests/test_mixed_precision.py:59-61 bounds it, and the parameters within
# 4 x lr as :63-68 bound them. Neither sees the gradient: each Adam step
# moves a parameter by about lr whatever its gradient's size, so even a
# negated gradient stays within 4 lr. The gate is the first step's
# gradient against the float32 one (tests/test_torch_cuda.py
# MP_GRAD_TOL, MP_LEAF_COS_MIN: their readings and what a wrong gradient
# reads)
LOSS_TOL = 5e-3
LR = 4e-4
PARAM_TOL = 4 * LR


def _bf16(case):
    return tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in case)


def _port_args(case):
    """The JAX case (NHWC / HWIO, bf16) as the port's NCHW / OIHW bf16
    tensors, the same values."""
    x, off, mask, weight = (torch.from_numpy(np.asarray(a, np.float32))
                            for a in case)
    to = lambda t: t.permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
    return [to(x), to(off), to(mask),
            weight.permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _band_dispatch(fn):
    """Run ``fn`` and check that it went through the band kernels; then
    drop their jit caches, so that a later test in this process which
    counts their traces (tests/test_mixed_precision.py, on a bf16 case of
    the same shapes) traces them again."""
    before = jdcn.DISPATCH_COUNTS['band']
    try:
        out = fn()
    finally:
        dcn_band.band_forward.clear_cache()
        dcn_band.band_backward.clear_cache()
    assert jdcn.DISPATCH_COUNTS['band'] > before, 'band route not taken'
    return out


@pytest.mark.parametrize('seed,big_frac', [(0, 0.0), (1, 0.01), (2, 0.4)])
def test_bf16_plain_forward_matches_band_forward(seed, big_frac):
    case = _bf16(_case(seed, big_frac=big_frac))
    (want,) = _band_dispatch(lambda: _run(case, band=True))
    assert want.dtype == jnp.bfloat16
    dg = case[2].shape[-1] // 9
    got = dcn.modulated_deform_conv(*_port_args(case), None, 1, 1, 1, 1, dg)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert _rel(got, want) <= FWD_TOL, _rel(got, want)


@pytest.mark.parametrize('seed,big_frac', [(3, 0.0), (4, 0.02)])
def test_bf16_plain_grads_match_band_backward(seed, big_frac):
    case = _bf16(_case(seed, big_frac=big_frac))
    wants = _band_dispatch(lambda: _run(case, band=True, grad=True))
    dg = case[2].shape[-1] // 9
    leaves = [t.requires_grad_() for t in _port_args(case)]
    out = dcn.modulated_deform_conv(*leaves, None, 1, 1, 1, 1, dg)
    torch.sum(out * torch.cos(out * 3)).backward()
    gots = [t.grad.float().permute(0, 2, 3, 1).numpy() for t in leaves[:3]]
    gots.append(leaves[3].grad.float().permute(2, 3, 1, 0).numpy())
    for name, leaf, got, want in zip(('dx', 'd_offset', 'd_mask', 'dW'),
                                     leaves, gots, wants):
        assert leaf.grad.dtype == torch.bfloat16, name
        assert np.isfinite(got).all(), name
        assert _rel(got, want) <= GRAD_TOL, (name, _rel(got, want))


def test_bf16_plain_takes_coordinates_in_float32_at_w320():
    """At x = 256-319 bf16 spaces its values 2 px apart: a coordinate taken
    in bf16 samples the wrong pixels. The band kernel takes them in f32."""
    case = _bf16(_case(5, n=1, h=16, w=320, cin=16, cout=16, dg=2))
    (want,) = _band_dispatch(lambda: _run(case, band=True))
    got = dcn.modulated_deform_conv(*_port_args(case), None, 1, 1, 1, 1, 2)
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert _rel(got, want) <= FWD_TOL, _rel(got, want)
    # the right half alone, where the spacing is 2 px
    assert _rel(got[:, :, 256:], np.asarray(want, np.float32)[:, :, 256:]
                ) <= FWD_TOL


def test_fp32_path_has_no_bf16_rounding():
    """The float32 plain DCN is float64's to float32 precision (1e-5 of
    its max over sums of 144 terms): no rounding
    point of the bf16 branch reaches it, on bf16-representable inputs
    where the bf16 result does differ."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 16, 12, 300, generator=g).bfloat16().float()
    off = (torch.rand(2, 36, 12, 300, generator=g) * 6 - 3).bfloat16().float()
    mask = torch.rand(2, 18, 12, 300, generator=g).bfloat16().float()
    weight = torch.randn(8, 16, 3, 3, generator=g).bfloat16().float()
    args = (x, off, mask, weight, None, 1, 1, 1, 1, 2)
    f32 = dcn.modulated_deform_conv_plain(*args)
    f64 = dcn.modulated_deform_conv_plain(
        *[a.double() for a in args[:4]], *args[4:])
    bf16 = dcn.modulated_deform_conv_plain(
        *[a.bfloat16() for a in args[:4]], *args[4:])
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert _rel(f32, f64) <= 1e-5
    assert _rel(bf16.float(), f64) > 1e-4


def test_packed_route_refuses_bf16():
    """The packed route's blend refuses bf16 operands mixed with float32
    ones, in either position, rather than cast them to one dtype."""
    from edvr_tpu_torch.ops import dcn_blend
    g = torch.zeros(4, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match='one dtype'):
        dcn_blend.blend_matmul_group(g, torch.zeros(4, 2), g.t().float(),
                                     torch.zeros(4, 16), 8)
    with pytest.raises(TypeError, match='one dtype'):
        dcn_blend.blend_matmul_group(g.float(), torch.zeros(4, 2),
                                     g.t().contiguous(), torch.zeros(4, 16),
                                     8)


def test_packed_route_runs_bf16(monkeypatch):
    """EDVR_TPU_DCN_PALLAS=1 (the packed route) runs bf16 through the bf16
    blend (tests/test_torch_packed_bf16.py holds it against JAX's) and
    returns bf16 within FWD_TOL of the bf16 direct route."""
    args = _port_args(_bf16(_case(0, n=1, h=8, w=8, cin=16, cout=16, dg=2)))
    direct = dcn.modulated_deform_conv(*args, None, 1, 1, 1, 1, 2)
    monkeypatch.setenv('EDVR_TPU_DCN_PALLAS', '1')
    packed = dcn.modulated_deform_conv(*args, None, 1, 1, 1, 1, 2)
    assert packed.dtype == torch.bfloat16
    assert _rel(packed.float(), direct.float()) <= FWD_TOL


class _DtypeLog(TorchDispatchMode):
    """Records the float dtypes every op outputs while ``on``."""

    def __init__(self):
        super().__init__()
        self.on, self.seen = True, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.on:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    self.seen.setdefault(t.dtype, set()).add(str(func))
        return out


@pytest.mark.parametrize('align', ['dcn', 'tap_shared'])
def test_bf16_edvr_forward_stays_bf16(monkeypatch, align):
    """Every op of a bf16 EDVR forward outside the DCN (whose coordinates
    are float32 by design) outputs bf16: sigmoid, the pyramid's bilinear
    upsample, TSA's attention, pixel shuffle, WarpAlignPack's identity
    weight."""
    net = define_network(dict(type='EDVR', num_feat=8, deformable_groups=2,
                              num_extract_block=1, num_reconstruct_block=1,
                              align_variant=align))
    params = {n: p.detach().bfloat16() for n, p in net.named_parameters()}
    lq = torch.rand(1, 5, 3, 16, 16).bfloat16()
    log = _DtypeLog()
    real = arch_util.modulated_deform_conv

    def dcn_unlogged(x, *args):
        assert x.dtype == torch.bfloat16 and args[2].dtype == x.dtype
        log.on = False
        try:
            out = real(x, *args)
        finally:
            log.on = True
        assert out.dtype == torch.bfloat16
        return out

    monkeypatch.setattr(arch_util, 'modulated_deform_conv', dcn_unlogged)
    with log:
        out = torch.func.functional_call(net, params, (lq,))
    assert out.dtype == torch.bfloat16
    assert set(log.seen) == {torch.bfloat16}, {
        str(k): sorted(v) for k, v in log.seen.items()}


def _jax_mp_steps(params, lq, gt, train, steps):
    """The JAX engine's own mixed-precision train step
    (edvr_tpu/models/sr_model.py::_make_train_step) run ``steps`` times on
    one batch; returns (losses, final parameters, final optax state)."""
    shell = object.__new__(JaxEDVRModel)
    shell.opt = train_opt(**train)
    shell.net_g = seeded_jax_params()[0]
    shell.params_g, shell.schedulers = params, {}
    shell.replicate = lambda tree: tree
    shell.cri_pix = jax_build_loss(shell.opt['train']['pixel_opt'])
    shell.cri_perceptual = None
    shell.setup_optimizers()
    shell.setup_schedulers()
    step = shell._make_train_step()
    p, state, losses = params, shell.opt_state_g, []
    for it in range(1, steps + 1):
        lr = jnp.float32(shell.schedulers['optimizer_g'](it))
        p, state, logs = step(p, state, jnp.asarray(lq), jnp.asarray(gt), lr,
                              jnp.int32(it))
        losses.append(float(logs['l_pix']))
    return losses, p, state


MIXED = {'bf16': torch.bfloat16, None: torch.float32}
MP_TRAIN = dict(mixed_precision='bf16', tsa_iter=2, dcn_lr_mul=0.5,
                pixel_opt=dict(type='CharbonnierLoss', loss_weight=1.0,
                               reduction='mean'))


def _mp_case(seed=7):
    """Seeded small-EDVR parameters (the JAX tree and its state dict) and
    one batch (NHWC numpy)."""
    _, params = seeded_jax_params(seed)
    init = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           params))
    rng = np.random.RandomState(seed + 1)
    lq = rng.rand(2, 5, 16, 16, 3).astype(np.float32)
    gt = rng.rand(2, 64, 64, 3).astype(np.float32)
    return params, init, lq, gt


def _port_steps(tmp_path, init, lq, gt, train, steps=2):
    """``steps`` steps of the port's engine on one batch from ``init``;
    returns (model, losses, dtypes of x at each DCN call). With
    ``tsa_iter`` 2, step 1 is the warm-up: it checks that only fusion.*
    moved."""
    opt = parse_dict(train_opt(**train), is_train=True, root=str(tmp_path))
    opt['device'] = 'cpu'
    model = create_model(opt)
    model.net_g.load_state_dict(init)
    named = dict(model.net_g.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    calls, losses = [], []
    real = dcn.modulated_deform_conv_plain
    dcn.modulated_deform_conv_plain = lambda x, *a: calls.append(
        x.dtype) or real(x, *a)
    try:
        for it in range(1, steps + 1):
            model.feed_data({'lq': torch.from_numpy(lq).permute(0, 1, 4, 2,
                                                                 3),
                             'gt': torch.from_numpy(gt).permute(0, 3, 1, 2)})
            model.optimize_parameters(it)
            losses.append(model.get_current_log()['l_pix'])
            if it == 1 and train.get('tsa_iter') == 2:
                for n, p in named.items():  # only fusion.* has moved
                    assert torch.equal(p, start[n]) != ('fusion' in n), n
    finally:
        dcn.modulated_deform_conv_plain = real
    return model, losses, calls


def _check_master_state(model):
    """f32 parameters, gradients and Adam moments; the DCN lr multiplier's
    param groups."""
    for n, p in model.net_g.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        state = model.optimizer_g.state[p]
        assert state['exp_avg'].dtype == torch.float32, n
        assert state['exp_avg_sq'].dtype == torch.float32, n
    assert [g['lr_mul'] for g in model.optimizer_g.param_groups] == [1.0,
                                                                     0.5]


def test_mp_step_keeps_f32_master_and_tracks_fp32_step(tmp_path):
    """Two bf16 steps of the port's engine against its fp32 steps from the
    same parameters and batch, as tests/test_mixed_precision.py holds the
    JAX engine: step 1 inside the TSA warm-up (only fusion.* moves), step 2
    after it, with dcn_lr_mul 0.5. The network and its 4 DCN calls a step
    run in bf16; the output, loss, parameters, gradients and Adam state
    are f32."""
    _, init, lq, gt = _mp_case()
    bf16, losses, calls = _port_steps(tmp_path / 'bf16', init, lq, gt,
                                      MP_TRAIN)
    assert bf16.compute_dtype == torch.bfloat16
    assert calls == [torch.bfloat16] * 8
    assert bf16.output.dtype == torch.float32
    _check_master_state(bf16)
    fp32, losses32, calls32 = _port_steps(tmp_path / 'fp32', init, lq, gt,
                                          dict(MP_TRAIN,
                                               mixed_precision=None))
    assert calls32 == [torch.float32] * 8
    for a, b in zip(losses, losses32):
        assert np.isfinite(a) and abs(a - b) <= LOSS_TOL, (losses, losses32)
    want = dict(fp32.net_g.named_parameters())
    for n, p in bf16.net_g.named_parameters():
        err = (p - want[n]).abs().max().item()
        assert err <= PARAM_TOL, (n, err)


def test_mp_step_grads_track_f32_grads(tmp_path):
    """The first bf16 step's f32 master gradients (no TSA warm-up, so
    every parameter learns) against the port's float32 step's, which
    tests/test_torch_grad.py holds to ``jax.grad`` at 1e-4: within
    the bounds of tests/test_torch_cuda.py::check_mp_grads, which a
    scaled, negated or dropped gradient fails. Adam's first moment
    after the step is (1 - beta1) times that gradient."""
    _, init, lq, gt = _mp_case()
    grads = {}
    for mp in ('bf16', None):
        model, _, calls = _port_steps(tmp_path / str(mp), init, lq, gt,
                                      dict(MP_TRAIN, mixed_precision=mp,
                                           tsa_iter=0), steps=1)
        assert calls == [MIXED[mp]] * 4
        grads[mp] = {n: p.grad.clone()
                     for n, p in model.net_g.named_parameters()}
        for n, p in model.net_g.named_parameters():
            torch.testing.assert_close(
                model.optimizer_g.state[p]['exp_avg'], 0.1 * p.grad,
                rtol=1e-6, atol=0)
    check_mp_grads(grads['bf16'], grads[None])


def test_mp_step_grads_random_init(tmp_path):
    """The same gate on the CPU for the random-init EDVR that
    tests/test_torch_cuda.py::test_mp_train_steps_on_card runs on the
    card: a harder case, whose gradient is mostly conv_last.bias (the mean
    residual, which a bf16 output resolves only to 2^-9)."""
    runs = mp_runs('cpu', tmp_path)
    assert [c.dtype for c in (runs['bf16'][0].output, runs[None][0].output)
            ] == [torch.float32] * 2
    check_mp_grads(runs['bf16'][3], runs[None][3])


@pytest.mark.slow  # ~60 s: XLA compiles the JAX engine's bf16 step and grad
def test_mp_step_grads_match_jax(tmp_path):
    """The first bf16 step's f32 master gradients against ``jax.grad`` of
    the float32 loss, from the same seeded parameters and batch, within
    the bounds of test_mp_step_grads_track_f32_grads. The JAX engine's own
    bf16 step, read through optax's first moment after one step (1 -
    beta1 times its gradient), lies beyond them on the CPU, where XLA
    sums the bias gradients in bf16: the bounds see such a gradient."""
    params, init, lq, gt = _mp_case()
    train = dict(MP_TRAIN, tsa_iter=0)
    net = seeded_jax_params()[0]
    cri = jax_build_loss(train['pixel_opt'])
    _, g32 = jax.jit(jax.value_and_grad(
        lambda p: cri(net.apply({'params': p}, jnp.asarray(lq)),
                      jnp.asarray(gt))))(params)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, g32))
    model, _, calls = _port_steps(tmp_path, init, lq, gt, train, steps=1)
    assert calls == [torch.bfloat16] * 4
    check_mp_grads({n: p.grad for n, p in model.net_g.named_parameters()},
                   want)
    state = _jax_mp_steps(params, lq, gt, train, 1)[2]
    (mu,) = [s.mu for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: hasattr(s, 'mu'))]
    jax_bf16 = jax_params_to_state_dict(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, mu))
    assert grad_gaps(jax_bf16, want)[0] > MP_GRAD_TOL


@pytest.mark.slow  # ~40 s: XLA compiles the JAX engine's bf16 step
def test_mp_step_matches_jax_engine(tmp_path):
    """Two bf16 steps of the port's engine against the JAX engine's own
    mixed-precision step, from the same seeded parameters and batch,
    across the TSA warm-up with dcn_lr_mul 0.5."""
    params, init, lq, gt = _mp_case()
    jlosses, jparams, _ = _jax_mp_steps(params, lq, gt, MP_TRAIN, 2)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           jparams))
    model, losses, calls = _port_steps(tmp_path, init, lq, gt, MP_TRAIN)
    assert calls == [torch.bfloat16] * 8
    _check_master_state(model)
    for a, b in zip(losses, jlosses):
        assert np.isfinite(a) and abs(a - b) <= LOSS_TOL, (losses, jlosses)
    for n, p in model.net_g.named_parameters():
        err = (p.detach() - want[n]).abs().max().item()
        assert err <= PARAM_TOL, (n, err)


@pytest.mark.parametrize('is_train', [True, False])
def test_mp_refuses_other_policies(tmp_path, is_train):
    """Any value but null or bf16 raises, also for a test-mode config that
    carries a train block (as edvr_tpu/models/sr_model.py:34-40)."""
    for mp in ('fp16', 'float16', 'bf32'):
        opt = parse_dict(train_opt(mixed_precision=mp), is_train=is_train,
                         root=str(tmp_path))
        opt['device'] = 'cpu'
        with pytest.raises(NotImplementedError, match='mixed_precision'):
            create_model(opt)


def test_train_cli_runs_shipped_yml_in_bf16(tmp_path):
    """``python -m edvr_tpu_torch.train --device cpu`` on the shipped
    EDVR-M YAML with ``mixed_precision: bf16`` left in place, cut in size
    only (a narrow network, a synthetic REDS tree, 2 iterations): it
    trains and saves an f32 checkpoint."""
    root = str(tmp_path / 'reds')
    _reds_tree(root)
    with open(SHIPPED_YML) as f:
        opt = yaml.safe_load(f)
    assert opt['train']['mixed_precision'] == 'bf16'
    opt['num_gpu'] = 1
    opt['network_g'].update(num_feat=8, deformable_groups=2,
                            num_extract_block=1, num_reconstruct_block=1)
    opt['path'].update(pretrain_network_g=None)
    tr = opt['datasets']['train']
    tr.update(dataroot_gt=f'{root}/train/gt', dataroot_lq=f'{root}/train/lq',
              meta_info_file=f'{root}/meta_info.txt', gt_size=32,
              num_worker_per_gpu=0, batch_size_per_gpu=2,
              dataset_enlarge_ratio=1)
    opt['datasets']['val'].update(dataroot_gt=f'{root}/val/gt',
                                  dataroot_lq=f'{root}/val/lq',
                                  meta_info_file=None)
    opt['train'].update(total_iter=2, tsa_iter=1)
    opt['train']['scheduler']['periods'] = [2] * 5
    opt['val']['val_freq'] = 2
    opt['logger'].update(print_freq=1, save_checkpoint_freq=2,
                         use_tb_logger=False)
    yml = str(tmp_path / 'shipped_bf16.yml')
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    assert parse(yml, is_train=True, root=str(tmp_path))['train'][
        'mixed_precision'] == 'bf16'

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get('PYTHONPATH', '')]))
    proc = subprocess.run([sys.executable, '-m', 'edvr_tpu_torch.train',
                           '-opt', yml, '--device', 'cpu'], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'End of training' in proc.stderr
    ckpt = torch.load(tmp_path / 'experiments' / opt['name'] / 'models' /
                      'net_g_latest.pth', weights_only=True)['params']
    assert ckpt and all(v.dtype == torch.float32 for v in ckpt.values())
    assert all(torch.isfinite(v).all() for v in ckpt.values())
