"""The port's multi-process training and validation (``--launcher pytorch``,
``edvr_tpu_torch/parallel``) on the CPU over gloo, against one process on
the global batch and against the JAX engine's step, as
tests/test_multihost.py holds the JAX package's pod.

Ranks are subprocesses of tests/helpers/torch_rank_worker.py (no JAX in
them), each with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT`` as ``torchrun`` sets them, a port the OS handed out
just before the spawn, one torch thread, and a deadline after which every
rank is killed. One two-rank spawn (a module fixture) runs every engine's
steps, the per-window test CLI and the training CLI; four ranks run the
clip-mode test CLI over uneven folders.

* A step of SRModel (MSRResNet), EDVRModel (fp32, and bf16 through the
  ``functional_call`` step, both with ``tsa_iter`` and ``dcn_lr_mul``) and
  SRGAN (``network_d.train: true``, so D's BatchNorm moments are the global
  batch's): each rank takes its half of a global batch of 4; the
  parameters (and D's running statistics) equal one process's step on the
  whole batch and the JAX engine's within ``rtol=1e-5, atol=1e-6`` (fp32)
  or tests/test_torch_bf16.py's bounds (bf16), on both ranks alike. Rank 1
  starts from its own weights and gets rank 0's by the engine's broadcast.
* Validation: the per-window tables (two ranks) and the clip-mode tables
  (four ranks, five folders) equal one process's exactly.
* The CLI: ``--launcher pytorch`` without its environment fails, naming
  the variables; in a two-rank training run rank 1 writes no directory,
  checkpoint, log file or event (only its own profiler trace), and logs
  nothing below ERROR.
"""

import os
import os.path as osp
import socket
import subprocess
import sys
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from edvr_tpu_torch import test as port_test
from edvr_tpu_torch.convert import jax_params_to_state_dict
from test_torch_bf16 import (LOSS_TOL, MP_TRAIN, PARAM_TOL, _jax_mp_steps,
                             _mp_case)
from test_torch_cuda import check_mp_grads
from test_torch_gan import (STATS_ATOL, STATS_RTOL, gan_opt, jax_engine,
                            port_model, seeded_variables)
from test_torch_grad import train_opt
from test_torch_train import _write_train_yml
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
WORKER = osp.join(REPO, 'tests', 'helpers', 'torch_rank_worker.py')
RTOL, ATOL = 1e-5, 1e-6
SPAWN_TIMEOUT = 300


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def spawn_ranks(tasks, world, workdir, timeout=SPAWN_TIMEOUT):
    """Run ``tasks`` (the worker's list) on ``world`` ranks, rank r in
    ``workdir/rank<r>``; every rank is killed at the deadline. Returns each
    rank's output."""
    tasks_path = osp.join(workdir, f'tasks_{world}.pt')
    torch.save(tasks, tasks_path)
    port = free_port()
    procs = []
    for r in range(world):
        cwd = osp.join(workdir, f'rank{r}')
        os.makedirs(cwd, exist_ok=True)
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR='127.0.0.1',
                   MASTER_PORT=str(port), OMP_NUM_THREADS='1')
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, tasks_path], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate()[0][-3000:] for p in procs]
        pytest.fail(f'{world} ranks did not finish in {timeout} s: {tails}')
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and 'RANK_OK' in out, f'rank {r}:\n{out}'
    return outs


# ---------------------------------------------------------------------- #
# the cases: option dicts, initial weights and global batches of 4
# ---------------------------------------------------------------------- #
def sr_case():
    """MSRResNet at 8 features and 1 block (tests/test_data_parallel.py),
    from seeded parameters. Adam's eps is 1e-4, as in
    tests/test_torch_gan.py: its first step is lr * g / (|g| + eps) per
    entry, which turns an entry's float32 rounding near g = 0 into a whole
    step of lr; eps bounds that far inside ATOL."""
    opt = {
        'name': 'dp_sr', 'model_type': 'SRModel', 'scale': 4,
        'num_gpu': 1, 'manual_seed': 0,
        'network_g': dict(type='MSRResNet', num_in_ch=3, num_out_ch=3,
                          num_feat=8, num_block=1, upscale=4),
        'path': {'pretrain_network_g': None, 'strict_load_g': True},
        'train': {
            'optim_g': dict(type='Adam', lr=1e-3, weight_decay=0,
                            betas=[0.9, 0.99], eps=1e-4),
            'scheduler': dict(type='ConstantLR'),
            'total_iter': 10, 'warmup_iter': -1,
            'pixel_opt': dict(type='L1Loss', loss_weight=1.0,
                              reduction='mean'),
        },
    }
    rng = np.random.RandomState(42)
    batches = [dict(lq=rng.rand(4, 8, 8, 3).astype(np.float32),
                    gt=rng.rand(4, 32, 32, 3).astype(np.float32))
               for _ in range(2)]
    return opt, batches


def edvr_case(mp):
    """The small EDVR of tests/test_torch_bf16.py (seeded JAX parameters,
    its DCN offsets drawn so that the samples move) on a global batch of 4,
    two steps across the TSA warm-up with ``dcn_lr_mul`` 0.5. fp32: Adam's
    eps is 1, as tests/test_torch_gan.py's VideoGAN case takes it (EDVR's
    gradients agree with JAX's to 1e-4 of each tensor's largest entry, not
    per entry); bf16: tests/test_torch_bf16.py's configuration and bounds
    as they are."""
    params, init, _, _ = _mp_case()
    rng = np.random.RandomState(9)
    lq = rng.rand(4, 5, 16, 16, 3).astype(np.float32)
    gt = rng.rand(4, 64, 64, 3).astype(np.float32)
    train = dict(MP_TRAIN)
    if not mp:
        train.update(mixed_precision=None,
                     optim_g=dict(type='Adam', lr=4e-4, weight_decay=0,
                                  betas=[0.9, 0.99], eps=1.0))
    return params, init, train, [dict(lq=lq, gt=gt)] * 2


def _to_port(batch):
    return {k: (torch.from_numpy(v).permute(0, 1, 4, 2, 3).contiguous()
                if v.ndim == 5 else _nchw(v)) for k, v in batch.items()}


def _gan_opt():
    opt = gan_opt('SRGANModel')
    opt['train'].pop('perceptual_opt')
    return opt


def _gan_batches():
    rng = np.random.RandomState(6)
    return [dict(lq=rng.rand(4, 32, 32, 3).astype(np.float32),
                 gt=rng.rand(4, 128, 128, 3).astype(np.float32))
            for _ in range(2)]


def seeded_case(case):
    """(option dict, global batches (NHWC numpy), initial {suffix: state
    dict}, a function running the JAX engine's steps on the batches from
    those weights that returns ({suffix: state dict}, logs); SRGAN's the
    first step's D gradient). Nothing of JAX is compiled until that
    function runs."""
    if case == 'sr':
        from edvr_tpu.archs import define_network as jax_define
        from edvr_tpu.models.losses import build_loss as jax_build_loss
        from edvr_tpu.models.sr_model import SRModel as JaxSRModel
        opt, batches = sr_case()
        net = jax_define(dict(opt['network_g']))
        params, _ = seeded_variables(net, jnp.zeros((1, 8, 8, 3)), 3)
        init = {'g': jax_params_to_state_dict(_tree(params))}

        def run():
            """The JAX engine's own train step (a shell as
            tests/test_torch_bf16.py::_jax_mp_steps sets one up)."""
            shell = object.__new__(JaxSRModel)
            shell.opt, shell.net_g = dict(opt, is_train=True), net
            shell.params_g, shell.schedulers = params, {}
            shell.replicate = lambda tree: tree
            shell.cri_pix = jax_build_loss(opt['train']['pixel_opt'])
            shell.cri_perceptual = None
            shell.setup_optimizers()
            shell.setup_schedulers()
            step = shell._make_train_step()
            p, state, logs = params, shell.opt_state_g, []
            for it, b in enumerate(batches, start=1):
                lr = jnp.float32(shell.schedulers['optimizer_g'](it))
                p, state, log = step(p, state, jnp.asarray(b['lq']),
                                     jnp.asarray(b['gt']), lr, jnp.int32(it))
                logs.append({k: float(v) for k, v in log.items()})
            return {'g': jax_params_to_state_dict(_tree(p))}, logs
        return opt, batches, init, run
    if case == 'srgan':
        opt, batches = _gan_opt(), _gan_batches()
        jmodel = jax_engine(opt)
        init = {'g': jax_params_to_state_dict(_tree(jmodel.params_g)),
                'd': jax_params_to_state_dict(_tree(jmodel.params_d),
                                              _tree(jmodel.bstats_d))}

        def run():
            """The first step's D gradient (optax's first moment over 1 -
            beta1), as a state dict."""
            jmodel.lq, jmodel.gt = (jnp.asarray(batches[0]['lq']),
                                    jnp.asarray(batches[0]['gt']))
            jmodel.optimize_parameters(1)
            (mu,) = [s.mu for s in jax.tree_util.tree_leaves(
                jmodel.opt_state_d, is_leaf=lambda s: hasattr(s, 'mu'))]
            return jax_params_to_state_dict(_tree(jax.tree_util.tree_map(
                lambda m: np.asarray(m) / 0.1, mu)))
        return opt, batches, init, run
    params, init, train, batches = edvr_case(case == 'edvr_bf16')

    def run():
        losses, jparams, _ = _jax_mp_steps(params, batches[0]['lq'],
                                           batches[0]['gt'], train, 2)
        return ({'g': jax_params_to_state_dict(_tree(jparams))},
                [{'l_pix': v} for v in losses])
    return train_opt(**train), batches, {'g': init}, run


CASES = ('sr', 'edvr_fp32', 'edvr_bf16', 'srgan')


@pytest.fixture(scope='module')
def cases():
    return {case: seeded_case(case) for case in CASES}


def _single_process(opt, batches, init, root):
    """The port's engine in this process on the whole batches: (model,
    the last step's gradients, every step's log)."""
    model = port_model(opt, root)
    for suffix, state in init.items():
        getattr(model, f'net_{suffix}').load_state_dict(state, strict=True)
    grads, logs = None, []
    for it, b in enumerate(batches, start=1):
        model.feed_data(_to_port(b))
        model.optimize_parameters(it)
        logs.append(model.get_current_log())
    grads = {f'net_{s}': {n: p.grad.clone() for n, p in getattr(
        model, f'net_{s}').named_parameters() if p.grad is not None}
        for s in init}
    return model, grads, logs


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory, cases):
    """One two-rank spawn: every case's steps, the per-window test CLI and
    a training CLI run. Returns (workdir, each rank's output)."""
    work = tmp_path_factory.mktemp('two_ranks')
    tasks = []
    for name, (opt, batches, init, _) in cases.items():
        pretrain = {}
        for suffix, state in init.items():
            path = str(work / f'{name}_{suffix}.pth')
            torch.save({'params': state}, path)
            pretrain[suffix] = path
        tasks.append(dict(kind='steps', name=name, opt=opt,
                          batches=[_to_port(b) for b in batches],
                          pretrain=pretrain, out=str(work / name)))
        os.makedirs(work / name)
    yml = _video_tree_and_yml(work, [('000', 5), ('011', 6)], clip=False)
    tasks.append(dict(kind='cli', module='test',
                      args=['-opt', yml, '--launcher', 'pytorch',
                            '--device', 'cpu'],
                      out=str(work / 'window_tables.npz')))
    tasks.append(dict(kind='cli', module='train',
                      args=['-opt', _dist_train_yml(work), '--launcher',
                            'pytorch', '--device', 'cpu']))
    return work, spawn_ranks(tasks, 2, str(work))


def _rank_results(work, case):
    """Rank 0's results of ``case``, after checking that rank 1 (begun
    from its own seed; the broadcast and the same mean gradients) holds
    the same networks."""
    ranks = [torch.load(work / case / f'rank{r}.pt', weights_only=True)
             for r in range(2)]
    for name, state in ranks[0]['state'].items():
        for k, v in state.items():
            assert torch.equal(v, ranks[1]['state'][name][k]), (name, k)
    return ranks[0]


def _assert_logs(got, want, case, fp32_rtol):
    for it, (log, ref) in enumerate(zip(got, want)):
        for k in ref:
            if case == 'edvr_bf16':
                assert abs(log[k] - ref[k]) <= LOSS_TOL, (it, k)
            else:
                np.testing.assert_allclose(log[k], ref[k], rtol=fp32_rtol,
                                           atol=1e-7, err_msg=(it, k))


def _assert_states(got, want, case):
    """Every entry of ``want``'s state dicts in ``got``'s: parameters
    within RTOL / ATOL (bf16: tests/test_torch_bf16.py's PARAM_TOL),
    running statistics within tests/test_torch_gan.py's bounds."""
    for suffix, state in want.items():
        mine = got[f'net_{suffix}']
        for k, v in state.items():
            if k.endswith('num_batches_tracked'):
                assert torch.equal(mine[k], v), k
            elif case == 'edvr_bf16':
                err = (mine[k] - v).abs().max().item()
                assert err <= PARAM_TOL, (k, err)
            elif 'running' in k:
                np.testing.assert_allclose(mine[k].numpy(), v.numpy(),
                                           rtol=STATS_RTOL, atol=STATS_ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(mine[k].numpy(), v.numpy(),
                                           rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize('case', CASES)
def test_two_rank_step_matches_one_process(case, cases, two_ranks,
                                           tmp_path):
    """Two ranks on their halves against one process on the global batch:
    the logs (the ranks' mean), the parameters and D's running statistics;
    in bf16 also the last step's gradients, by tests/test_torch_cuda.py's
    ``check_mp_grads``."""
    work, _ = two_ranks
    opt, batches, init, _ = cases[case]
    got = _rank_results(work, case)
    model, grads, logs = _single_process(opt, batches, init, str(tmp_path))
    _assert_logs(got['logs'], logs, case, fp32_rtol=1e-5)
    _assert_states(got['state'], {s: getattr(model, f'net_{s}').state_dict()
                                  for s in init}, case)
    if case == 'edvr_bf16':
        check_mp_grads(got['grads'][-1]['net_g'], grads['net_g'])


# XLA's compile of the JAX engine's EDVR steps takes ~40 s each on the
# CPU
@pytest.mark.parametrize('case', [
    'sr', *(pytest.param(c, marks=pytest.mark.slow)
            for c in ('edvr_fp32', 'edvr_bf16'))])
def test_two_rank_step_matches_jax_engine(case, cases, two_ranks):
    """Two ranks on their halves against the JAX engine's single-process
    step on the global batch (tests/test_multihost.py:57-86): the logs
    (tests/test_torch_gan.py's LOSS_RTOL) and the parameters. SRGAN's is
    test_two_rank_srgan_grads_against_float64_and_jax."""
    work, _ = two_ranks
    run = cases[case][3]
    want, jlogs = run()
    got = _rank_results(work, case)
    _assert_logs(got['logs'], jlogs, case, fp32_rtol=1e-4)
    _assert_states(got['state'], want, case)


# the gradients of the first SRGAN step, relative to each tensor's largest
# entry: the two ranks read ~7e-6 against float64 (one process's float32
# step reads the same); the JAX engine's discriminator gradient on this
# global batch of 4 reads ~5e-3 (at a batch of 2, ~1e-5): flax's BatchNorm
# takes the variance as E[x^2] - E[x]^2 in float32 (ROADMAP C.10)
SRGAN_F64_TOL = 1e-4


def _float64_srgan_grads(opt, batch, init, cri_pix, cri_gan):
    """G's and D's gradients of the first SRGAN step (G steps first, D on
    its output before the update) in float64 from ``init``, one process on
    the global batch, both discriminators in training mode."""
    from edvr_tpu_torch.archs import define_network
    nets = {}
    for s in ('g', 'd'):
        nets[s] = define_network(dict(opt[f'network_{s}'])).double()
        nets[s].load_state_dict(init[s])
        nets[s].train()
    lq, gt = (v.double() for v in _to_port(batch).values())
    output = nets['g'](lq)
    l_g = cri_pix(output, gt) + cri_gan(nets['d'](output), True,
                                         is_disc=False)
    g_params = dict(nets['g'].named_parameters())
    grads_g = torch.autograd.grad(l_g, list(g_params.values()))
    l_d = (cri_gan(nets['d'](gt), True, is_disc=True)
           + cri_gan(nets['d'](output.detach()), False, is_disc=True))
    d_params = dict(nets['d'].named_parameters())
    grads_d = torch.autograd.grad(l_d, list(d_params.values()))
    return {'net_g': dict(zip(g_params, grads_g)),
            'net_d': dict(zip(d_params, grads_d))}


def _worst(got, want):
    return max(((got[n].double() - w).abs().max() / w.abs().max()).item()
               for n, w in want.items())


def test_two_rank_srgan_grads_against_float64_and_jax(cases, two_ranks,
                                                      tmp_path):
    """SRGAN's first step on two ranks (D's BatchNorm moments the global
    batch's) against float64 on the global batch, G's and D's gradients
    within SRGAN_F64_TOL of each tensor's largest entry; the JAX engine's
    D gradient (optax's first moment over 1 - beta1) on the same batch
    lies beyond it."""
    work, _ = two_ranks
    opt, batches, init, run = cases['srgan']
    got = _rank_results(work, 'srgan')['grads'][0]
    model = port_model(opt, str(tmp_path))
    want = _float64_srgan_grads(opt, batches[0], init, model.cri_pix,
                                model.cri_gan)
    for net in ('net_g', 'net_d'):
        assert _worst(got[net], want[net]) <= SRGAN_F64_TOL, net
    assert _worst(run(), want['net_d']) > SRGAN_F64_TOL


# ---------------------------------------------------------------------- #
# validation
# ---------------------------------------------------------------------- #
VIDEO_TEST_YML = """
name: {name}
model_type: {model}
scale: 4
num_gpu: 1
manual_seed: 0
datasets:
  test_1:
    name: REDS4
    type: VideoTestDataset
    dataroot_gt: {root}/gt
    dataroot_lq: {root}/lq
    io_backend: {{type: disk}}
    cache_data: {clip}
    num_frame: 5
    padding: reflection_circle
network_g: {{type: EDVR, num_in_ch: 3, num_out_ch: 3, num_feat: 8, num_frame: 5,
  deformable_groups: 2, num_extract_block: 1, num_reconstruct_block: 1,
  center_frame_idx: null, hr_in: false, with_predeblur: false, with_tsa: true}}
path: {{pretrain_network_g: ~, strict_load_g: false}}
val:
  save_img: false
  clip_mode: {clip}
  metrics:
    psnr: {{type: calculate_psnr, crop_border: 0, test_y_channel: false}}
"""


def _video_tree_and_yml(work, folders, clip):
    """Seeded PNG folders (GT 32 px, LQ 8) and the test YAML over them."""
    root = osp.join(str(work), 'clip' if clip else 'window')
    rng = np.random.RandomState(5 if clip else 3)
    for folder, n in folders:
        for sub, size in (('gt', 32), ('lq', 8)):
            d = osp.join(root, sub, folder)
            os.makedirs(d)
            for i in range(n):
                cv2.imwrite(osp.join(d, f'{i:08d}.png'),
                            (rng.rand(size, size, 3) * 255).astype(np.uint8))
    yml = osp.join(root, 'test.yml')
    with open(yml, 'w') as f:
        f.write(VIDEO_TEST_YML.format(
            name='dist_clip' if clip else 'dist_window', root=root,
            model='EDVRModel' if clip else 'VideoBaseModel',
            clip='true' if clip else 'false'))
    return yml


def _one_process_tables(yml, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    model = port_test.main(['-opt', yml, '--device', 'cpu'])
    return model.metric_results


def _assert_tables_equal(npz, want):
    got = np.load(npz)
    assert sorted(got.files) == sorted(want)
    for folder, table in want.items():
        assert (table > 0).all()
        np.testing.assert_array_equal(got[folder], table, err_msg=folder)


def test_two_rank_window_validation_tables(two_ranks, monkeypatch,
                                           tmp_path):
    work, _ = two_ranks
    yml = osp.join(str(work), 'window', 'test.yml')
    _assert_tables_equal(work / 'window_tables.npz',
                         _one_process_tables(yml, monkeypatch, tmp_path))


def test_four_rank_clip_validation_uneven_folders(tmp_path, monkeypatch):
    """Five folders over four ranks: rank 0 scores two, the others one;
    the sum over the ranks rebuilds every frame of every folder."""
    work = tmp_path / 'four'
    yml = _video_tree_and_yml(work, [('000', 5), ('011', 6), ('015', 5),
                                     ('020', 5), ('025', 5)], clip=True)
    spawn_ranks([dict(kind='cli', module='test',
                      args=['-opt', yml, '--launcher', 'pytorch',
                            '--device', 'cpu'],
                      out=str(work / 'clip_tables.npz'))], 4, str(work))
    _assert_tables_equal(work / 'clip_tables.npz',
                         _one_process_tables(yml, monkeypatch, tmp_path))


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #
def _dist_train_yml(work):
    """tests/test_torch_train.py's small EDVR training YAML (bf16, a
    per-window validation at iteration 2) with TensorBoard on and a profile
    window over iterations 2-3."""
    yml = _write_train_yml(work, name='dist_train')
    with open(yml) as f:
        opt = yaml.safe_load(f)
    opt['logger'].update(use_tb_logger=True,
                         profile=dict(start_iter=2, end_iter=3))
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    return yml


def test_rank_one_writes_and_logs_nothing(two_ranks):
    """Rank 0 (its working directory the run's root) has the run's
    directories, checkpoints, log, events and trace; rank 1 only its own
    trace, and no log line below ERROR."""
    work, outs = two_ranks
    exp = ('experiments', 'dist_train')
    root0, root1 = (osp.join(str(work), f'rank{r}') for r in range(2))
    models = os.listdir(osp.join(root0, *exp, 'models'))
    assert 'net_g_latest.pth' in models and 'net_g_2.pth' in models
    assert any(f.endswith('.log') for f in os.listdir(osp.join(root0, *exp)))
    assert os.listdir(osp.join(root0, 'tb_logger', 'dist_train'))
    assert os.listdir(osp.join(root0, *exp, 'profile')) == [
        'trace_rank0.json']
    # each rank traces its own process; nothing else of rank 1's is written
    written = [osp.relpath(osp.join(d, f), root1)
               for d, _, files in os.walk(root1) for f in files]
    assert written == [osp.join(*exp, 'profile', 'trace_rank1.json')]
    assert ' INFO: ' in outs[0]
    for level in ('DEBUG', 'INFO', 'WARNING'):
        assert f' {level}: ' not in outs[1], level


def test_launcher_pytorch_fails_loudly_without_its_environment(tmp_path):
    yml = _write_train_yml(tmp_path, name='no_env')
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                        'MASTER_PORT')}
    out = subprocess.run(
        [sys.executable, '-m', 'edvr_tpu_torch.train', '-opt', yml,
         '--launcher', 'pytorch', '--device', 'cpu'],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode != 0
    assert ('missing: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, '
            'MASTER_PORT') in out.stderr, out.stderr
    assert not osp.exists(osp.join(REPO, 'experiments', 'no_env'))
