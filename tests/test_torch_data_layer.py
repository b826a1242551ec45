"""The rest of the port's data layer against the JAX package's, on the CPU:
``utils/flow_util`` (both file forms, each package reading the other's),
``augment`` with flows, ``REDSDataset`` with quantized flows,
``Vimeo90KDataset`` and ``REDSPackedDataset`` item for item under the same
seeds (the JAX datasets draw from the global ``random`` module, the port's
from a ``random.Random`` of the same seed), ``.tpak`` files written by each
package read by the other, ``CUDAPrefetcher`` on the CPU, and the training
CLI on packed REDS with ``prefetch_mode: cuda`` against ``cpu``.
"""

import glob
import os.path as osp
import random
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from edvr_tpu.data import transforms as jtf
from edvr_tpu.utils import flow_util as jflow
from edvr_tpu_torch.data import (CPUPrefetcher, CUDAPrefetcher,
                                 create_dataloader, create_dataset)
from edvr_tpu_torch.data import transforms as tf
from edvr_tpu_torch.native import tpak
from edvr_tpu_torch.utils import flow_util
from test_torch_grad import train_opt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(shutil.which('g++') is None,
                                reason='the tpak reader needs a C++ '
                                'compiler')

CLIPS = ('000', '001', '002')  # 000 is in REDS4: left out in training
FRAMES = 100


def _frames(seed, n, h, w):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, 3) * 255).astype(np.uint8)


@pytest.fixture(scope='module')
def reds(tmp_path_factory):
    """Three 100-frame clips (32x32 GT, 8x8 LQ, BGR as cv2 writes them),
    the centre frames' quantized flows (4 per frame, max_val 20, 16x8 PNGs
    of dx over dy) and each clip's frames as arrays."""
    root = tmp_path_factory.mktemp('reds_layer')
    clips = {}
    meta = []
    for ci, clip in enumerate(CLIPS):
        gt = _frames(ci, FRAMES, 32, 32)
        lq = np.stack([cv2.resize(f, (8, 8), interpolation=cv2.INTER_AREA)
                       for f in gt])
        clips[clip] = (gt, lq)
        rng = np.random.RandomState(10 + ci)
        for sub, arr in (('gt', gt), ('lq', lq)):
            (root / sub / clip).mkdir(parents=True)
            for i, f in enumerate(arr):
                cv2.imwrite(str(root / sub / clip / f'{i:08d}.png'), f)
        (root / 'flow' / clip).mkdir(parents=True)
        for i in range(FRAMES):
            for tag in ('_p2', '_p1', '_n1', '_n2'):
                flow = rng.uniform(-25, 25, (8, 8, 2))
                flow_util.flowwrite(flow, str(root / 'flow' / clip /
                                              f'{i:08d}{tag}.png'),
                                    quantize=True, concat_axis=0,
                                    max_val=20, norm=False)
        meta.append(f'{clip} {FRAMES} (32,32,3)\n')
    with open(root / 'meta_info.txt', 'w') as f:
        f.writelines(meta)
    return root, clips


def _reds_opt(root, **kw):
    opt = dict(name='REDS', type='REDSDataset', phase='train', scale=4,
               dataroot_gt=str(root / 'gt'), dataroot_lq=str(root / 'lq'),
               dataroot_flow=None, meta_info_file=str(root / 'meta_info.txt'),
               val_partition='REDS4', io_backend=dict(type='disk'),
               num_frame=5, gt_size=16, interval_list=[1],
               random_reverse=False, use_flip=True, use_rot=True,
               num_worker_per_gpu=0, batch_size_per_gpu=2,
               dataset_enlarge_ratio=1)
    opt.update(kw)
    return opt


def _same(a, b):
    """A port item (CHW tensors) against a JAX item (HWC arrays)."""
    assert a['key'] == b['key']
    np.testing.assert_array_equal(a['lq'].permute(0, 2, 3, 1).numpy(),
                                  b['lq'])
    np.testing.assert_array_equal(a['gt'].permute(1, 2, 0).numpy(), b['gt'])


# ---------------------------------------------------------------------- #
# flows
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('quantize', [False, True])
def test_flow_files_match_jax(tmp_path, quantize):
    """Each package reads the other's file to the same array; quantize and
    dequantize equal JAX's."""
    flow = np.random.RandomState(0).uniform(-30, 30, (6, 9, 2)).astype(
        np.float32)
    kw = dict(max_val=20, norm=False) if quantize else {}
    read_kw = dict(max_val=20, denorm=False) if quantize else {}
    ext = 'png' if quantize else 'flo'
    for i, (writer, reader) in enumerate(((flow_util, jflow),
                                          (jflow, flow_util))):
        path = str(tmp_path / f'f{i}.{ext}')
        writer.flowwrite(flow, path, quantize=quantize, concat_axis=1, **kw)
        got = reader.flowread(path, quantize=quantize, concat_axis=1,
                              **read_kw)
        want = writer.flowread(path, quantize=quantize, concat_axis=1,
                               **read_kw)
        np.testing.assert_array_equal(got, want)
    for a, b in zip(flow_util.quantize_flow(flow, 0.5, True),
                    jflow.quantize_flow(flow, 0.5, True)):
        np.testing.assert_array_equal(a, b)
    dx, dy = jflow.quantize_flow(flow, 20, False)
    np.testing.assert_array_equal(
        flow_util.dequantize_flow(dx, dy, 20, False),
        jflow.dequantize_flow(dx, dy, 20, False))
    bad = tmp_path / 'bad.flo'
    bad.write_bytes(b'NOPE')
    with pytest.raises(IOError, match='not a .flo'):
        flow_util.flowread(str(bad))


@pytest.mark.parametrize('hflip,rotation', [(True, True), (True, False),
                                            (False, True)])
def test_augment_with_flows_matches_jax(hflip, rotation):
    rng = np.random.RandomState(3)
    imgs = [rng.rand(6, 7, 3).astype(np.float32) for _ in range(3)]
    flows = [rng.randn(6, 7, 2) for _ in range(2)]
    ours = random.Random(11)
    random.seed(11)
    for _ in range(8):
        a_imgs, a_flows = tf.augment(imgs, ours, hflip, rotation, flows)
        b_imgs, b_flows = jtf.augment(imgs, hflip, rotation, flows)
        for a, b in zip(a_imgs + a_flows, b_imgs + b_flows):
            np.testing.assert_array_equal(a, b)
    one_img, one_flow = tf.augment(imgs[0], ours, hflip, rotation, flows[0])
    assert one_img.shape[2] == 3 and one_flow.shape[2] == 2


@pytest.mark.parametrize('kw', [dict(), dict(interval_list=[1, 2],
                                             random_reverse=True)])
def test_reds_flows_match_jax(reds, kw):
    """REDSDataset with ``dataroot_flow``: the window, GT and the (t, 2, h,
    w) flows (past then future, a zero flow at the centre) through the
    same crop and augmentation draw as JAX's."""
    from edvr_tpu.data.reds_dataset import REDSDataset as JaxREDS
    from edvr_tpu_torch.data.reds_dataset import REDSDataset
    root, _ = reds
    opt = _reds_opt(root, dataroot_flow=str(root / 'flow'), **kw)
    ours, ref = REDSDataset(opt, rng=random.Random(5)), JaxREDS(dict(opt))
    assert ours.keys == ref.keys and len(ours) == 200
    random.seed(5)
    for i in (0, 3, 99, 150, 199):
        a, b = ours[i], ref[i]
        _same(a, b)
        assert a['flow'].shape == (5, 2, 4, 4)
        np.testing.assert_array_equal(a['flow'].permute(0, 2, 3, 1).numpy(),
                                      b['flow'])
        assert not a['flow'][2].any()


# ---------------------------------------------------------------------- #
# Vimeo90K
# ---------------------------------------------------------------------- #
@pytest.fixture(scope='module')
def vimeo(tmp_path_factory):
    """Three septuplets (16x16 GT, 4x4 LQ) and their meta-info file."""
    root = tmp_path_factory.mktemp('vimeo')
    keys = ['00001/0001', '00001/0002', '00002/0001']
    for ki, key in enumerate(keys):
        gt = _frames(20 + ki, 7, 16, 16)
        for sub, arr in (('gt', gt), ('lq', [cv2.resize(
                f, (4, 4), interpolation=cv2.INTER_AREA) for f in gt])):
            (root / sub / key).mkdir(parents=True)
            for i, f in enumerate(arr, 1):
                cv2.imwrite(str(root / sub / key / f'im{i}.png'), f)
    with open(root / 'meta.txt', 'w') as f:
        f.writelines(f'{k} (256,448,3)\n' for k in keys)
    return root


@pytest.mark.parametrize('num_frame,reverse', [(7, False), (5, True),
                                               (3, True)])
def test_vimeo90k_items_match_jax(vimeo, num_frame, reverse):
    from edvr_tpu.data.vimeo90k_dataset import Vimeo90KDataset as JaxVimeo
    from edvr_tpu_torch.data.vimeo90k_dataset import Vimeo90KDataset
    opt = dict(name='Vimeo', type='Vimeo90KDataset', phase='train', scale=4,
               dataroot_gt=str(vimeo / 'gt'), dataroot_lq=str(vimeo / 'lq'),
               meta_info_file=str(vimeo / 'meta.txt'),
               io_backend=dict(type='disk'), num_frame=num_frame, gt_size=8,
               random_reverse=reverse, use_flip=True, use_rot=True)
    ours, ref = Vimeo90KDataset(opt, rng=random.Random(9)), JaxVimeo(
        dict(opt))
    assert ours.keys == ref.keys and ours.neighbor_list == ref.neighbor_list
    random.seed(9)
    for i in (0, 1, 2, 1, 0, 2):
        a, b = ours[i], ref[i]
        _same(a, b)
        assert a['lq'].shape == (num_frame, 3, 2, 2)
        assert ours.neighbor_list == ref.neighbor_list
    with pytest.raises(NotImplementedError, match='A.9'):
        Vimeo90KDataset(dict(opt, io_backend=dict(type='lmdb')))
    assert create_dataset(opt).__class__ is Vimeo90KDataset


# ---------------------------------------------------------------------- #
# tpak and packed REDS
# ---------------------------------------------------------------------- #
@pytest.fixture(scope='module')
def paks(reds, tmp_path_factory):
    """The REDS tree as .tpak files, GT and LQ, written by the port and by
    the JAX package."""
    from edvr_tpu.native import write_tpak as jwrite
    _, clips = reds
    out = tmp_path_factory.mktemp('paks')
    paths = {}
    for who, write in (('port', tpak.write_tpak), ('jax', jwrite)):
        for i, sub in enumerate(('gt', 'lq')):
            path = str(out / f'{who}_{sub}.tpak')
            # the port's writer also takes callables
            write(path, [(c, (lambda a=a[i]: a) if who == 'port' else a[i])
                         for c, a in clips.items()])
            paths[who, sub] = path
    return paths


def test_tpak_files_cross_read(paks, reds):
    """Both writers give the same bytes; each reader reads both, window by
    window, as numpy slices them (a reversed interval and clamping
    included)."""
    from edvr_tpu.native import TpakReader as JaxReader
    _, clips = reds
    for sub in ('gt', 'lq'):
        with open(paks['port', sub], 'rb') as f, \
                open(paks['jax', sub], 'rb') as g:
            assert f.read() == g.read()
    args = (np.array([1, 2, 0]), np.array([97, 3, 50]), np.array([2, -1, 1]),
            np.array([1, 0, 4]), np.array([2, 3, 0]), 4, 4, 5)
    for path in (paks['port', 'lq'], paks['jax', 'lq']):
        readers = (tpak.TpakReader(path), JaxReader(path))
        for r in readers:
            assert r.clip_names == list(CLIPS)
            assert r.clip_frames == [FRAMES] * 3
            assert r.clip_shapes == [(8, 8, 3)] * 3
        got = readers[0].read_windows(*args, n_threads=2)
        np.testing.assert_array_equal(got, readers[1].read_windows(*args))
        frame = min(97 + 2 * 4, FRAMES - 1)
        np.testing.assert_array_equal(got[0, 4],
                                      clips['001'][1][frame, 1:5, 2:6])
    with pytest.raises(ValueError, match='failed'):
        readers[0].read_windows([0], [0], [1], [6], [0], 4, 4, 1)
    with pytest.raises(IOError, match='cannot open'):
        tpak.TpakReader(str(osp.dirname(path)) + '/missing.tpak')


def test_tpak_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises with the compiler's output."""
    bad = tmp_path / 'tpak.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(tpak, '_SRC', str(bad))
    monkeypatch.setattr(tpak, 'BUILD_DIR', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        tpak.build()


def _packed_opt(paks, who='port', **kw):
    return dict(_reds_opt(Path('.'), **kw), type='REDSPackedDataset',
                dataroot_gt=paks[who, 'gt'], dataroot_lq=paks[who, 'lq'],
                meta_info_file=None)


@pytest.mark.parametrize('kw', [dict(), dict(interval_list=[1, 2, 3],
                                             random_reverse=True),
                                dict(num_frame=3, use_rot=False)])
def test_reds_packed_items_match_jax(paks, kw):
    from edvr_tpu.data.reds_packed_dataset import REDSPackedDataset as JaxPk
    from edvr_tpu_torch.data.reds_packed_dataset import REDSPackedDataset
    opt = _packed_opt(paks, **kw)
    ours = REDSPackedDataset(opt, rng=random.Random(3))
    ref = JaxPk(dict(opt, dataroot_gt=paks['jax', 'gt'],
                     dataroot_lq=paks['jax', 'lq']))
    assert ours.keys == ref.keys and len(ours) == 200
    random.seed(3)
    for i in (0, 1, 50, 99, 100, 173, 199):
        _same(ours[i], ref[i])
    assert create_dataset(opt).__class__ is REDSPackedDataset


# ---------------------------------------------------------------------- #
# prefetchers and the training CLI
# ---------------------------------------------------------------------- #
def test_cuda_prefetcher_on_cpu_gives_cpu_prefetchers_batches(paks):
    """On the CPU (the caller's choice) CUDAPrefetcher hands out
    CPUPrefetcher's batches in order over two epochs, reset at each start
    as the training loop resets them, and then None; a CUDA device without
    a card raises."""
    opt = _packed_opt(paks, batch_size_per_gpu=16)
    runs = []
    for cls in (CPUPrefetcher, CUDAPrefetcher):
        dataset = create_dataset(dict(opt, seed=4))
        loader = create_dataloader(dataset, opt, seed=4)
        pre = cls(loader) if cls is CPUPrefetcher else cls(loader, 'cpu')
        batches = []
        for _ in range(2):
            pre.reset()
            batch = pre.next()
            while batch is not None:
                batches.append(batch)
                batch = pre.next()
        runs.append(batches)
    assert len(runs[0]) == len(runs[1]) == 2 * (200 // 16)
    for a, b in zip(*runs):
        assert a['key'] == b['key']
        assert torch.equal(a['lq'], b['lq']) and torch.equal(a['gt'],
                                                             b['gt'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            CUDAPrefetcher(loader, 'cuda')


def _packed_yml(tmp_path, paks, mode):
    opt = train_opt(total_iter=2, tsa_iter=1)
    opt['name'] = f'packed_{mode}'
    opt['datasets'] = dict(train=dict(
        _packed_opt(paks, gt_size=16, use_shuffle=True, prefetch_mode=mode),
        name='REDS'))
    opt['logger'] = dict(print_freq=1, save_checkpoint_freq=100,
                         use_tb_logger=False)
    yml = str(tmp_path / f'packed_{mode}.yml')
    with open(yml, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    return yml


def test_train_cli_packed_reds_prefetch_modes(tmp_path, monkeypatch, paks):
    """The training CLI (``--device cpu``) on a tiny EDVR from
    REDSPackedDataset: 2 steps with ``prefetch_mode: cuda`` give the
    losses and weights of the same run with ``cpu``; an unknown mode
    raises."""
    from edvr_tpu_torch import train
    monkeypatch.chdir(tmp_path)
    runs = {}
    for mode in ('cuda', 'cpu'):
        model = train.main(['-opt', _packed_yml(tmp_path, paks, mode),
                            '--device', 'cpu'])
        log = open(glob.glob(str(tmp_path / 'experiments' / f'packed_{mode}'
                                 / 'train_*.log'))[0]).read()
        assert (('CUDAPrefetcher' if mode == 'cuda' else 'CPUPrefetcher')
                in log)
        losses = [line.split('l_pix:')[1].split()[0]
                  for line in log.splitlines() if 'l_pix:' in line]
        assert len(losses) == 2
        runs[mode] = (losses, model.net_g.state_dict())
    assert runs['cuda'][0] == runs['cpu'][0]
    for k, v in runs['cuda'][1].items():
        assert torch.equal(v, runs['cpu'][1][k]), k
    with pytest.raises(ValueError, match='prefetch_mode'):
        train.main(['-opt', _packed_yml(tmp_path, paks, 'disk'), '--device',
                    'cpu'])
