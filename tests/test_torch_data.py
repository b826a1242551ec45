"""The port's training data layer (edvr_tpu_torch/data) against the JAX
package's: transforms, REDSDataset, EnlargedSampler, FileClient and the
training loader, on a synthetic REDS tree (100 PNG frames per clip, as
tests/test_train_e2e.py builds it).

The JAX functions draw from the global ``random`` module, seeded with
``random.seed``; the port's from a ``random.Random`` of the same seed.
Items must be identical, array for array.
"""

import random

import cv2
import numpy as np
import pytest
import torch

from edvr_tpu.data import transforms as jtf
from edvr_tpu.data.data_sampler import EnlargedSampler as JaxSampler
from edvr_tpu.data.reds_dataset import REDSDataset as JaxREDSDataset
from edvr_tpu.utils.img_util import imfrombytes as j_imfrombytes
from edvr_tpu_torch.data import (CPUPrefetcher, EnlargedSampler,
                                 create_dataloader, create_dataset)
from edvr_tpu_torch.data import transforms as tf
from edvr_tpu_torch.data.file_client import FileClient
from edvr_tpu_torch.data.reds_dataset import REDSDataset
from edvr_tpu_torch.utils import imfrombytes
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope='module')
def reds_root(tmp_path_factory):
    """Two 100-frame clips (32x32 GT, 8x8 bicubic LQ) plus a REDS4 clip
    that the REDS4 partition must leave out."""
    root = tmp_path_factory.mktemp('reds')
    rng = np.random.RandomState(1)
    meta = []
    for clip in ('000', '001', '002'):
        (root / 'gt' / clip).mkdir(parents=True)
        (root / 'lq' / clip).mkdir(parents=True)
        for i in range(100):
            gt = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / 'gt' / clip / f'{i:08d}.png'), gt)
            cv2.imwrite(str(root / 'lq' / clip / f'{i:08d}.png'),
                        cv2.resize(gt, (8, 8), interpolation=cv2.INTER_CUBIC))
        meta.append(f'{clip} 100 (32,32,3)\n')
    with open(root / 'meta_info.txt', 'w') as f:
        f.writelines(meta)
    return root


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


@pytest.mark.parametrize('kw', [
    dict(),
    dict(interval_list=[1, 2, 3], random_reverse=True),
    dict(num_frame=3, interval_list=[2, 4], use_rot=False),
    dict(use_flip=False, use_rot=False, gt_size=32),
])
def test_reds_items_match_jax(reds_root, kw):
    opt = _reds_opt(reds_root, **kw)
    ours = REDSDataset(opt, rng=random.Random(7))
    ref = JaxREDSDataset(dict(opt))
    assert ours.keys == ref.keys and len(ours) == 200  # clip 000 left out
    random.seed(7)
    for i in (0, 1, 57, 98, 99, 120, 199):
        a, b = ours[i], ref[i]
        assert a['key'] == b['key']
        np.testing.assert_array_equal(a['lq'].permute(0, 2, 3, 1).numpy(),
                                      b['lq'])
        np.testing.assert_array_equal(a['gt'].permute(1, 2, 0).numpy(),
                                      b['gt'])
        t = opt['num_frame']
        s = opt['gt_size']
        assert a['lq'].shape == (t, 3, s // 4, s // 4)
        assert a['gt'].shape == (3, s, s)


def test_reds_refuses_what_is_not_ported(reds_root):
    # optical flows are ported (tests/test_torch_data_layer.py): a flow
    # root is taken, and an item without its flow files fails to read them
    with pytest.raises(FileNotFoundError, match='_p2.png'):
        REDSDataset(_reds_opt(reds_root, dataroot_flow='x'))[0]
    with pytest.raises(NotImplementedError, match='lmdb'):
        REDSDataset(_reds_opt(reds_root, io_backend=dict(type='lmdb')))
    with pytest.raises(ValueError, match='partition'):
        REDSDataset(_reds_opt(reds_root, val_partition='nope'))


@pytest.mark.parametrize('frames', [1, 3])
def test_paired_random_crop_matches_jax(frames):
    rng = np.random.RandomState(frames)
    lqs = [rng.rand(9, 13, 3).astype(np.float32) for _ in range(frames)]
    gts = [rng.rand(36, 52, 3).astype(np.float32) for _ in range(frames)]
    if frames == 1:
        lqs, gts = lqs[0], gts[0]
    for seed in range(5):
        random.seed(seed)
        want = jtf.paired_random_crop(gts, lqs, 16, 4)
        got = tf.paired_random_crop(gts, lqs, 16, 4, random.Random(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError, match='times the scale'):
        tf.paired_random_crop(gts, lqs, 16, 3, random.Random(0))


@pytest.mark.parametrize('hflip,rotation', [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_augment_matches_jax(hflip, rotation):
    rng = np.random.RandomState(0)
    imgs = [rng.rand(6, 6, 3).astype(np.float32) for _ in range(3)]
    for seed in range(8):
        random.seed(seed)
        want, want_status = jtf.augment(imgs, hflip, rotation,
                                        return_status=True)
        got, status = tf.augment(imgs, random.Random(seed), hflip, rotation,
                                 return_status=True)
        assert status == want_status
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_mod_crop_and_img_rotate_match_jax():
    img = np.random.RandomState(0).rand(19, 22, 3).astype(np.float32)
    np.testing.assert_array_equal(tf.mod_crop(img, 4), jtf.mod_crop(img, 4))
    np.testing.assert_array_equal(tf.img_rotate(img, 30),
                                  jtf.img_rotate(img, 30))
    with pytest.raises(ValueError):
        tf.mod_crop(img[None], 4)


@pytest.mark.parametrize('replicas,rank,ratio', [(1, 0, 1), (1, 0, 3),
                                                 (4, 2, 5)])
def test_enlarged_sampler_matches_jax(replicas, rank, ratio):
    data = list(range(11))
    ours = EnlargedSampler(data, replicas, rank, ratio)
    ref = JaxSampler(data, replicas, rank, ratio)
    assert len(ours) == len(ref)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(ours) == list(ref)


def test_file_client_and_imfrombytes(reds_root):
    path = reds_root / 'gt' / '001' / '00000003.png'
    content = FileClient('disk').get(path)
    assert content == path.read_bytes()
    for float32 in (False, True):
        np.testing.assert_array_equal(imfrombytes(content, float32=float32),
                                      j_imfrombytes(content,
                                                    float32=float32))
    with pytest.raises(ValueError, match='not supported'):
        FileClient('lmdb')


@pytest.mark.parametrize('workers', [0, 1])
def test_train_loader(reds_root, workers):
    """Batches of the training loader: shapes, drop_last, and the same
    batches from the same seed, with and without (spawned, reseeded)
    workers."""
    opt = _reds_opt(reds_root, batch_size_per_gpu=3,
                    num_worker_per_gpu=workers)
    runs = []
    for _ in range(2):
        dataset = create_dataset(dict(opt, seed=5))
        sampler = EnlargedSampler(dataset, 1, 0, 1)
        loader = create_dataloader(dataset, opt, sampler=sampler, seed=5)
        assert len(loader) == 200 // 3  # the last partial batch is dropped
        prefetcher = CPUPrefetcher(loader)
        batches = [prefetcher.next() for _ in range(2)]
        prefetcher.reset()
        assert prefetcher.next()['key'] == batches[0]['key']
        runs.append(batches)
    for a, b in zip(*runs):
        assert a['lq'].shape == (3, 5, 3, 4, 4) and a['gt'].shape == (3, 3,
                                                                      16, 16)
        assert a['key'] == b['key']
        assert torch.equal(a['lq'], b['lq']) and torch.equal(a['gt'],
                                                             b['gt'])


def test_worker_reseeding(monkeypatch, reds_root):
    """A loader worker reseeds its copy of the dataset's generator from its
    torch seed, so workers draw apart and a run repeats from its seed."""
    from edvr_tpu_torch import data as pdata
    dataset = REDSDataset(_reds_opt(reds_root), rng=random.Random(0))
    info = type('Info', (), {'dataset': dataset})
    monkeypatch.setattr(torch.utils.data, 'get_worker_info', lambda: info)
    draws = []
    for seed in (11, 12, 11):
        torch.manual_seed(seed)
        pdata._seed_worker(0)
        draws.append([dataset.rng.random() for _ in range(3)])
    assert draws[0] == draws[2] != draws[1]
    expect = random.Random(11)  # torch.manual_seed(11) -> initial_seed 11
    assert draws[0] == [expect.random() for _ in range(3)]


class _Log:
    """A logger that keeps its messages."""

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


@pytest.mark.parametrize('num_gpu', [0, 2])
def test_num_gpu_batch_and_epochs_match_jax(reds_root, num_gpu):
    """Without a launcher one process feeds all num_gpu devices: the
    training CLI's loader batches batch_size_per_gpu x num_gpu items with
    num_worker_per_gpu x num_gpu workers, and the iterations per epoch and
    the epoch count follow, as in the JAX CLI."""
    from edvr_tpu.train import create_train_val_dataloader as j_create
    from edvr_tpu_torch.train import create_train_val_dataloader
    opts, logs, results = [], [], []
    for _ in range(2):
        opts.append(dict(
            num_gpu=num_gpu, dist=False, rank=0, world_size=1,
            manual_seed=5, train=dict(total_iter=1000),
            datasets=dict(train=_reds_opt(reds_root, batch_size_per_gpu=3,
                                          num_worker_per_gpu=1,
                                          dataset_enlarge_ratio=4))))
        logs.append(_Log())
    for create, opt, log in zip((create_train_val_dataloader, j_create),
                                opts, logs):
        loader, _, _, total_epochs, total_iters = create(opt, log)
        per_epoch = [int(ln.split('per epoch: ')[1].split()[0])
                     for ln in log.lines if 'per epoch: ' in ln]
        results.append((loader.batch_size, loader.num_workers, per_epoch,
                        total_epochs, total_iters))
    ours, ref = results
    multiplier = max(num_gpu, 1)
    assert ours == ref
    assert ours[:3] == (3 * multiplier, multiplier,
                        [-(-200 * 4 // (3 * multiplier))])
