"""The image-SR test configurations through the test CLI's functions and
the GAN and SR training configurations through the train CLI's, on seeded
data, with their times (ms per image or per step, peak memory): the
image_sr_test, gan_train and sr_train phases of ``chip_smoke.py`` run on
these functions. Test configurations read seeded DIV2K-validation-sized PNG pairs
(``tools/synthetic.py::write_image_pairs``); training ones take batches cut
from seeded in-memory images or clips by the port's ``paired_random_crop``
and ``augment``. The shipped YAMLs' pretrained generators are not in the
repository, so the networks start from the option file's seed (in
``chip_smoke.py`` VideoGAN's EDVR-M starts from the golden weights);
``PerceptualLoss`` warns and draws its VGG19 from seed 0 where
``vgg19-dcbb9e9d.pth`` is missing.
"""

from __future__ import annotations

import os
import os.path as osp
import random
import time

import torch

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

# name: (test YAML under options/test, its scale)
IMAGE_SR = {
    'MSRResNet_x4': ('SRResNet_SRGAN/test_MSRResNet_x4.yml', 4),
    'EDSR_Lx4': ('EDSR/test_EDSR_Lx4.yml', 4),
    'RCAN_x2': ('RCAN/test_RCAN.yml', 2),
    'RRDBNet_x4': ('ESRGAN/test_ESRGAN_x4.yml', 4),
}
# the LQ-only (SingleImageDataset) test configuration
WOGT = 'ESRGAN_x4_woGT'
TEST_YML = {**{k: v for k, (v, _) in IMAGE_SR.items()},
            WOGT: 'ESRGAN/test_ESRGAN_x4_woGT.yml'}
# a DIV2K validation image's HR size; the LQ is this over the scale
DIV2K_HR = (1356, 2040)
IMAGES = 2
# name: training YAML under options/train
GAN_TRAIN = {
    'MSRGAN_x4': 'SRResNet_SRGAN/train_MSRGAN_x4.yml',
    'ESRGAN_x4': 'ESRGAN/train_ESRGAN_x4.yml',
    'VideoGAN_EDVR_M': 'EDVR/train_EDVRM_VideoGAN_REDS.yml',
}
SR_TRAIN = {
    'MSRResNet_x4': 'SRResNet_SRGAN/train_MSRResNet_x4.yml',
    'EDSR_Lx4': 'EDSR/train_EDSR_Lx4.yml',
    'RCAN_x2': 'RCAN/train_RCAN_x2.yml',
    'RRDBNet_PSNR_x4': 'ESRGAN/train_RRDBNet_PSNR_x4.yml',
}
TRAIN_CUTS = ['pretrain_network_g: not in the repository -> the option '
              "file's seed (VideoGAN: the golden EDVR-M weights)",
              'network_d: seeded', 'data: seeded in-memory images or '
              'clips, nothing on disk', 'train.total_iter: a few steps']


def options(kind, rel, device, force=()):
    """``options/<kind>/<rel>`` parsed as the CLIs parse it
    (``train.parse_options``: TF32 off, the seed set), its pretrained
    generator cut to seeded weights, then ``force`` (``--force_yml``
    entries) applied."""
    from edvr_tpu_torch.train import parse_options
    return parse_options(kind == 'train', [
        '-opt', osp.join(ROOT, 'options', kind, rel), '--device', device,
        '--force_yml', 'path:pretrain_network_g=~', *force])


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def image_tree(root, scale, hr=DIV2K_HR):
    """Where the seeded pairs of ``scale`` lie under ``root`` (``hr`` the
    GT size), written on first use."""
    from edvr_tpu_torch.tools.synthetic import write_image_pairs
    tree = osp.join(root, f'x{scale}')
    if not osp.isdir(tree):
        write_image_pairs(tree, IMAGES, (hr[0] // scale, hr[1] // scale),
                          scale)
    return tree


def run_test(name, root, device='cuda', force=(), hr=DIV2K_HR):
    """Test configuration ``name`` (of ``TEST_YML``) through the test CLI's
    functions (``create_dataset`` -> ``create_model`` -> ``validation``,
    the results written as the YAML says) on seeded pairs under ``root``
    (the woGT one on the x4 LQ images), in the current directory: the
    network alone on the first image, then the timed pass; ``force``: more
    ``--force_yml`` entries.
    Returns (model, loader, readings)."""
    from edvr_tpu_torch.data import create_dataloader, create_dataset
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.utils import make_exp_dirs
    tree = image_tree(root, IMAGE_SR.get(name, (None, 4))[1], hr)
    roots = [f'datasets:test_1:dataroot_lq={tree}/lq']
    if name in IMAGE_SR:
        roots.append(f'datasets:test_1:dataroot_gt={tree}/gt')
    opt = options('test', TEST_YML[name], device, [*roots, *force])
    make_exp_dirs(opt)
    dataset_opt = opt['datasets']['test_1']
    loader = create_dataloader(create_dataset(dataset_opt), dataset_opt)
    model = create_model(opt)
    # the network alone on the first image (every image has its size),
    # without the host's reading, uint8 conversion, scoring and writing;
    # its first call also warms cuDNN's choice up for the timed pass
    lq = loader.dataset[0]['lq'][None].to(device)
    with torch.no_grad():
        model.net_g(lq)
        sync(device)
        t0 = time.perf_counter()
        out = model.net_g(lq)
        sync(device)
    net_ms = (time.perf_counter() - t0) * 1e3
    del out
    on_card = torch.device(device).type == 'cuda'
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.validation(loader, opt['name'], None, opt['val']['save_img'])
    sync(device)
    secs = time.perf_counter() - t0
    vis = osp.join(opt['path']['visualization'], dataset_opt['name'])
    readings = dict(
        yml=f'options/test/{TEST_YML[name]}', network=opt['network_g'],
        images=len(loader.dataset), lq_hw=list(lq.shape[2:]),
        out_hw=[opt['scale'] * n for n in lq.shape[2:]],
        ms_per_image=secs / len(loader) * 1e3,
        network_ms_per_image=net_ms,
        peak_mem_bytes=torch.cuda.max_memory_allocated() if on_card
        else None, save_img=opt['val']['save_img'],
        saved=sorted(os.listdir(vis)) if osp.isdir(vis) else [],
        metrics={k: float(v) for k, v in
                 getattr(model, 'metric_results', {}).items()})
    return model, loader, readings


def train_batches(opt, steps, seed=0):
    """``steps`` batches of the training set's size (``batch_size_per_gpu``
    x ``num_gpu``, one process feeding every device as the CLI does) and
    crop (``gt_size``): image pairs cut from 4 seeded 96 x 96 LQ images, or
    ``num_frame`` LQ windows and their centre GT frame from a seeded
    12-frame 96 x 160 clip, by the port's ``paired_random_crop`` and
    ``augment`` (flip, rot)."""
    from edvr_tpu_torch.data.transforms import augment, paired_random_crop
    from edvr_tpu_torch.tools.synthetic import seeded_clip, seeded_image_pair
    d = opt['datasets']['train']
    batch = d['batch_size_per_gpu'] * max(opt['num_gpu'], 1)
    scale, gt_size = opt['scale'], d['gt_size']
    gen = torch.Generator().manual_seed(seed)
    rng = random.Random(seed)
    hwc = lambda t: t.permute(1, 2, 0).numpy()  # noqa: E731
    chw = lambda a: torch.from_numpy(a).permute(2, 0, 1)  # noqa: E731
    video = 'num_frame' in d
    if video:
        lq_clip, gt_clip = seeded_clip(12, 96, 160, gen)
        lqs, gts = [hwc(f) for f in lq_clip], [hwc(f) for f in gt_clip]
    else:
        pairs = [seeded_image_pair(96, 96, scale, gen) for _ in range(4)]
        lqs, gts = [hwc(p[0]) for p in pairs], [hwc(p[1]) for p in pairs]
    half = d.get('num_frame', 1) // 2
    out = []
    for _ in range(steps):
        items_lq, items_gt = [], []
        for _ in range(batch):
            c = rng.randint(half, len(lqs) - 1 - half)
            gt, lq = paired_random_crop(
                gts[c], lqs[c - half:c + half + 1] if video else lqs[c],
                gt_size, scale, rng)
            frames = augment((lq if video else [lq]) + [gt], rng,
                             d['use_flip'], d['use_rot'])
            lq_t = [chw(f) for f in frames[:-1]]
            items_lq.append(torch.stack(lq_t) if video else lq_t[0])
            items_gt.append(chw(frames[-1]))
        out.append({'lq': torch.stack(items_lq),
                    'gt': torch.stack(items_gt)})
    return out


def run_steps(model, batches, warmup=1):
    """``warmup`` untimed steps, then one timed step per remaining batch,
    as the train CLI takes them (``feed_data`` + ``optimize_parameters``;
    host clock around work that ends in a synchronise; the peak from the
    first timed step). Returns the readings, the logs and each step's
    kernel launches (the nonzero entries)."""
    from edvr_tpu_torch import native
    device = model.device
    on_card = device.type == 'cuda'
    secs, logs, launches = [], [], []
    for it, batch in enumerate(batches, 1):
        if it == warmup + 1 and on_card:
            torch.cuda.reset_peak_memory_stats()
        before = dict(native.LAUNCHES)
        sync(device)
        t0 = time.perf_counter()
        model.feed_data(batch)
        model.optimize_parameters(it)
        sync(device)
        secs.append(time.perf_counter() - t0)
        logs.append(model.get_current_log())
        launches.append({k: v - before[k] for k, v in native.LAUNCHES.items()
                         if v != before[k]})
    timed = sorted(secs[warmup:])
    return dict(steps=len(batches) - warmup, warmup=warmup,
                batch=tuple(batches[0]['lq'].shape),
                gt=tuple(batches[0]['gt'].shape),
                ms_per_step_median=timed[len(timed) // 2] * 1e3,
                ms_per_step_all=[s * 1e3 for s in secs],
                peak_mem_bytes=torch.cuda.max_memory_allocated()
                if on_card else None,
                logs=logs, launches=launches)


def train_model(rel, device, force=()):
    """The engine of training YAML ``options/train/<rel>`` as the train CLI
    builds it (without its data): ``parse_options``, ``create_model``."""
    from edvr_tpu_torch.models import create_model
    opt = options('train', rel, device, force)
    return opt, create_model(opt)
