"""Process identity and the collectives outside the training step
(reference: basicsr/utils/dist_util.py:10-83), the counterpart of
``edvr_tpu/parallel/dist_util.py``.

The launcher is the reference's ``pytorch`` one: every rank is started
with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in its environment (as ``torchrun`` sets them) and joins
the process group by ``env://``. The backend follows the run's device:
NCCL on ``cuda`` (each rank on card ``LOCAL_RANK``), gloo on ``cpu``.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.distributed as dist

# what --launcher pytorch reads from the environment
LAUNCHER_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT')


def init_dist(launcher: str = 'pytorch', device='cuda') -> None:
    """Join the process group of a multi-process run.

    ``--launcher pytorch`` asks for a distributed run, so a missing
    variable of :data:`LAUNCHER_ENV` fails here, naming it, instead of
    running as one process (as ``edvr_tpu/parallel/dist_util.py:45-55``
    fails for ``--launcher jax``). On ``cuda`` the backend is NCCL, and a
    machine without CUDA raises; on ``cpu`` it is gloo. A process that has
    joined its group already stays in it.
    """
    if launcher in ('none', None) or is_dist():
        return
    if launcher != 'pytorch':
        raise ValueError(f'launcher {launcher!r}: expected none or pytorch')
    missing = [k for k in LAUNCHER_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f'--launcher pytorch needs {", ".join(LAUNCHER_ENV)} in the '
            f'environment (as torchrun sets them); missing: '
            f'{", ".join(missing)}. Use --launcher none for one process.')
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('--launcher pytorch on cuda needs NCCL and a '
                               'CUDA card; pass --device cpu for gloo')
        torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
        backend = 'nccl'
    else:
        backend = 'gloo'
    dist.init_process_group(backend=backend, init_method='env://',
                            rank=int(os.environ['RANK']),
                            world_size=int(os.environ['WORLD_SIZE']))


def is_dist() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def get_dist_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group
    (reference: dist_util.py:61-72)."""
    if is_dist():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def collective_device() -> torch.device:
    """Where the backend's collectives take their tensors: this rank's
    card under NCCL, the CPU under gloo."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def process_allreduce_sum(x):
    """Sum a host-side numpy table across ranks, in float64, on the
    backend's device; the result has ``x``'s dtype. The reference's
    ``dist.reduce`` + ``barrier`` over rank-strided validation shards
    (reference: basicsr/models/video_base_model.py:109-113). Inside a
    process group it runs the collective, at world size 1 too; outside it
    is the identity."""
    x = np.asarray(x)
    if not is_dist():
        return x
    t = torch.from_numpy(x.astype(np.float64)).to(collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy().astype(x.dtype)


def master_only(func):
    """Run ``func`` on rank 0 only; other ranks get None
    (reference: dist_util.py:75-83)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_dist_info()[0] == 0:
            return func(*args, **kwargs)
        return None

    return wrapper
