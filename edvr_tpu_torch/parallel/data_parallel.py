"""Data parallelism over the ranks of a process group, the counterpart of
``edvr_tpu/parallel/mesh.py``.

The JAX package jits its step over a 1-D device mesh: the parameters
replicated (``replicate_tree``), the batch split on dim 0 (``shard_batch``)
and the gradients' all-reduce compiled into the step. Here each rank is a
process that holds a whole copy of every network and its own part of the
global batch: :func:`replicate_tree` broadcasts rank 0's parameters and
buffers once the networks are built and loaded, :func:`shard_batch` takes a
rank's rows of a global batch, and :func:`average_gradients` takes the mean
of the gradients over the ranks after ``backward``, before anything reads
them (the TSA mask, the lr multipliers, Adam). The mean of equal-sized
per-rank means is the global batch's mean, so with losses that average
over the batch a step equals one process's step on the global batch. (A
loss with ``reduction: sum`` gives the global sum over the world size, as
BasicSR's DDP does; Adam's step does not see that scale but through its
eps.)

The collectives are explicit, not ``nn.parallel.DistributedDataParallel``:
DDP's reducer syncs only when its own ``forward`` runs, which the bf16
step's ``torch.func.functional_call``, StyleGAN2's R1 and path-length
``autograd.grad`` and EDVR's ``remat`` checkpoints go around; and the
networks keep their state-dict keys and classes. Terms that mix samples
(BatchNorm's batch moments, ESRGAN's relativistic means, the path
length's mean) take their moments over the global batch through
:func:`all_reduce_sum`, which the backward pass reduces again.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from edvr_tpu_torch.parallel.dist_util import get_dist_info, is_dist


def _coalesced(tensors, collective):
    """Run ``collective`` in place on one flat copy of ``tensors`` per
    dtype and device, then copy the results back (one multi-tensor copy,
    not one launch per tensor)."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        parts = flat.split([t.numel() for t in group])
        torch._foreach_copy_(group, [p.view_as(t)
                                     for p, t in zip(parts, group)])


@torch.no_grad()
def replicate_tree(*modules):
    """Give every rank rank 0's parameters and buffers of ``modules``, by
    one broadcast per dtype; outside a process group nothing happens.
    Each rank builds its networks from its own generators
    (``set_random_seed(seed + rank)``), so this is what makes them one
    model."""
    if not is_dist():
        return
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    _coalesced(tensors, lambda flat: dist.broadcast(flat, src=0))


def shard_batch(x):
    """This rank's rows of a global batch ``x`` (dim 0, split evenly)."""
    rank, world = get_dist_info()
    if x.shape[0] % world:
        raise ValueError(f'a global batch of {x.shape[0]} does not split '
                         f'over {world} ranks')
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


@torch.no_grad()
def average_gradients(params):
    """Replace each ``.grad`` of ``params`` by its mean over the ranks: one
    coalesced all-reduce per dtype (flatten, reduce, unflatten). Every rank
    must pass the same parameters with the same gradients set. Inside a
    process group it runs at world size 1 too; outside it is nothing."""
    if not is_dist():
        return
    world = dist.get_world_size()
    grads = [p.grad for p in params if p.grad is not None]

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(world)

    _coalesced(grads, mean)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the ranks' gradients summed."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def syncs_batch() -> bool:
    """Whether terms over the batch must be taken over the global batch:
    inside a process group of more than one rank."""
    return is_dist() and dist.get_world_size() > 1


def all_reduce_sum(x):
    """``x`` summed over the ranks, differentiably; ``x`` itself outside a
    process group of more than one rank."""
    return _AllReduceSum.apply(x) if syncs_batch() else x


def global_mean(x):
    """The mean of ``x``'s entries over every rank's ``x`` (all of one
    shape), differentiably: the global batch's mean of a per-sample term."""
    if not syncs_batch():
        return x.mean()
    return all_reduce_sum(x.sum()) / (x.numel() * dist.get_world_size())
