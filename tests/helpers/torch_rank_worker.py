"""One rank of a multi-process ``edvr_tpu_torch`` run on the CPU (gloo),
spawned by tests/test_torch_parallel.py with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in its environment, as
``torchrun`` sets them. It imports neither JAX nor ``edvr_tpu``.

Usage: torch_rank_worker.py <tasks.pt>

``tasks.pt`` (``torch.save``) holds a list of tasks, run in order:

* ``{'kind': 'steps', 'name', 'opt', 'batches', 'pretrain', 'out'}``: the
  engine of the option dict ``opt`` (``parse_dict``'d under ``out``) with
  ``--launcher pytorch``'s settings; rank 0 loads the ``pretrain`` weights
  (the other ranks start from their own seed and get rank 0's by the
  engine's broadcast); one step per global batch of ``batches``, this rank
  fed its rows; writes ``<out>/rank<r>.pt`` with the networks' state
  dicts, every step's gradients (after the mean over the ranks) and its
  log.
* ``{'kind': 'cli', 'module': 'train' | 'test', 'args', 'out'}``: the CLI's
  ``main(args)`` (its ``--launcher pytorch`` given in ``args``); for the
  test CLI rank 0 writes the metric tables to ``out``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

import torch  # noqa: E402


def run_steps(task):
    from edvr_tpu_torch.models import create_model
    from edvr_tpu_torch.parallel import get_dist_info, shard_batch
    from edvr_tpu_torch.utils.options import parse_dict
    rank, world = get_dist_info()
    opt = parse_dict(task['opt'], is_train=True,
                     root=os.path.join(task['out'], f'rank{rank}'))
    opt.update(dist=True, rank=rank, world_size=world, device='cpu')
    for suffix, path in task['pretrain'].items():
        opt['path'][f'pretrain_network_{suffix}'] = path if rank == 0 else None
    model = create_model(opt)
    nets = {k: v for k, v in vars(model).items()
            if k in ('net_g', 'net_d')}
    logs, grads = [], []
    for it, batch in enumerate(task['batches'], start=1):
        model.feed_data({k: shard_batch(v) for k, v in batch.items()})
        model.optimize_parameters(it)
        logs.append(model.get_current_log())
        grads.append({name: {n: p.grad.clone()
                             for n, p in net.named_parameters()
                             if p.grad is not None}
                      for name, net in nets.items()})
    torch.save({'state': {name: net.state_dict()
                          for name, net in nets.items()},
                'grads': grads, 'logs': logs},
               os.path.join(task['out'], f'rank{rank}.pt'))


def run_cli(task):
    import numpy as np

    from edvr_tpu_torch import test, train
    from edvr_tpu_torch.parallel import get_dist_info
    model = {'train': train, 'test': test}[task['module']].main(task['args'])
    if task.get('out') and get_dist_info()[0] == 0:
        np.savez(task['out'], **model.metric_results)


def main():
    torch.set_num_threads(1)
    from edvr_tpu_torch.parallel import init_dist
    init_dist('pytorch', device='cpu')
    for task in torch.load(sys.argv[1], weights_only=False):
        {'steps': run_steps, 'cli': run_cli}[task['kind']](task)
    print('RANK_OK', flush=True)


if __name__ == '__main__':
    main()
