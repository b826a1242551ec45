"""Multi-process training and validation (``torch.distributed``), the
counterpart of ``edvr_tpu/parallel``."""

from edvr_tpu_torch.parallel.data_parallel import (average_gradients,
                                                   replicate_tree,
                                                   shard_batch)
from edvr_tpu_torch.parallel.dist_util import (get_dist_info, init_dist,
                                               master_only,
                                               process_allreduce_sum)

__all__ = [
    'get_dist_info', 'init_dist', 'master_only', 'process_allreduce_sum',
    'shard_batch', 'replicate_tree', 'average_gradients'
]
