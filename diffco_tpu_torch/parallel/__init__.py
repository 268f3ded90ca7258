"""Multi-device scale-out on torch.distributed (``parallel.sharding``)."""
from .sharding import (
    make_mesh, data_axis, shard_batch, replicate, sharded_score_sweep,
    support_parallel_score_fn, sharded_gram, sharded_label_sweep,
    distributed_fit, distributed_fit_lazy, distributed_trajopt,
    distributed_fit_step, distributed_trajopt_step, rank_local,
)
