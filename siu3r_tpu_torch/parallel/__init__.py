"""Data parallelism over a ``torch.distributed`` process group, counterpart
of ``siu3r_tpu/parallel/``."""

from siu3r_tpu_torch.parallel.group import (
    all_gather_flat,
    all_reduce_mean_,
    all_reduce_sum_,
    barrier,
    gather_to_rank0,
    init_distributed,
    is_distributed,
    rank,
    shard_batch,
    shard_slice,
    shutdown,
    stats,
    world_size,
)

__all__ = [
    "all_gather_flat",
    "all_reduce_mean_",
    "all_reduce_sum_",
    "barrier",
    "gather_to_rank0",
    "init_distributed",
    "is_distributed",
    "rank",
    "shard_batch",
    "shard_slice",
    "shutdown",
    "stats",
    "world_size",
]
