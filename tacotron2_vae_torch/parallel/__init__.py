"""Data and tensor parallelism over torch.distributed."""

from .mesh import (  # noqa: F401
    Grid,
    Shard,
    all_reduce_flat,
    barrier,
    batch_stats,
    broadcast_module,
    check_mesh,
    init_distributed,
    rand_cols,
    rand_rows,
    scope,
    shutdown,
)
