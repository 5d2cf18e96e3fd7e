"""Data-parallel training over torch.distributed."""

from .mesh import (  # noqa: F401
    DataParallel,
    all_reduce_flat,
    barrier,
    batch_stats,
    broadcast_module,
    check_mesh,
    init_distributed,
    rand_rows,
    scope,
    shutdown,
)
