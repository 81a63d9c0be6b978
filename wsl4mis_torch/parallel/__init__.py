"""Data parallelism over processes: the port's counterpart of the JAX
package's data mesh (``mesh``)."""

from .mesh import (
    Mesh,
    active,
    average_gradients,
    barrier,
    calls,
    check_batch,
    close_mesh,
    current_mesh,
    global_batch,
    global_mean,
    global_sum,
    global_sums,
    local_rows,
    make_mesh,
    rank,
    replicate_tree,
    row_segments,
    shard_batch,
    spawn,
    visible_cards,
    world_size,
)

__all__ = [
    "Mesh", "active", "average_gradients", "barrier", "calls", "check_batch",
    "close_mesh", "current_mesh", "global_batch", "global_mean", "global_sum", "global_sums",
    "local_rows",
    "make_mesh", "rank", "replicate_tree", "row_segments", "shard_batch",
    "spawn", "visible_cards", "world_size",
]
