"""Data parallelism over ``torch.distributed`` (counterpart of
``adascale/parallel``)."""
from .mesh import (  # noqa: F401
    all_gather_rows,
    assemble_batch,
    create_hybrid_mesh,
    create_mesh,
    gather_batch,
    gather_rows,
    local_batch_size,
    mesh_device,
    mesh_rank,
    mesh_size,
    per_process_seed,
    reduce_gradients,
    replicate,
    shard_batch,
)
