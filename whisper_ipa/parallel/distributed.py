"""Multi-host initialization and host-local data sharding.

Thin wrapper over jax.distributed for multi-host clusters: initialize once
per process, build the global mesh over all devices, and assemble global
batches from host-local shards (each host reads only its own slice of the
dataset, keyed on process_index — the input-pipeline pattern the reference
never needed single-box but a pod requires).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_device_count": jax.local_device_count(),
        "global_device_count": jax.device_count(),
    }


def local_shard_indices(n_items: int) -> Sequence[int]:
    """Dataset indices owned by this host (contiguous block partition)."""
    p = jax.process_index()
    n = jax.process_count()
    per = (n_items + n - 1) // n
    return list(range(p * per, min((p + 1) * per, n_items)))


def global_batch_from_local(mesh: Mesh, local_batch: np.ndarray):
    """Assemble a globally-sharded array from this host's local shard.

    local_batch: this process's rows of the global batch. The global batch
    size is local_batch.shape[0] * process_count; rows land on the 'data'
    mesh axis without any cross-host copy.
    """
    sharding = NamedSharding(
        mesh, P("data", *([None] * (local_batch.ndim - 1)))
    )
    return jax.make_array_from_process_local_data(sharding, local_batch)
