"""Device mesh setup for multi-chip / multi-host runs.

Reference analog: none -- zotmer is single-process (SURVEY.md section 1); this
layer is new design required by BASELINE. One 1-D mesh axis ``shards`` spans
all devices (hosts x devices_per_host); the k-mer key space is partitioned
across it by key prefix (semantics.shard_of_u64). Every device reaches every
other at the same rate on an NVLink host, so the mesh follows the algorithm
alone; on GPUs XLA hands the all-to-all and psum collectives to NCCL.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh

AXIS = "shards"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n & (n - 1):
        raise ValueError(f"device count must be a power of two, got {n}")
    if n > len(devs):
        # a silent devs[:n] clamp would build a SMALLER mesh whose capacity
        # math (sized for n shards) quietly overflows -- fail loudly instead
        raise ValueError(f"requested a {n}-device mesh but only {len(devs)} "
                         f"device(s) are visible")
    return Mesh(np.asarray(devs[:n]), (AXIS,))


def shard_bits(n_shards: int) -> int:
    """log2(n_shards): number of leading key bits that select the owner."""
    p = int(math.log2(n_shards))
    if (1 << p) != n_shards:
        raise ValueError(f"n_shards must be a power of two, got {n_shards}")
    return p


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host bring-up via jax.distributed (no-op single process).

    Each host calls this before building the mesh; the same shard_map
    program then spans every device of every host.
    """
    if num_processes and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
