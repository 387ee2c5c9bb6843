"""Device mesh setup and the multi-host runtime entry.

Replaces the reference's fork/TCP machinery (libmasa.cpp:540-642,
io/SocketCellsReader.cpp) with the JAX distributed runtime: `ppermute`
between devices for boundary columns, `jax.distributed` over the network
for control.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-host init (jax.distributed over the network).  No-op when single
    process."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
