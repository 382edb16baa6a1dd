"""Multi-host execution helpers.

The reference is single-process (SURVEY §2.6); this build scales across hosts
with ``jax.distributed`` + a global Mesh whose outer axis spans hosts (network) and
inner axes ride NVLink. These helpers wrap initialization and the data-feeding
convention for multi-host streaming:

- every host runs the SAME jitted step over the global mesh;
- host-fed sources feed only their addressable shard
  (``host_local_array_to_global`` pattern via jax.make_array_from_process_local_data);
- sinks drain only addressable shards; the tag sideband is kept on host 0 and
  broadcast via the normal step-boundary settings path.

Single-host fallback: everything degrades to the local-device mesh so the same
code runs on 1 chip, 1 host, N hosts (the BASELINE scaling ladder).
"""

from __future__ import annotations

import os
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed from args or env (JAX_COORDINATOR_ADDRESS…).

    Returns True if a multi-process runtime was initialized, False for
    single-process operation (no-op).
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None and num_processes is None:
        return False
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
        return jax.process_count() > 1
    except Exception:
        return False


def global_mesh(axes: Sequence[str] = ("host", "chip")) -> Mesh:
    """Mesh with hosts on the first axis (network) and local cards on the rest (NVLink)."""
    n_proc = jax.process_count()
    n_local = jax.local_device_count()
    devs = np.asarray(jax.devices()).reshape(n_proc, n_local)
    if len(axes) == 1:
        devs = devs.reshape(-1)
    return Mesh(devs, tuple(axes[: devs.ndim]))


def feed_global(x_local: np.ndarray, mesh: Mesh, spec: P) -> jax.Array:
    """Assemble a global array from this process's local shard data.

    ``x_local`` is the block of the global array this host produces (e.g. its
    slice of the wideband stream); the result is a global jax.Array usable by a
    jitted step over ``mesh``.
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(x_local, sharding)
    return jax.make_array_from_process_local_data(sharding, x_local)


def drain_local(x: jax.Array) -> np.ndarray:
    """Fetch only this host's addressable shards, concatenated in index order."""
    shards = sorted(x.addressable_shards, key=lambda s: s.index)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=-1)


def is_coordinator() -> bool:
    return jax.process_index() == 0
