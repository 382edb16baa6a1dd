"""Multi-chip parallelism (SURVEY §2.6 mapping).

The reference's intra-process parallelism (thread-pool scheduler + SIMD + lock-free
rings, Scheduler.hpp/CircularBuffer.hpp) becomes jax.sharding over a device Mesh:

- **time/sequence sharding (SP)**: overlap-save halo exchange via `ppermute` over the device interconnect
  (halo.py) — the direct analog of ring attention's neighbor passing, replacing the
  reference's HistoryBuffer carries at shard boundaries;
- **channel sharding (TP/EP)**: channelizer corner-turn via `all_to_all`
  (sharded_rx.py), per-channel demod chains local to their shard;
- **stream batching (DP)**: independent streams across a `dp` axis;
- **multi-host (DCN)**: jax.distributed initialization helpers (multihost.py).
"""

from .mesh import make_mesh, mesh_axes
from .halo import halo_left, fir_timeshard
