"""Device mesh construction helpers."""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Sequence[int] | None = None,
              axes: Sequence[str] = ("dp", "sp"),
              devices: Sequence[jax.Device] | None = None) -> Mesh:
    """Create a Mesh over the available devices.

    Default factorization: put as much as possible on the last axis (sequence/
    channel sharding), remainder on the first (data parallel). The cards of
    one host are joined all to all by NVLink, so the factorization follows
    the algorithm alone.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        else:
            dp = 1
            # prefer a small power-of-two dp if n has one
            for cand in (2, 4):
                if n % cand == 0 and n // cand > 1:
                    dp = cand
                    break
            shape = (dp, n // dp) + (1,) * (len(axes) - 2)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} ≠ {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axes))


def mesh_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def shard_over(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
