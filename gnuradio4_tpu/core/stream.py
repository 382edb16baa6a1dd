"""Time-block stream model.

The reference moves *samples* one-at-a-time (or small spans) through lock-free ring
buffers (reference: core/include/gnuradio-4.0/CircularBuffer.hpp). The device-native
inversion: a stream is a sequence of fixed-shape **time blocks** — arrays of shape
``[channels, block_len]`` (or ``[block_len]`` for single-channel) — that flow through a
jitted program once per scheduler step. All shapes are static so XLA can tile onto the
matrix and vector units; rate changes are resolved at *compile* time by the graph's rate algebra
(compiler.py), the analog of the reference's per-work() ``computeResampling``
(core/include/gnuradio-4.0/Block.hpp:1611).

``StreamSpec`` is the type that rides on ports/edges — the analog of the sample type +
``PortMetaInfo`` (SI units etc., reference Port.hpp:178).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any

import jax.numpy as jnp
import numpy as np

# Canonical sample dtypes. Device compute favors f32/bf16; complex is carried natively by
# XLA as c64 (two f32 lanes) which maps fine onto the vector units; matmul paths split re/im.
DTYPES = {
    "float32": jnp.float32,
    "float64": jnp.float64,
    "bfloat16": jnp.bfloat16,
    "complex64": jnp.complex64,
    "int32": jnp.int32,
    "int16": jnp.int16,
    "int8": jnp.int8,
    "uint8": jnp.uint8,
    "uint16": jnp.uint16,
    "uint32": jnp.uint32,   # ≈ gr::Size_t streams (Selector select port)
    "bool": jnp.bool_,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in DTYPES.items()}


def canonical_dtype(dtype: Any) -> jnp.dtype:
    if isinstance(dtype, str):
        try:
            return np.dtype(DTYPES[dtype])
        except KeyError as e:
            raise ValueError(f"unknown stream dtype {dtype!r}; known: {sorted(DTYPES)}") from e
    return np.dtype(dtype)


def dtype_name(dtype: Any) -> str:
    return _DTYPE_NAMES.get(np.dtype(dtype), str(np.dtype(dtype)))


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Static description of a stream riding an edge/port.

    ``sample_rate`` is metadata (Hz at this point of the graph; rate-changing blocks
    scale it). ``channels`` is the leading batch axis; ``channels == 0`` denotes a
    1-D stream shaped ``[block_len]``.
    """

    dtype: Any = jnp.float32
    channels: int = 0
    sample_rate: float = 1.0
    # SI metadata (≈ PortMetaInfo, reference Port.hpp:178)
    signal_name: str = ""
    signal_unit: str = ""
    signal_quantity: str = ""
    signal_min: float = float("-inf")
    signal_max: float = float("inf")

    def __post_init__(self):
        object.__setattr__(self, "dtype", canonical_dtype(self.dtype))

    def shape(self, block_len: int) -> tuple[int, ...]:
        if self.channels == 0:
            return (block_len,)
        return (self.channels, block_len)

    def zeros(self, block_len: int) -> jnp.ndarray:
        return jnp.zeros(self.shape(block_len), dtype=self.dtype)

    def with_rate(self, ratio: Fraction) -> "StreamSpec":
        return dataclasses.replace(self, sample_rate=float(self.sample_rate * ratio))

    def compatible(self, other: "StreamSpec") -> bool:
        return np.dtype(self.dtype) == np.dtype(other.dtype) and self.channels == other.channels


def block_shape(channels: int, block_len: int) -> tuple[int, ...]:
    return (block_len,) if channels == 0 else (channels, block_len)
