"""Time-axis (sequence) sharding with halo exchange.

The device-native replacement for the reference's carried FIR history at shard
boundaries (HistoryBuffer, core HistoryBuffer.hpp:68): when the time axis of a
stream is sharded over a mesh axis, each shard needs the last ``K−1`` samples of
its *left* neighbor as convolution prehistory. One `ppermute` (NCCL over NVLink
on GPUs) moves exactly those halo samples — the same neighbor-passing pattern as ring
attention. Functions here run **inside shard_map** (they use collectives).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def halo_left(x_local: jnp.ndarray, n: int, axis_name: str,
              edge_state: jnp.ndarray | None = None) -> jnp.ndarray:
    """Fetch the last ``n`` samples (trailing axis) from the left ring neighbor.

    Shard 0 receives ``edge_state`` (the carried history from the previous
    scheduler step) or zeros. Returns [..., n].
    """
    size = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    tail = x_local[..., -n:]
    # send my tail to my right neighbor ⇒ I receive my left neighbor's tail
    perm = [(i, (i + 1) % size) for i in range(size)]
    from_left = jax.lax.ppermute(tail, axis_name, perm)
    if edge_state is None:
        edge_state = jnp.zeros_like(tail)
    is_first = (idx == 0)
    return jnp.where(is_first, edge_state.astype(tail.dtype), from_left)


def last_shard_tail(x_local: jnp.ndarray, n: int, axis_name: str
                    ) -> jnp.ndarray:
    """The global stream's trailing ``n`` samples, replicated to every shard.

    Only the LAST shard holds them; a masked psum broadcasts its contribution
    (everyone else contributes zeros). This is the canonical way a halo block's
    carried history leaves shard_map replicated."""
    if n <= 0:
        return x_local[..., :0]
    size = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    tail = jnp.where(idx == size - 1, x_local[..., -n:],
                     jnp.zeros((), x_local.dtype))
    return jax.lax.psum(tail, axis_name)


def nco_shard_apply(block, state, ins, local_ctx, axis_name,
                    dphi: jnp.ndarray, n_local: int):
    """apply() an integer-NCO block on its local time shard.

    The NCO phase is a pure function of global sample position, so each shard
    offsets its start phase by ``idx·n_local·dphi`` (uint32 wrap-around is
    exact — bit-identical to the unsharded stream). Returns the advanced
    *global* phase and the local outputs. Shared by SignalGenerator/Rotator
    and friends; call inside shard_map."""
    idx = jax.lax.axis_index(axis_name)
    size = jax.lax.axis_size(axis_name)
    shard_state = state + dphi * (idx * n_local).astype(jnp.uint32)
    _, outs = block.apply(shard_state, ins, local_ctx)
    return state + dphi * jnp.uint32(size * n_local), outs


def fir_timeshard(x_local: jnp.ndarray, taps: jnp.ndarray, axis_name: str,
                  edge_state: jnp.ndarray | None = None, *, decim: int = 1
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Overlap-save FIR on a time-sharded stream (call inside shard_map).

    x_local: this shard's [..., T_local]; returns (y_local [..., T_local//decim],
    new_edge_state) where new_edge_state is the *global* stream tail (valid on the
    last shard; scheduler carries it into the next step's shard 0).
    """
    from ..ops.fir import fir_apply
    k = taps.shape[-1]
    hist = halo_left(x_local, k - 1, axis_name, edge_state) if k > 1 \
        else x_local[..., :0]
    y, _ = fir_apply(x_local, taps, hist, decim=decim)
    return y, last_shard_tail(x_local, k - 1, axis_name)


def quadrature_demod_timeshard(x_local: jnp.ndarray, axis_name: str,
                               edge_last: jnp.ndarray, *, gain
                               ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FM discriminator on a time-sharded complex stream (1-sample halo)."""
    from ..ops.demod import quadrature_demod
    prev = halo_left(x_local, 1, axis_name, edge_last[..., None])[..., 0]
    y, _ = quadrature_demod(x_local, prev, gain=gain)
    return y, last_shard_tail(x_local, 1, axis_name)[..., 0]
