"""Farrow (cubic polynomial) fractional-delay resampler — arbitrary-rate
resampling beyond the reference's rational L/M capability.

For output index m, the source position is p = m·ratio + φ0; sample index
i = ⌊p⌋, fractional μ = p − i. Output = cubic interpolation over x[i−1..i+2]
(Lagrange basis). All positions are computed vectorized; the 4 basis gathers are
contiguous shifted slices, so the kernel is gather-free and fuses elementwise.

Static shapes: outputs-per-step is fixed by the rate algebra
(out = round(in / ratio) with the fractional phase carried in state).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def farrow_init_state(channels: int, dtype) -> dict:
    hist_shape = (3,) if channels == 0 else (channels, 3)
    return {"hist": jnp.zeros(hist_shape, dtype),
            "mu0": jnp.zeros((), jnp.float64 if False else jnp.float32)}


def farrow_apply(x: jnp.ndarray, state: dict, *, ratio: float, n_out: int
                 ) -> tuple[jnp.ndarray, dict]:
    """Resample ``x`` ([T] or [C, T]) by source-step ``ratio`` (in-samples per
    out-sample), producing exactly ``n_out`` samples.

    Caller guarantees n_out·ratio ≤ T (the rate algebra picks n_out =
    floor(T/ratio) with the residual phase carried in ``mu0``). The interpolator
    is causal with a fixed latency of 2 input samples (group delay), like any
    streaming fractional-delay filter.
    """
    squeeze = x.ndim == 1
    x2 = x[None, :] if squeeze else x
    hist = state["hist"]
    h2 = hist[None, :] if squeeze else hist
    xc = jnp.concatenate([h2.astype(x2.dtype), x2], axis=-1)  # 3 prehistory
    t_in = x2.shape[-1]

    m = jnp.arange(n_out, dtype=jnp.float32)
    p = state["mu0"].astype(jnp.float32) + m * jnp.float32(ratio)
    i = jnp.floor(p).astype(jnp.int32)          # 0-based into x2
    mu = (p - i.astype(jnp.float32)).astype(jnp.float32)
    # causal window: interpolate at source position (p − 2) using
    # x[i−3..i] ⇔ xc[i..i+3] (xc[j] = x[j−3]); a fixed 2-input-sample latency
    # keeps every tap inside the block (no future lookahead, no OOB)
    base = i
    # gather 4 taps (small dynamic gather — unavoidable for arbitrary rate, but
    # only 4·n_out elements; positions are monotone so locality is good)
    def tap(k):
        return jnp.take_along_axis(
            xc, jnp.broadcast_to(base[None, :] + k, (xc.shape[0], n_out)),
            axis=-1, mode="clip")
    xm1, x0, x1, x2_ = tap(0), tap(1), tap(2), tap(3)
    mu = mu[None, :]
    # cubic Lagrange basis
    c_m1 = -mu * (mu - 1.0) * (mu - 2.0) / 6.0
    c_0 = (mu + 1.0) * (mu - 1.0) * (mu - 2.0) / 2.0
    c_1 = -(mu + 1.0) * mu * (mu - 2.0) / 2.0
    c_2 = (mu + 1.0) * mu * (mu - 1.0) / 6.0
    if jnp.issubdtype(x2.dtype, jnp.complexfloating):
        c_m1, c_0, c_1, c_2 = (c.astype(jnp.complex64)
                               for c in (c_m1, c_0, c_1, c_2))
    y = c_m1 * xm1 + c_0 * x0 + c_1 * x1 + c_2 * x2_
    # carry: next step's phase offset and last 3 samples
    p_end = state["mu0"] + jnp.float32(n_out) * jnp.float32(ratio)
    new_mu0 = p_end - jnp.float32(t_in)   # relative to the next block's start
    new_hist = xc[..., -3:]
    if squeeze:
        y = y[0]
        new_hist = new_hist[0]
    return y.astype(x.dtype), {"hist": new_hist, "mu0": new_mu0}


def goertzel_power(x: jnp.ndarray, *, freq: float, sample_rate: float
                   ) -> jnp.ndarray:
    """Single-bin DFT power via the Goertzel recurrence (scan over time).

    x: [..., T] → scalar power per leading index. Equivalent to
    |Σ x[n]·e^{-j2πfn/fs}|² / T²·4 (normalized like an FFT bin).
    """
    t = x.shape[-1]
    w = 2.0 * np.pi * freq / sample_rate
    coeff = jnp.float32(2.0 * np.cos(w))

    def step(carry, xn):
        s1, s2 = carry
        s0 = xn + coeff * s1 - s2
        return (s0, s1), None

    xT = jnp.moveaxis(x.astype(jnp.float32), -1, 0)
    (s1, s2), _ = jax.lax.scan(step, (jnp.zeros_like(xT[0]),
                                      jnp.zeros_like(xT[0])), xT)
    power = s1 * s1 + s2 * s2 - coeff * s1 * s2
    return power / jnp.float32(t * t / 4.0)


def agc_apply(x: jnp.ndarray, gain0: jnp.ndarray, *, reference: float,
              rate: float, max_gain: float = 65536.0
              ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Automatic gain control (≈ GNU Radio agc_cc): per-sample gain loop
    g[n+1] = g[n] + rate·(ref − |x[n]|·g[n]), evaluated by scan; channels in
    parallel. Returns (y, final gain)."""
    mag = jnp.abs(x).astype(jnp.float32)
    magT = jnp.moveaxis(mag, -1, 0)

    def step(g, mn):
        y_mag = mn * g
        g_next = jnp.clip(g + jnp.float32(rate) * (jnp.float32(reference) - y_mag),
                          1e-6, max_gain)
        return g_next, g

    g_final, gains = jax.lax.scan(step, gain0.astype(jnp.float32), magT)
    gains = jnp.moveaxis(gains, 0, -1)
    y = x * gains.astype(jnp.real(x).dtype)
    return y.astype(x.dtype), g_final
