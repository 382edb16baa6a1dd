"""Demodulation kernels (≈ reference blocks/filter FrequencyEstimator.hpp
IQDemodulator and the capabilities of a classic SDR receive chain).

All elementwise vector math — XLA fuses the whole demod into the neighboring FIR/
resampler kernels.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def quadrature_demod(x: jnp.ndarray, last: jnp.ndarray, *, gain: float | jnp.ndarray,
                     rot: complex | None = None
                     ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FM discriminator: y[n] = gain · arg(x[n]·conj(x[n−1])·rot).

    x: [..., T] complex64; last: [...] carried x[−1]. gain = fs/(2π·Δf_max) for
    unit deviation. ``rot`` (host complex, unit modulus) folds a constant phase
    into the arg — the rotation-absorption correction, applied INSIDE arg so
    the (−π, π] wrap matches the de-rotated stream exactly.
    """
    import jax
    prev = jnp.concatenate([last[..., None], x[..., :-1]], axis=-1)
    d = x * jnp.conj(prev)
    if rot is not None:
        d = d * jax.lax.complex(jnp.float32(rot.real), jnp.float32(rot.imag))
    y = jnp.arctan2(jnp.imag(d), jnp.real(d)) * gain
    return y.astype(jnp.float32), x[..., -1]


def am_demod(x: jnp.ndarray, *, gain: float | jnp.ndarray = 1.0) -> jnp.ndarray:
    """Envelope detector |x|·gain."""
    return (jnp.abs(x) * gain).astype(jnp.float32)


def fm_deemphasis_coeffs(sample_rate: float, tau: float = 75e-6
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Single-pole de-emphasis (75 µs US / 50 µs EU) via bilinear transform."""
    w_c = 1.0 / tau
    w_ca = 2.0 * sample_rate * np.tan(w_c / (2.0 * sample_rate))
    k = -w_ca / (2.0 * sample_rate)
    z1 = -1.0
    p1 = (1.0 + k) / (1.0 - k)
    b0 = -k / (1.0 - k)
    b = np.array([b0, -z1 * b0])
    a = np.array([1.0, -p1])
    return b, a


def polar_discriminator_pll(x: jnp.ndarray, phase: jnp.ndarray, freq: jnp.ndarray,
                            *, loop_bw: float, fs: float
                            ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Carrier-tracking PLL (scan): returns (phase error stream, phase, freq).

    2nd-order loop, damping 1/√2; used for coherent AM/PSK paths.
    """
    import jax
    damp = np.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * damp * loop_bw + loop_bw * loop_bw
    alpha = (4.0 * damp * loop_bw) / denom
    beta = (4.0 * loop_bw * loop_bw) / denom

    def step(carry, xn):
        ph, fr = carry
        err = jnp.angle(xn * jnp.exp(-1j * ph))
        fr = fr + beta * err
        ph = ph + fr + alpha * err
        ph = jnp.mod(ph + np.pi, 2.0 * np.pi) - np.pi
        return (ph, fr), err

    (phase, freq), errs = jax.lax.scan(step, (phase, freq), jnp.moveaxis(x, -1, 0))
    return jnp.moveaxis(errs, 0, -1).astype(jnp.float32), phase, freq
