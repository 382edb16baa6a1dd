"""Waveform generation kernels (≈ reference algorithm/signal/SignalGeneratorCore.hpp).

Waveforms: Const, Sin, Cos, Square, Saw, Triangle (same set as the reference's
SignalGenerator). Phase tracking uses the classic **integer NCO**: a uint32 phase
accumulator with increment ``round(f/fs · 2³²)`` computed on the host in float64
(Block.prepare_params), so phase never drifts regardless of stream length — uint32
wrap-around is the modulo. On device: one broadcasted iota, one multiply-add, one
transcendental — fully fused by XLA into downstream kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

WAVEFORMS = ("Const", "Sin", "Cos", "Square", "Saw", "Triangle",
             # FastSin/FastCos are the reference's reduced-precision recursive
             # phasors (SignalGenerator.hpp:34) — the integer NCO is already
             # drift-free AND exact here, so they alias Sin/Cos
             "FastSin", "FastCos")
NOISE_WAVEFORMS = ("UniformNoise", "TriangularNoise", "GaussianNoise")

_TWO_PI = 2.0 * np.pi
_PHASE_SCALE = np.float32(1.0 / 4294967296.0)  # 2^-32


def phase_increment(frequency: float, sample_rate: float) -> np.uint32:
    """Host-side (float64) NCO increment: frac(f/fs) · 2³² as uint32."""
    frac = np.float64(frequency) / np.float64(sample_rate)
    frac = frac - np.floor(frac)
    return np.uint32(np.round(frac * 4294967296.0) % 4294967296.0)


def nco_phases(phase0: jnp.ndarray, dphi: jnp.ndarray, n: int) -> jnp.ndarray:
    """uint32 phase ramp [n] starting at phase0 (wrapping mod 2³² naturally)."""
    idx = jax.lax.broadcasted_iota(jnp.uint32, (n, 1), 0)[:, 0]
    return phase0.astype(jnp.uint32) + idx * dphi.astype(jnp.uint32)


def phase_to_frac(phase_u32: jnp.ndarray) -> jnp.ndarray:
    """uint32 phase → fractional cycles in [0, 1) as f32 (keeps top 24 bits)."""
    return phase_u32.astype(jnp.float32) * _PHASE_SCALE


def waveform(kind: str, frac_phase: jnp.ndarray, *, amplitude, offset) -> jnp.ndarray:
    """Evaluate a waveform from fractional phase in [0,1)."""
    k = kind.lower()
    if k == "const":
        return jnp.full_like(frac_phase, 1.0) * amplitude + offset
    if k in ("sin", "fastsin"):
        return amplitude * jnp.sin(_TWO_PI * frac_phase) + offset
    if k in ("cos", "fastcos"):
        return amplitude * jnp.cos(_TWO_PI * frac_phase) + offset
    if k == "square":
        return amplitude * jnp.where(frac_phase < 0.5, 1.0, -1.0) + offset
    if k == "saw":
        return amplitude * (2.0 * frac_phase - 1.0) + offset
    if k == "triangle":
        return amplitude * (4.0 * jnp.abs(frac_phase - 0.5) - 1.0) + offset
    raise ValueError(f"unknown waveform {kind!r}; known: {WAVEFORMS}")


def complex_exp(frac_phase: jnp.ndarray, *, amplitude=1.0) -> jnp.ndarray:
    """amplitude · e^{j2πφ} — the complex NCO used by rotators/mixers."""
    ang = _TWO_PI * frac_phase
    return (amplitude * (jnp.cos(ang) + 1j * jnp.sin(ang))).astype(jnp.complex64)


def complex_exp_ramp(phase0, dphi, n: int, *, amplitude=1.0) -> jnp.ndarray:
    """amplitude · e^{j2π·(phase0 + k·dphi)/2³²} for k in [0, n) — the tone/
    NCO ramp, factored so transcendentals cost O(√n) instead of O(n).

    Phase splits exactly in uint32: phase(k·B+i) = (phase0 + kB·dphi) +
    (i·dphi) mod 2³², and e^{j(a+b)} = e^{ja}·e^{jb}, so the [K,B] ramp is a
    complex OUTER PRODUCT of a K-vector (coarse rotators, amplitude folded
    in) and a B-vector (fine ramp): one broadcast multiply per sample —
    bound by the output write on an accelerator — instead of a sin+cos
    polynomial pair per sample (the factored form moves only the 64 MiB
    output of an 8 Mi-sample block). Phase accuracy is
    unchanged: the integer phases are exact, and the single f32 unit-vector
    product adds ≤1.5e-7 error — below the f32 sin/cos rounding floor.
    ≈ reference ToneGenerator/Rotator (algorithm/signal, math/Rotator.hpp),
    which use a recursive phasor with periodic renormalisation; this is
    the parallel (scan-free) device inversion.

    The tile size B is a FIXED constant (not a function of n) so the
    (coarse, fine) decomposition of any sample depends only on its offset
    from the segment start modulo B. Consequently sharded and unsharded
    lowerings — and different block_len chunkings of the same stream — are
    BIT-EXACT whenever every segment length is a multiple of B (phase
    carries are uint32-exact, so aligned tiles see identical sin/cos
    inputs). Non-multiples fall back to the direct per-sample form."""
    phase0 = jnp.asarray(phase0, jnp.uint32)
    dphi = jnp.asarray(dphi, jnp.uint32)
    B = 1024
    if n % B:
        return complex_exp(phase_to_frac(nco_phases(phase0, dphi, n)),
                           amplitude=amplitude)
    K = n // B
    coarse = nco_phases(phase0, dphi * jnp.uint32(B), K)      # exact uint32
    fine = nco_phases(jnp.uint32(0), dphi, B)
    rot = complex_exp(phase_to_frac(coarse), amplitude=amplitude)
    base = complex_exp(phase_to_frac(fine))
    return (rot[:, None] * base[None, :]).reshape(n)


def nco_rotate(x: jnp.ndarray, phase0, dphi, n: int | None = None
               ) -> jnp.ndarray:
    """``x · complex_exp_ramp(phase0, dphi, n)`` with the ramp kept FACTORED
    through the multiply.

    Materializing the outer-product ramp and then multiplying costs three
    full-stream HBM passes (ramp write, ramp read, product write), 1.5× the
    2-pass bound. Here ``x`` reshapes to [K, B]
    (free, row-major) and the coarse/fine unit vectors broadcast into two
    chained elementwise multiplies that XLA fuses into ONE read of x and one
    write of y. Same uint32 phase grid as complex_exp_ramp → identical
    rounding class (≤2 ulps vs the direct form)."""
    m = x.shape[-1] if n is None else n
    phase0 = jnp.asarray(phase0, jnp.uint32)
    dphi = jnp.asarray(dphi, jnp.uint32)
    B = 1024
    if m % B:
        return (x * complex_exp(phase_to_frac(nco_phases(phase0, dphi, m)))
                ).astype(x.dtype)
    k = m // B
    coarse = complex_exp(phase_to_frac(
        nco_phases(phase0, dphi * jnp.uint32(B), k)))         # [K]
    fine = complex_exp(phase_to_frac(
        nco_phases(jnp.uint32(0), dphi, B)))                  # [B]
    lead = x.shape[:-1]
    xr = x.reshape(*lead, k, B)
    y = (xr * coarse[..., :, None]) * fine
    return y.reshape(*lead, m).astype(x.dtype)
