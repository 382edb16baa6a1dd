"""Digital modem kernels: constellations (PSK/QAM) and OFDM framing.

FFT/gather-light designs: symbol mapping is a table lookup (one-hot matmul on
the matrix units for large blocks, direct take for small); OFDM is batched (I)FFT —
the accelerator's strongest op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def make_constellation(kind: str) -> np.ndarray:
    """Unit-average-power constellation points, Gray-coded where standard."""
    k = kind.upper()
    if k == "BPSK":
        return np.array([1.0 + 0j, -1.0 + 0j], np.complex64)
    if k == "QPSK":
        pts = np.array([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j], np.complex64)
        return (pts / np.sqrt(2.0)).astype(np.complex64)
    if k == "8PSK":
        gray = [0, 1, 3, 2, 6, 7, 5, 4]
        pts = np.zeros(8, np.complex64)
        for i, g in enumerate(gray):
            pts[g] = np.exp(1j * (2 * np.pi * i / 8 + np.pi / 8))
        return pts
    if k in ("QAM16", "16QAM"):
        gray2 = {0: -3, 1: -1, 3: 1, 2: 3}
        pts = np.zeros(16, np.complex64)
        for b in range(16):
            pts[b] = gray2[(b >> 2) & 3] + 1j * gray2[b & 3]
        return (pts / np.sqrt(10.0)).astype(np.complex64)
    if k in ("QAM64", "64QAM"):
        gray3 = {0: -7, 1: -5, 3: -3, 2: -1, 6: 1, 7: 3, 5: 5, 4: 7}
        pts = np.zeros(64, np.complex64)
        for b in range(64):
            pts[b] = gray3[(b >> 3) & 7] + 1j * gray3[b & 7]
        return (pts / np.sqrt(42.0)).astype(np.complex64)
    raise ValueError(f"unknown constellation {kind!r}")


def symbols_to_iq(symbols: jnp.ndarray, constellation: np.ndarray) -> jnp.ndarray:
    """Map integer symbols [..., N] → complex64 points (table gather)."""
    table = jnp.asarray(constellation)
    return jnp.take(table, symbols.astype(jnp.int32), axis=0, mode="clip")


def iq_to_symbols(iq: jnp.ndarray, constellation: np.ndarray) -> jnp.ndarray:
    """Hard-decision demapping: nearest constellation point (vectorized)."""
    table = jnp.asarray(constellation)  # [M]
    d = jnp.abs(iq[..., None] - table[None, :]) ** 2 if iq.ndim == 1 else \
        jnp.abs(iq[..., :, None] - table[(None,) * iq.ndim]) ** 2
    return jnp.argmin(d, axis=-1).astype(jnp.int32)


def ofdm_modulate(symbols: jnp.ndarray, *, fft_size: int, cp_len: int,
                  occupied: np.ndarray) -> jnp.ndarray:
    """OFDM: map symbols onto ``occupied`` subcarriers, IFFT, prepend CP.

    symbols: [..., n_sym, len(occupied)] complex → [..., n_sym·(fft_size+cp)].
    """
    occ = jnp.asarray(np.asarray(occupied, np.int32))
    lead = symbols.shape[:-2]
    n_sym = symbols.shape[-2]
    grid = jnp.zeros((*lead, n_sym, fft_size), jnp.complex64)
    grid = grid.at[..., occ].set(symbols.astype(jnp.complex64))
    time = jnp.fft.ifft(grid, axis=-1) * jnp.sqrt(jnp.float32(fft_size))
    with_cp = jnp.concatenate([time[..., -cp_len:], time], axis=-1)
    return with_cp.reshape(*lead, n_sym * (fft_size + cp_len)).astype(jnp.complex64)


def ofdm_demodulate(x: jnp.ndarray, *, fft_size: int, cp_len: int,
                    occupied: np.ndarray) -> jnp.ndarray:
    """Inverse of :func:`ofdm_modulate` (assumes symbol alignment)."""
    occ = np.asarray(occupied, np.int32)
    sym_len = fft_size + cp_len
    lead = x.shape[:-1]
    n_sym = x.shape[-1] // sym_len
    frames = x[..., : n_sym * sym_len].reshape(*lead, n_sym, sym_len)
    no_cp = frames[..., cp_len:]
    grid = jnp.fft.fft(no_cp, axis=-1) / jnp.sqrt(jnp.float32(fft_size))
    return grid[..., occ].astype(jnp.complex64)


def rrc_taps(sps: int, ntaps: int, *, beta: float = 0.35) -> np.ndarray:
    """Root-raised-cosine pulse-shaping taps (unit energy), ``sps`` samples per
    symbol, roll-off ``beta``."""
    if ntaps % 2 == 0:
        ntaps += 1
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0) / float(sps)
    h = np.zeros(ntaps, np.float64)
    for k, tt in enumerate(t):
        if abs(tt) < 1e-12:
            h[k] = 1.0 - beta + 4.0 * beta / np.pi
        elif beta > 0 and abs(abs(4.0 * beta * tt) - 1.0) < 1e-9:
            h[k] = (beta / np.sqrt(2.0)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            num = (np.sin(np.pi * tt * (1 - beta))
                   + 4 * beta * tt * np.cos(np.pi * tt * (1 + beta)))
            den = np.pi * tt * (1 - (4 * beta * tt) ** 2)
            h[k] = num / den
        # normalization applied below
    return (h / np.sqrt(np.sum(h * h))).astype(np.float64)


def timing_phase_energy(x: jnp.ndarray, sps: int) -> jnp.ndarray:
    """Mean symbol-rate energy per sampling phase: [..., sps]."""
    t = x.shape[-1] - (x.shape[-1] % sps)
    frames = x[..., :t].reshape(*x.shape[:-1], -1, sps)
    return jnp.mean(jnp.abs(frames) ** 2, axis=-2)


def mm_timing_recovery(x: jnp.ndarray, *, sps: int, mu0: jnp.ndarray,
                       last_sym: jnp.ndarray, gain: float = 0.01
                       ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Mueller & Müller decision-directed timing recovery (feedback loop).

    x: [T] complex at ``sps`` samples/symbol (T % sps == 0). Per output symbol
    k the loop samples x at position k·sps + μ (linear interpolation), updates
    μ with the M&M error e = Re{ŷ_{k-1}·y_k − ŷ_k·y_{k-1}} (decisions ŷ via
    sign quantization), and clamps μ to ±sps/2 within the block.

    Sequential by nature → ``lax.scan`` over symbols (T/sps steps). Returns
    (symbols [T//sps], μ_final, last_symbol).
    """
    t = x.shape[-1]
    n_sym = t // sps

    def interp(pos):
        i = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, t - 2)
        frac = (pos - i.astype(jnp.float32)).astype(jnp.float32)
        x0 = jax.lax.dynamic_slice(x, (i,), (2,))
        return (x0[0] * (1.0 - frac) + x0[1] * frac).astype(jnp.complex64)

    def decide(v):
        return jax.lax.complex(jnp.sign(jnp.real(v)),
                               jnp.sign(jnp.imag(v))).astype(jnp.complex64)

    def step(carry, k):
        mu, y_prev, d_prev = carry
        pos = k.astype(jnp.float32) * sps + mu
        y = interp(pos)
        d = decide(y)
        e = jnp.real(d_prev * y - d * y_prev)
        mu = jnp.clip(mu + jnp.float32(gain) * e,
                      -sps / 2.0 + 1.0, sps / 2.0 - 1.0 + sps)
        return (mu, y, d), y

    ks = jnp.arange(n_sym)
    (mu_f, y_f, _), syms = jax.lax.scan(
        step, (mu0.astype(jnp.float32), last_sym.astype(jnp.complex64),
               decide(last_sym)), ks)
    return syms, mu_f, y_f


def default_occupied(fft_size: int, n_occupied: int) -> np.ndarray:
    """Symmetric occupied-carrier map avoiding DC and band edges."""
    half = n_occupied // 2
    pos = np.arange(1, half + 1)
    neg = fft_size - np.arange(1, n_occupied - half + 1)
    return np.sort(np.concatenate([pos, neg]))
